"""The UNeXt-CMRF family, counterpart of accunet_tpu/models/unext_cmrf.py
(`UNextCMRF`, `VARIANTS`, `build_unext_cmrf`).

The port's `UNext` (models/unext.py) carries the ported axes of JAX's
`UNextCMRF` (encoder conv / cmrf, decoder conv / cmrf, skip add / mlfc /
dense, max pool, shifted-MLP token blocks); `build_unext_cmrf` builds a
registry name from the variant table. The seven names whose axes are
ported build; the others, and every other axis (the OD, BS and BSRB
encoders, the CSSE, GS and GAB skips, the wavelet pool, rKAN token blocks),
raise NotImplementedError (ROADMAP Queue 1 item 7).
"""

from __future__ import annotations

from accunet_tpu_torch.models.unext import UNext

# registry name -> axes (the JAX package's VARIANTS)
VARIANTS = {
    "UNext_CMRF": dict(encoder="cmrf"),
    "UNext_CMRF_enc_dec": dict(encoder="cmrf", decoder="cmrf"),
    "UNext_CMRF_enc_MLFC": dict(encoder="cmrf", skip="mlfc"),
    "UNext_CMRF_enc_dec_MLFC": dict(encoder="cmrf", decoder="cmrf", skip="mlfc"),
    "UNext_CMRF_enc_CSSE": dict(encoder="cmrf", skip="csse"),
    "UNext_CMRF_GS": dict(encoder="cmrf", skip="gs"),
    "UNext_CMRF_GS_Wavelet": dict(encoder="cmrf", skip="gs", pool="wavelet"),
    "UNext_CMRF_Wavelet": dict(encoder="cmrf", pool="wavelet"),
    "UNext_CMRF_GAB": dict(encoder="cmrf", skip="gab"),
    "UNext_CMRF_OD": dict(encoder="cmrf_od"),
    "UNext_CMRF_BS": dict(encoder="cmrf_bs"),
    "UNext_CMRF_BSRB": dict(encoder="cmrf_bsrb"),
    "UNext_CMRF_dense_skip": dict(encoder="cmrf", skip="dense"),
    # _PP's shipped forward is plain UNext_CMRF; _hd pairs it with the
    # Hausdorff loss on the train side
    "UNext_CMRF_PP": dict(encoder="cmrf"),
    "UNext_CMRF_hd": dict(encoder="cmrf"),
    "UNext_CMRF_GS_Wavelet_hd": dict(encoder="cmrf", skip="gs", pool="wavelet"),
    "UNext_CMRF_GAB_wavelet": dict(encoder="cmrf", skip="gab", pool="wavelet"),
    "UNext_CMRF_GAB_wavelet_OD": dict(encoder="cmrf_od", skip="gab", pool="wavelet"),
    "UNext_CMRF_GS_Wavelet_OD": dict(encoder="cmrf_od", skip="gs", pool="wavelet"),
    "UNext_CMRF_BS_GS_Wavelet": dict(encoder="cmrf_bs", skip="gs", pool="wavelet"),
    "UNext_CMRF_BSRB_GS": dict(encoder="cmrf_bsrb", skip="gs"),
    "UNext_CMRF_BSRB_GS_Wavelet": dict(encoder="cmrf_bsrb", skip="gs", pool="wavelet"),
    "UNext_CMRF_GS_Wavelet_rKAN": dict(
        encoder="cmrf", skip="gs", pool="wavelet", token_block="rkan"),
}


def build_unext_cmrf(name: str, n_channels: int = 3, n_classes: int = 1,
                     **overrides) -> UNext:
    kwargs = dict(VARIANTS[name])
    kwargs.update(overrides)
    return UNext(n_channels=n_channels, n_classes=n_classes, **kwargs)
