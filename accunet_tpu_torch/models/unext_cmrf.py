"""The UNeXt-CMRF family (torch.nn, NHWC), counterpart of
accunet_tpu/models/unext_cmrf.py (`UNextCMRF`, `_adaptive_avg_pool`,
`VARIANTS`, `build_unext_cmrf`): one model over the axes of the 23
UNext_CMRF registry names. The port's `UNext` (models/unext.py) is this
model with the plain-conv stem.

    stem: 3 x (encoder block -> [BN: conv stem with max pool only] ->
        2x2 max pool | Haar wavelet pool -> ReLU), 16/32/128 channels
    tokens: OverlapPatchEmbed (k3 s2) to 160, a token block, LayerNorm
        (t4); OverlapPatchEmbed to 256, then a token block and LayerNorm
        (norm4), or with the GS skip LayerNorm alone (norm4_main)
    decoder: 3x3 conv (| CMRF at decoder3-5, which then drop dbn3 / dbn4)
        -> BN -> 2x bilinear upsample -> ReLU -> + skip (resized with
        align_corners=True when ragged), token blocks at 160 / 128
    head: 1x1 conv to n_classes, sigmoid when n_classes == 1

Axes (the JAX names):
  * encoder: 'conv' | 'cmrf' | 'cmrf_od' | 'cmrf_bs' | 'cmrf_bsrb';
  * decoder: 'conv' | 'cmrf' (CMRF at decoder3-5);
  * skip: 'add'; 'mlfc' (MLFC over t1..t4); 'dense' (the UNet++-style
    H{i}__{j} heads refine t1..t3); 'csse' (ChannelSpatialSE on t1..t4);
    'gs' (the global-semantic branch: t1..t4 average-pooled to the
    bottleneck's map, concatenated, g_in_proj -> g_in_bn -> block2_0 ->
    norm4_gs -> g_split_proj, cut by channel offsets into g4 / g3 / g2 / g1,
    each resized with align_corners=False and injected into its skip by
    InjectionMultiSumCBR `sim{level}`); 'gab' (each skip through
    GroupAggregationBridge `GAB{level}` with the previous level's fused map
    and a one-channel mask `gt_conv{level}` of the decoder map, every
    upsample with align_corners=True);
  * pool: 'max' | 'wavelet' (haar_wavelet_pool2d: its rescale is a mean
    over the whole batch tensor, as in JAX, so one image's output depends
    on the rest of its batch);
  * token_block: 'shift' (ShiftedBlock) | 'rkan' (U-KAN's KANBlock over
    JacobiRKAN-based KANLinears).

Every token block's depthwise convs take their weight gradient from the
`dwconv2d_wgrad` kernel: a train step launches it once per ShiftedBlock (4)
or three times per rKAN KANBlock (12, UNext_CMRF_GS_Wavelet_rKAN); an eval
forward runs no hand-written kernel. The other convs (the CMRF, OD and BS
chains, GAB's dilated depthwise convs) are the library's, as they are XLA's
in JAX. `_hd` and `_PP` have the forward of their base name (`_hd` pairs it
with the Hausdorff loss on the train side; `_PP`'s shipped forward is
UNext_CMRF's), as in JAX. `dtype` is the compute type, as ACCUNet's.
"""

from __future__ import annotations

import functools
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from accunet_tpu_torch.models.u_kan import KANBlock
from accunet_tpu_torch.nn.acc_blocks import MLFC, BatchNorm
from accunet_tpu_torch.nn.cmrf_blocks import (
    CMRF,
    CMRF_BS,
    CMRF_OD,
    ChannelSpatialSE,
    GroupAggregationBridge,
    InjectionMultiSumCBR,
    haar_wavelet_pool2d,
)
from accunet_tpu_torch.nn.unext_blocks import LayerNorm, OverlapPatchEmbed, ShiftedBlock
from accunet_tpu_torch.ops.conv import conv1x1, conv2d
from accunet_tpu_torch.ops.pooling import max_pool2d
from accunet_tpu_torch.ops.resize import resize_bilinear, upsample_bilinear_2x


def _conv3(c1: int, c2: int, bias: bool = True) -> nn.Conv2d:
    return nn.Conv2d(c1, c2, 3, padding=1, bias=bias)


ENCODERS = {"conv": _conv3, "cmrf": CMRF, "cmrf_od": CMRF_OD, "cmrf_bs": CMRF_BS,
            "cmrf_bsrb": functools.partial(CMRF_BS, block="bsrb")}
DECODERS = {"conv": _conv3, "cmrf": CMRF}
SKIPS = ("add", "mlfc", "dense", "csse", "gs", "gab")
POOLS = ("max", "wavelet")
TOKEN_BLOCKS = {"shift": ShiftedBlock, "rkan": functools.partial(KANBlock, base_activation="rkan")}


def _apply(block: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """A 3x3 conv (stride 1, SAME) or a CMRF-style block on NHWC."""
    if isinstance(block, nn.Conv2d):
        return conv2d(x, block.weight, block.bias)
    return block(x)


def _match(t: torch.Tensor, ref: torch.Tensor, align_corners: bool) -> torch.Tensor:
    if t.shape[1:3] != ref.shape[1:3]:
        t = resize_bilinear(t, tuple(ref.shape[1:3]), align_corners)
    return t


def _adaptive_avg_pool(x: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """The mean of each (H / oh) x (W / ow) window where the map divides,
    else a bilinear resize (align_corners=False), as JAX's."""
    b, h, w, c = x.shape
    oh, ow = out_hw
    if h % oh == 0 and w % ow == 0:
        return x.reshape(b, oh, h // oh, ow, w // ow, c).mean(dim=(2, 4))
    return resize_bilinear(x, out_hw)


class UNextCMRF(nn.Module):
    def __init__(self, n_channels: int = 3, n_classes: int = 1,
                 stem_dims: Sequence[int] = (16, 32, 128),
                 embed_dims: Sequence[int] = (128, 160, 256), final_sigmoid: bool = True,
                 encoder: str = "cmrf", decoder: str = "conv", skip: str = "add",
                 pool: str = "max", token_block: str = "shift",
                 dtype: torch.dtype | None = None):
        super().__init__()
        for axis, value, known in (("encoder", encoder, ENCODERS), ("decoder", decoder, DECODERS),
                                   ("skip", skip, SKIPS), ("pool", pool, POOLS),
                                   ("token_block", token_block, TOKEN_BLOCKS)):
            if value not in known:
                raise ValueError(f"UNextCMRF {axis}={value!r}; known: {sorted(known)}")
        s1, s2, s3 = stem_dims
        e0, e1, e2 = embed_dims
        self.n_classes, self.final_sigmoid = n_classes, final_sigmoid
        self.skip, self.pool, self.dtype = skip, pool, dtype
        enc, tok = ENCODERS[encoder], TOKEN_BLOCKS[token_block]
        self.encoder1 = enc(n_channels, s1)
        self.encoder2 = enc(s1, s2)
        self.encoder3 = enc(s2, s3)
        if encoder == "conv" and pool == "max":  # the other stems pool without a BN
            self.ebn1, self.ebn2, self.ebn3 = BatchNorm(s1), BatchNorm(s2), BatchNorm(s3)
        self.patch_embed3 = OverlapPatchEmbed(s3, e1)
        self.block1 = nn.ModuleList([tok(e1)])
        self.norm3 = LayerNorm(e1, eps=1e-5)
        self.patch_embed4 = OverlapPatchEmbed(e1, e2)
        if skip == "gs":  # block2_0 runs on the global branch
            self.norm4_main = LayerNorm(e2, eps=1e-5)
            self.g_in_proj = nn.Conv2d(s1 + s2 + s3 + e1, e2, 1, bias=False)
            self.g_in_bn = BatchNorm(e2)
            self.block2 = nn.ModuleList([tok(e2)])
            self.norm4_gs = LayerNorm(e2, eps=1e-5)
            self.g_split_proj = nn.Conv2d(e2, e1 + e0 + s2 + s1, 1)
            self.g_sizes = (e1, e0, s2, s1)  # g4, g3, g2, g1
        else:
            self.block2 = nn.ModuleList([tok(e2)])
            self.norm4 = LayerNorm(e2, eps=1e-5)
        if skip == "dense":
            for name, cin, cout in (("H0_1", s1 + s2, s1), ("H1_1", s2 + s3, s2),
                                    ("H2_1", s3 + e1, s3), ("H0_2", 2 * s1 + s2, s1),
                                    ("H1_2", 2 * s2 + s3, s2), ("H0_3", 3 * s1 + s2, s1)):
                setattr(self, f"{name}_conv", _conv3(cin, cout, bias=False))
                setattr(self, f"{name}_bn", BatchNorm(cout))
        elif skip == "mlfc":
            self.mlfc = MLFC((s1, s2, s3, e1), 1, "full")
        elif skip == "csse":
            for level, c in zip((1, 2, 3, 4), (s1, s2, s3, e1)):
                setattr(self, f"csse{level}", ChannelSpatialSE(c))
        self.decoder1 = _conv3(e2, e1)
        self.dbn1 = BatchNorm(e1)
        self.dblock1 = nn.ModuleList([tok(e1)])
        self.dnorm3 = LayerNorm(e1, eps=1e-5)
        self.decoder2 = _conv3(e1, e0)
        self.dbn2 = BatchNorm(e0)
        self.dblock2 = nn.ModuleList([tok(e0)])
        self.dnorm4 = LayerNorm(e0, eps=1e-5)
        dec = DECODERS[decoder]
        self.decoder3 = dec(e0, s2)
        self.decoder4 = dec(s2, s1)
        self.decoder5 = dec(s1, s1)
        if decoder == "conv":  # the CMRF decoders drop dbn3 / dbn4
            self.dbn3, self.dbn4 = BatchNorm(s2), BatchNorm(s1)
        # by level: (the decoder map's and skip's width, the previous fused
        # map's (GAB's xh), g's (GS))
        widths = {4: (e1, e2, e1), 3: (e0, e1, e0), 2: (s2, e0, s2), 1: (s1, s2, s1)}
        for level, (c, c_xh, c_g) in widths.items():
            if skip == "gs":
                setattr(self, f"sim{level}", InjectionMultiSumCBR(c, c_g, c))
            elif skip == "gab":
                setattr(self, f"gt_conv{level}", nn.Conv2d(c, 1, 1))
                setattr(self, f"GAB{level}", GroupAggregationBridge(c_xh, c))
        self.final = nn.Conv2d(s1, n_classes, 1)

    def _stem(self, x: torch.Tensor, i: int) -> torch.Tensor:
        y = _apply(getattr(self, f"encoder{i}"), x)
        if self.pool == "wavelet":
            return F.relu(haar_wavelet_pool2d(y))
        if hasattr(self, f"ebn{i}"):
            y = getattr(self, f"ebn{i}")(y)
        return F.relu(max_pool2d(y, 2))

    def _up(self, y: torch.Tensor, i: int) -> torch.Tensor:
        y = _apply(getattr(self, f"decoder{i}"), y)
        if hasattr(self, f"dbn{i}"):
            y = getattr(self, f"dbn{i}")(y)
        return F.relu(upsample_bilinear_2x(y, self.skip == "gab"))

    def _head(self, name: str, *maps: torch.Tensor) -> torch.Tensor:
        """A dense-skip head (3x3 conv without bias, BN, ReLU; JAX
        `H{i}__{j}_conv` / `_bn`) over the concat of `maps`, the last resized
        to the first (align_corners=False)."""
        *same, coarse = maps
        x = torch.cat([*same, _match(coarse, same[0], False)], dim=-1)
        y = conv2d(x, getattr(self, f"{name}_conv").weight)
        return F.relu(getattr(self, f"{name}_bn")(y))

    def _global_branch(self, maps, hw) -> dict:
        """GS: g4..g1 from t1..t4 pooled to the bottleneck's map hw."""
        g = torch.cat([_adaptive_avg_pool(t, hw) for t in maps], dim=-1)
        g = self.g_in_bn(conv1x1(g, self.g_in_proj.weight))
        g = self.norm4_gs(self.block2[0](g))
        g = conv1x1(g, self.g_split_proj.weight, self.g_split_proj.bias)
        return dict(zip((4, 3, 2, 1), g.split(self.g_sizes, dim=-1)))

    def _fuse(self, y: torch.Tensor, t: torch.Tensor, level: int, xh: torch.Tensor,
              g: dict | None) -> torch.Tensor:
        """The skip merge at one decoder level: y + the skip t, injected
        with g (GS) or bridged with xh and y's mask (GAB)."""
        t = _match(t, y, True)
        if self.skip == "gs":
            gl = resize_bilinear(g[level], tuple(y.shape[1:3]))
            t = getattr(self, f"sim{level}")(t, gl)
        elif self.skip == "gab":
            gt = getattr(self, f"gt_conv{level}")
            t = getattr(self, f"GAB{level}")(xh, t, conv1x1(y, gt.weight, gt.bias))
        return y + t

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, H, W, n_channels) -> float32 (B, H', W', n_classes): H' is 32
        times the bottleneck's side, H itself when 32 divides H."""
        x = x.to(self.final.weight.dtype if self.dtype is None else self.dtype)
        t1 = self._stem(x, 1)
        t2 = self._stem(t1, 2)
        t3 = self._stem(t2, 3)
        t4 = self.norm3(self.block1[0](self.patch_embed3(t3)))
        out = self.patch_embed4(t4)
        g = None
        if self.skip == "gs":
            out = self.norm4_main(out)
            g = self._global_branch((t1, t2, t3, t4), tuple(out.shape[1:3]))
        else:
            out = self.norm4(self.block2[0](out))

        if self.skip == "dense":  # refined t1..t3; t4 stays
            x01 = self._head("H0_1", t1, t2)
            x11 = self._head("H1_1", t2, t3)
            x21 = self._head("H2_1", t3, t4)
            x02 = self._head("H0_2", t1, x01, x11)
            x12 = self._head("H1_2", t2, x11, x21)
            t1, t2, t3 = self._head("H0_3", t1, x01, x02, x12), x12, x21
        elif self.skip == "mlfc":
            t1, t2, t3, t4 = self.mlfc(t1, t2, t3, t4)
        elif self.skip == "csse":
            t1, t2, t3, t4 = (getattr(self, f"csse{i}")(t)
                              for i, t in zip((1, 2, 3, 4), (t1, t2, t3, t4)))

        xh = out
        out = xh = self._fuse(self._up(out, 1), t4, 4, xh, g)
        out = self.dnorm3(self.dblock1[0](out))
        out = xh = self._fuse(self._up(out, 2), t3, 3, xh, g)
        out = self.dnorm4(self.dblock2[0](out))
        out = xh = self._fuse(self._up(out, 3), t2, 2, xh, g)
        out = self._fuse(self._up(out, 4), t1, 1, xh, g)
        out = self._up(out, 5)
        logits = conv1x1(out, self.final.weight, self.final.bias)
        if self.n_classes == 1 and self.final_sigmoid:
            logits = torch.sigmoid(logits)
        return logits.float()


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
                     **overrides) -> UNextCMRF:
    kwargs = dict(VARIANTS[name])
    kwargs.update(overrides)
    return UNextCMRF(n_channels=n_channels, n_classes=n_classes, **kwargs)
