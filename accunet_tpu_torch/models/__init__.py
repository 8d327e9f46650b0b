"""Model registry of the port, under the JAX package's registry names
(accunet_tpu/models/__init__.py): the ACC-UNet family, all 26 SegMamba
names (the baseline, the hybrid ladder and the text-conditioned and
Spatial-Mamba variants), UNeXt, all 23 UNext_CMRF names, MedMamba, the SpatialMamba
classifier, KNUnet (KMUNet), U-KAN, and the ACC-UNet paper's UNet baselines:
UNet_base, Unetpp, MultiResUnet (and the reference's
'MultiResUnet1_<nfilt>_<alpha>' names), UCTransNet and the four TransUNet
names, and the rest of its comparison zoo: SwinUnet, SMESwinUnet,
SegViT_fKAN and TinyUNet. `build_for` is the one rule by which the CLIs
build a name for their data."""

from __future__ import annotations

import functools
import math
import re
from typing import Callable, Dict

import torch
from torch import nn

from accunet_tpu_torch.models.acc_unet import (
    ACC_UNet,
    ACC_UNet_Lite,
    ACC_UNet_W,
    ACCUNet,
)
from accunet_tpu_torch.models.knunet import KMUNet
from accunet_tpu_torch.models.medmamba import VSSM, Backbone_SpatialMamba, SpatialMamba
from accunet_tpu_torch.models.multires_unet import MultiResUnet
from accunet_tpu_torch.models.segmamba import VARIANTS as _SEGMAMBA_VARIANTS
from accunet_tpu_torch.models.segmamba import SegMamba, build_segmamba
from accunet_tpu_torch.models.unext import UNext, UNext_S
from accunet_tpu_torch.models.unext_cmrf import VARIANTS as _CMRF_VARIANTS
from accunet_tpu_torch.models.unext_cmrf import UNextCMRF, build_unext_cmrf
from accunet_tpu_torch.models.seg_fvit import SegViTfKAN
from accunet_tpu_torch.models.sme_swin_unet import SMESwinUnet
from accunet_tpu_torch.models.swin_unet import SwinUnet, WindowAttention
from accunet_tpu_torch.models.tiny_unet import TinyUNet
from accunet_tpu_torch.models.transunet import GroupNorm, TransUNet
from accunet_tpu_torch.models.u_kan import UKAN
from accunet_tpu_torch.models.uctransnet import ChannelEmbeddings, UCTransNet
from accunet_tpu_torch.models.unet import UNetBase
from accunet_tpu_torch.models.unetpp import UNetPlusPlus
from accunet_tpu_torch.nn.acc_blocks import MLFC
from accunet_tpu_torch.nn.attention import TGDC, MDTAAttention, TorchMultiheadAttention
from accunet_tpu_torch.nn.cmrf_blocks import GHPA, AdaptiveWaveletPool2d, ODConv2d
from accunet_tpu_torch.nn.kan import (
    FractionalJacobiNeuralBlock,
    JacobiRKAN,
    KANLinear,
    PadeRKAN,
)
from accunet_tpu_torch.nn.ss2d import SS2D
from accunet_tpu_torch.nn.ssm import (
    BiMamba,
    MambaVisionMixer,
    SpatialStateFusion,
    StateFusion,
    StructureAwareSSM,
)

registry: Dict[str, Callable] = {
    "ACC_UNet": ACC_UNet,
    "ACC_UNet_Lite": ACC_UNet_Lite,
    "ACC_UNet_W": ACC_UNet_W,
    # SegMamba builders take in_chans/out_chans, as in JAX
    **{name: functools.partial(build_segmamba, name) for name in _SEGMAMBA_VARIANTS},
    "MedMamba": VSSM,
    "SpatialMamba": SpatialMamba,
    "Backbone_SpatialMamba": Backbone_SpatialMamba,
    "UNext": UNext,
    "UNeXt": UNext,  # the reference factory's spelling
    "UNext_S": UNext_S,
    **{name: functools.partial(build_unext_cmrf, name) for name in _CMRF_VARIANTS},
    "KNUnet": KMUNet,
    "UKAN": UKAN,
    "U-KAN": UKAN,  # the reference factory's spelling
    "UNet_base": UNetBase,
    "Unetpp": UNetPlusPlus,
    "MultiResUnet": MultiResUnet,
    "UCTransNet": UCTransNet,
    "TransUNet": TransUNet,
    "TransUnet_fKAN": functools.partial(TransUNet, mlp_type="fkan"),
    "TransUNet_Vit_fKAN": functools.partial(TransUNet, backbone="ViT-B_16", mlp_type="fkan"),
    # the reference's TransUNet_KAN_fJNB: its fKAN MLP is the fractional-Jacobi KAN
    "TransUNet_fJNB": functools.partial(TransUNet, mlp_type="fkan"),
    "SwinUnet": SwinUnet,
    "SMESwinUnet": SMESwinUnet,
    "SegViT_fKAN": SegViTfKAN,  # takes in_chans / out_chans, as in JAX
    "TinyUNet": TinyUNet,
}

# models whose JAX counterpart sizes parameters from the input at init (the
# position embeddings): `build` gives them img_size = input_size. SwinUnet
# and SMESwinUnet fix their token grid by img_size (224) as JAX's do
INPUT_SIZED = frozenset({"TransUNet", "TransUnet_fKAN", "TransUNet_Vit_fKAN", "TransUNet_fJNB",
                         "SegViT_fKAN"})
# builders that take in_chans / out_chans where the others take n_channels /
# n_classes, as JAX's: the SegMamba family, which also takes no compute
# dtype (it runs in its parameters' type), and SegViT_fKAN, which does (JAX's
# CLIs pass it n_channels and fail: ROADMAP Queue 3)
SEGMAMBA_NAMES = frozenset(_SEGMAMBA_VARIANTS)
IN_OUT_CHANS = SEGMAMBA_NAMES | {"SegViT_fKAN"}


def build(name: str, input_size: int | None = None, **kwargs):
    """The registry's model `name`. `input_size`, the side of the images it
    will see (the CLIs pass theirs), becomes the img_size of an INPUT_SIZED
    model unless kwargs set one; other models ignore it (UCTransNet keeps its
    default 224, as JAX's CLI builds it)."""
    if input_size is not None and name in INPUT_SIZED:
        kwargs.setdefault("img_size", input_size)
    if name not in registry:
        # the reference's 'MultiResUnet1_<nfilt>_<alpha>' model names
        m = re.match(r"^MultiResUnet1?_(\d+)_([\d.]+)$", name)
        if m:
            kwargs.setdefault("nfilt", int(m.group(1)))
            kwargs.setdefault("alpha", float(m.group(2)))
            return MultiResUnet(**kwargs)
        raise KeyError(f"unknown model {name!r}; available: {sorted(registry)}")
    return registry[name](**kwargs)


def takes_dtype(name: str) -> bool:
    """Whether `name`'s builder takes a compute dtype (not a SegMamba name)."""
    return name not in SEGMAMBA_NAMES


def build_for(name: str, input_size: int, n_channels: int, n_classes: int,
              dtype: torch.dtype | None = None, **kwargs):
    """The model `name` for input_size x input_size images of n_channels and
    n_classes classes, as every CLI builds it: in_chans / out_chans for the
    IN_OUT_CHANS names, else n_channels / n_classes; `dtype` (the compute
    type; None: the parameters') to every builder that takes one
    (`takes_dtype`)."""
    if name in IN_OUT_CHANS:
        kwargs.update(in_chans=n_channels, out_chans=n_classes)
    else:
        kwargs.update(n_channels=n_channels, n_classes=n_classes)
    if dtype is not None and takes_dtype(name):
        kwargs["dtype"] = dtype
    return build(name, input_size, **kwargs)


def _lecun_normal(w: torch.Tensor, fan_in: int, generator: torch.Generator) -> None:
    # flax lecun_normal: truncated normal, stddev corrected for the cut; a raw
    # parameter's fan-in is the product of all but its last axis
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=generator)


def _he_uniform(w: torch.Tensor, generator: torch.Generator) -> None:
    # flax he_uniform on a raw (a, b) parameter: fan_in is its axis -2, a
    limit = math.sqrt(6.0 / w.shape[-2])
    nn.init.uniform_(w, -limit, limit, generator=generator)


@torch.no_grad()
def init_parameters(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded initialisation with the JAX package's initialisers: every conv
    (1-D and 2-D), transposed-conv and linear weight lecun-normal (truncated
    at 2 sigma), biases zero, BN scale one / shift zero / stats (0, 1),
    LayerNorm scale one / shift zero, the MLFC-W blend zero, and each
    BiMamba's A_log = log(1..d_state), D = 1. Spatial-Mamba's raw
    parameters: A_logs = log(1..d_state), Ds = 1, dt_projs_bias =
    log(expm1(0.01)), x_proj_weight and dt_projs_weight lecun-normal with
    flax's fan-in of a raw parameter (its axis -2), StateFusion's kernels and
    alpha one; KANLinear's base_weight and spline_scaler he-uniform (fan-in
    axis -2 too), spline_weight normal(0.1 / grid_size); the FJNB alpha =
    beta = 1, gamma = 0. The hybrid family's: MambaVisionMixer's A_log and
    D as BiMamba's; SS2D's per-direction x_proj_weight and dt_projs_weight
    lecun-normal (fan-in: the product of all but the last axis, as flax
    computes it for a 3-D parameter), A_logs, Ds and dt_projs_bias as
    StructureAwareSSM's; MDTA's temperature, TGDC's gamma and
    SpatialStateFusion's alpha one; the packed attention in_proj_weight
    xavier-uniform with a zero in_proj_bias; the window attention's
    relative-position table normal(0.02). The UNet baselines': StdConv's raw
    kernel lecun-normal (as a conv), GroupNorm scale one / shift zero, the
    position embeddings of UCTransNet, TransUNet and SegViT_fKAN zero. The
    UNext_CMRF family's: ODConv2d's raw 5-D weight he-normal (truncated at 2
    sigma) with flax's fan-in of a 5-D parameter, the product of all but its
    last axis (Kn * O * I/g * k); ChannelsFirstLN (a LayerNorm) one / zero;
    the rational KAN bases' alpha, beta, iota and w one, zeta zero; GHPA's
    grids one; the adaptive wavelet filters Haar.
    Draws come from `generator` in module order."""
    for mod in model.modules():
        if isinstance(mod, (nn.Conv1d, nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
            w = mod.weight
            if isinstance(mod, nn.ConvTranspose2d):  # (I, O, kh, kw)
                fan_in = w.shape[0] * w.shape[2] * w.shape[3]
            else:
                fan_in = math.prod(w.shape[1:])
            _lecun_normal(w, fan_in, generator)
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, (StructureAwareSSM, SS2D)):
            for w in (mod.x_proj_weight, mod.dt_projs_weight):
                _lecun_normal(w, math.prod(w.shape[:-1]), generator)
            mod.reset_ssm_parameters()
        elif isinstance(mod, (BiMamba, MambaVisionMixer)):
            mod.reset_ssm_parameters()
        elif isinstance(mod, MDTAAttention):
            mod.temperature.fill_(1.0)
        elif isinstance(mod, TGDC):
            mod.gamma.fill_(1.0)
        elif isinstance(mod, SpatialStateFusion):
            mod.alpha.fill_(1.0)
        elif isinstance(mod, TorchMultiheadAttention):
            w = mod.in_proj_weight
            limit = math.sqrt(6.0 / (w.shape[0] + w.shape[1]))
            nn.init.uniform_(w, -limit, limit, generator=generator)
            mod.in_proj_bias.zero_()
        elif isinstance(mod, WindowAttention):
            nn.init.normal_(mod.relative_position_bias_table, 0.0, 0.02, generator=generator)
        elif isinstance(mod, StateFusion):
            for w in (mod.kernel_3, mod.kernel_3_1, mod.kernel_3_2, mod.alpha):
                w.fill_(1.0)
        elif isinstance(mod, KANLinear):
            _he_uniform(mod.base_weight, generator)
            nn.init.normal_(mod.spline_weight, 0.0, 0.1 / mod.grid_size, generator=generator)
            _he_uniform(mod.spline_scaler, generator)
        elif isinstance(mod, FractionalJacobiNeuralBlock):
            mod.alpha.fill_(1.0)
            mod.beta.fill_(1.0)
            mod.gamma.zero_()
        elif isinstance(mod, ODConv2d):
            w = mod.weight
            std = math.sqrt(2.0 / math.prod(w.shape[:-1])) / 0.87962566103423978
            nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=generator)
        elif isinstance(mod, (JacobiRKAN, PadeRKAN, GHPA, AdaptiveWaveletPool2d)):
            mod.reset_parameters()
        elif isinstance(mod, (ChannelEmbeddings, TransUNet, SegViTfKAN)):
            mod.position_embeddings.zero_()
        elif isinstance(mod, (nn.BatchNorm2d, nn.LayerNorm, GroupNorm)):
            mod.reset_parameters()
        elif isinstance(mod, MLFC) and hasattr(mod, "W"):
            mod.W.zero_()
    return model


__all__ = ["ACCUNet", "ACC_UNet", "ACC_UNet_Lite", "ACC_UNet_W", "Backbone_SpatialMamba",
           "INPUT_SIZED", "IN_OUT_CHANS", "KMUNet", "MultiResUnet", "SEGMAMBA_NAMES",
           "SMESwinUnet", "SegMamba", "SegViTfKAN", "SpatialMamba", "SwinUnet", "TinyUNet",
           "TransUNet", "UCTransNet", "UKAN", "UNetBase", "UNetPlusPlus", "UNext", "UNextCMRF",
           "UNext_S",
           "VSSM", "build", "build_for", "build_segmamba", "build_unext_cmrf",
           "init_parameters", "registry", "takes_dtype"]
