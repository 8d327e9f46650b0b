"""MedMamba and the Spatial-Mamba classifier in torch.nn on NHWC tensors:
counterpart of accunet_tpu/models/medmamba.py (`PatchMerging2D`, `VSSM`,
`SpatialMambaStem`, `_ConvLayer`, `SpatialMambaDownSampling`,
`SpatialMamba`, `Backbone_SpatialMamba`).

    VSSM (registry name MedMamba): a 4x4/4 patch conv + LayerNorm, stages
        of SSConvSSM blocks (nn/ss2d.py) with PatchMerging2D (the 2x2
        neighbours concatenated [x00, x10, x01, x11] -> LayerNorm -> Linear
        to 2x the width, no bias) between them -> global mean (no final
        norm, as the reference ships it) -> Linear head: float32 logits
        (B, num_classes)

    patch_embed (stem): conv 3x3/2 -> (conv 3x3, conv 3x3) + residual ->
        conv 3x3/2 to 4x the width -> 1x1 project, bias-free convs with BN
    stages of SpatialMambaBlocks (d_state 1 by default), an inverted
        bottleneck DownSampling (1x1 expand 8x, depthwise 3x3/2, 1x1 project
        to 2x the width with BN) between stages
    -> LayerNorm, global mean, Linear head: float32 logits (B, num_classes);
       or, with return_features, each stage's output

Attribute names follow the JAX tree under `state_dict_from_jax`: the flax
names `conv2_0`, `conv_0` become ModuleList entries, `layers_0_blocks_1`
becomes `layers_0_blocks[1]` and `layers_0_downsample` stays as it is. BN
is flax's (momentum 0.9, so 0.1 in torch; eps 1e-5). JAX's `use_kan_ffn`,
which its blocks ignore, is not taken.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from accunet_tpu_torch.nn.acc_blocks import BatchNorm
from accunet_tpu_torch.nn.ss2d import SSConvSSM
from accunet_tpu_torch.nn.ssm import SpatialMambaBlock
from accunet_tpu_torch.ops.conv import conv2d_strided


class PatchMerging2D(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.norm = nn.LayerNorm(4 * dim, eps=1e-5)
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2], x[:, 1::2, 1::2]],
                      dim=-1)
        return self.reduction(self.norm(y))


class VSSM(nn.Module):
    """MedMamba's classifier on (B, H, W, n_channels), H and W divisible by
    patch_size * 2^(stages - 1)."""

    def __init__(self, n_channels: int = 3, num_classes: int = 2, patch_size: int = 4,
                 depths: Sequence[int] = (2, 2, 4, 2), dims: Sequence[int] = (96, 192, 384, 768),
                 d_state: int = 16):
        super().__init__()
        self.depths = list(depths)
        self.patch_embed_proj = nn.Conv2d(n_channels, dims[0], patch_size, stride=patch_size)
        self.patch_embed_norm = nn.LayerNorm(dims[0], eps=1e-5)
        for i, depth in enumerate(self.depths):
            setattr(self, f"layers_{i}_blocks",
                    nn.ModuleList(SSConvSSM(dims[i], d_state) for _ in range(depth)))
            if i < len(self.depths) - 1:
                setattr(self, f"layers_{i}_downsample", PatchMerging2D(dims[i]))
        self.head = nn.Linear(dims[len(self.depths) - 1], num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.head.weight.dtype)
        p = self.patch_embed_proj
        x = conv2d_strided(x, p.weight, p.bias, p.stride)
        x = self.patch_embed_norm(x)
        for i in range(len(self.depths)):
            for block in getattr(self, f"layers_{i}_blocks"):
                x = block(x)
            if i < len(self.depths) - 1:
                x = getattr(self, f"layers_{i}_downsample")(x)
        return self.head(x.mean(dim=(1, 2))).float()


class _ConvLayer(nn.Module):
    """conv (kernel k, stride s, padding k // 2, groups) [-> BN] [-> ReLU] on NHWC."""

    def __init__(self, in_ch: int, features: int, kernel: int = 3, stride: int = 1,
                 groups: int = 1, use_norm: bool = True, use_act: bool = True,
                 use_bias: bool = True):
        super().__init__()
        self.conv = nn.Conv2d(in_ch, features, kernel, stride=stride, padding=kernel // 2,
                              groups=groups, bias=use_bias)
        self.norm = BatchNorm(features) if use_norm else None
        self.use_act = use_act

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = self.conv
        x = conv2d_strided(x, c.weight, c.bias, c.stride, c.padding, c.groups)
        if self.norm is not None:
            x = self.norm(x)
        return F.relu(x) if self.use_act else x


class SpatialMambaStem(nn.Module):
    """conv 3x3/2 -> residual double conv -> 3x3/2 expand 4x -> 1x1 project."""

    def __init__(self, in_ch: int, embed_dim: int = 64):
        super().__init__()
        half = embed_dim // 2
        self.conv1 = _ConvLayer(in_ch, half, 3, 2, use_bias=False)
        self.conv2 = nn.ModuleList([_ConvLayer(half, half, 3, 1, use_bias=False),
                                    _ConvLayer(half, half, 3, 1, use_act=False, use_bias=False)])
        self.conv3 = nn.ModuleList([
            _ConvLayer(half, 4 * embed_dim, 3, 2, use_bias=False),
            _ConvLayer(4 * embed_dim, embed_dim, 1, 1, use_act=False, use_bias=False)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv1(x)
        y = y + self.conv2[1](self.conv2[0](y))
        return self.conv3[1](self.conv3[0](y))


class SpatialMambaDownSampling(nn.Module):
    """1x1 expand to 8*dim (ReLU) -> depthwise 3x3/2 (ReLU) -> 1x1 to 2*dim
    with BN."""

    def __init__(self, dim: int):
        super().__init__()
        mid = int(2 * dim * 4.0)
        self.conv = nn.ModuleList([
            _ConvLayer(dim, mid, 1, use_norm=False),
            _ConvLayer(mid, mid, 3, 2, groups=mid, use_norm=False),
            _ConvLayer(mid, 2 * dim, 1, use_act=False)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.conv:
            x = layer(x)
        return x


class SpatialMamba(nn.Module):
    def __init__(self, n_channels: int = 3, num_classes: int = 1000,
                 depths: Sequence[int] = (2, 4, 8, 4), dims: Sequence[int] = (64, 128, 256, 512),
                 d_state: int = 1):
        super().__init__()
        self.depths = list(depths)
        self.patch_embed = SpatialMambaStem(n_channels, dims[0])
        for i, depth in enumerate(self.depths):
            if i > 0:  # the reference attaches it to the end of stage i - 1
                setattr(self, f"layers_{i - 1}_downsample", SpatialMambaDownSampling(dims[i - 1]))
            setattr(self, f"layers_{i}_blocks",
                    nn.ModuleList(SpatialMambaBlock(dims[i], d_state=d_state)
                                  for _ in range(depth)))
        self.norm = nn.LayerNorm(dims[-1], eps=1e-5)
        self.head = nn.Linear(dims[-1], num_classes)

    def forward(self, x: torch.Tensor, return_features: bool = False):
        """x (B, H, W, n_channels) -> float32 logits (B, num_classes), or the
        stages' outputs (B, H_i, W_i, dims[i]) with return_features."""
        x = self.patch_embed(x.to(self.head.weight.dtype))
        features = []
        for i in range(len(self.depths)):
            if i > 0:
                x = getattr(self, f"layers_{i - 1}_downsample")(x)
            for block in getattr(self, f"layers_{i}_blocks"):
                x = block(x)
            features.append(x)
        if return_features:
            return tuple(features)
        return self.head(self.norm(x).mean(dim=(1, 2))).float()


def Backbone_SpatialMamba(**kw) -> SpatialMamba:
    """The feature-pyramid name: the same model (`return_features=True` in
    its call gives the stages' outputs)."""
    return SpatialMamba(**kw)
