"""UNETR decoder blocks of the SegMamba family (torch.nn, NHWC), counterpart
of accunet_tpu/nn/unetr.py: MONAI's UnetResBlock, UnetrBasicBlock,
UnetrUpBlock and UnetOutBlock rebuilt 2D, since every Conv3d of the
reference's SegMamba stack is (1, k, k) on a depth-1 volume.

Every conv of the residual blocks is bias-free (MONAI's get_conv_layer
default); instance norm is per sample and channel over H, W, without affine
parameters. Weights keep torch's layouts (Conv2d OIHW, ConvTranspose2d
(I, O, 2, 2)), so the JAX tree maps onto them with `state_dict_from_jax`.
"""

from __future__ import annotations

import torch
from torch import nn

from accunet_tpu_torch.models.acc_unet import ConvTranspose2x2
from accunet_tpu_torch.ops.activation import lrelu
from accunet_tpu_torch.ops.conv import conv1x1, conv2d


def instance_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """x (B, H, W, C) normalised over H, W per sample and channel."""
    mean = x.mean(dim=(1, 2), keepdim=True)
    var = (x - mean).square().mean(dim=(1, 2), keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps)


class UnetResBlock(nn.Module):
    """conv 3x3 -> IN -> lrelu -> conv 3x3 -> IN, plus the input or, when the
    width changes, its 1x1 conv + IN; then lrelu. Kernel 3 and stride 1, the
    only ones the SegMamba family uses."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.conv1 = nn.Conv2d(in_channels, out_channels, 3, bias=False)
        self.conv2 = nn.Conv2d(out_channels, out_channels, 3, bias=False)
        self.conv3 = (nn.Conv2d(in_channels, out_channels, 1, bias=False)
                      if in_channels != out_channels else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = lrelu(instance_norm(conv2d(x, self.conv1.weight)))
        out = instance_norm(conv2d(out, self.conv2.weight))
        residual = x if self.conv3 is None else instance_norm(conv1x1(x, self.conv3.weight))
        return lrelu(out + residual)


class UnetrBasicBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.layer = UnetResBlock(in_channels, out_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.layer(x)


class UnetrUpBlock(nn.Module):
    """Bias-free 2x2 transposed-conv upsample, concat with the skip, then an
    UnetResBlock."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.transp_conv = ConvTranspose2x2(in_channels, out_channels, bias=False)
        self.conv_block = UnetResBlock(2 * out_channels, out_channels)

    def forward(self, x: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        return self.conv_block(torch.cat([self.transp_conv(x), skip], dim=-1))


class UnetOutBlock(nn.Module):
    """1x1 conv head with bias."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, out_channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv1x1(x, self.conv.weight, self.conv.bias)
