"""The plain 5-level UNet (torch.nn, NHWC): counterpart of
accunet_tpu/models/unet.py (`ConvBatchNorm`, `_NConvs`, `UpBlock`,
`UNetBase`, registered as `UNet_base`).

    ConvBatchNorm: 3x3 conv -> BN -> ReLU
    encoder: inc (one ConvBatchNorm at c), then down1-down4 (2x2 max-pool,
        two ConvBatchNorms) at 2c, 4c, 8c, 8c
    UpBlock: ConvTranspose2d(k2 s2) at the input width -> concat [up, skip]
        -> two ConvBatchNorms; up4-up1 down to c
    head: 1x1 conv; one class with final_sigmoid gives sigmoid
        probabilities, n_classes > 1 gives n_classes + 1 logits

Module names follow the JAX tree (`nConvs_0` is `nConvs.0`), so its
variables load with `state_dict_from_jax`. BN is flax's (momentum 0.9, eps
1e-5, the biased batch variance into `running_var`). `dtype` is the compute
type, as ACCUNet's: None computes in the parameters' type, torch.bfloat16 in
bf16 with the fp32 parameters cast at use; the output is float32. No
hand-written kernel runs on this model's path, as no Pallas kernel runs on
JAX's.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from accunet_tpu_torch.models.acc_unet import ConvTranspose2x2
from accunet_tpu_torch.nn.acc_blocks import BatchNorm
from accunet_tpu_torch.ops.conv import conv1x1, conv2d
from accunet_tpu_torch.ops.pooling import max_pool2d


class ConvBatchNorm(nn.Module):
    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, out_channels, 3, padding=1)
        self.norm = BatchNorm(out_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.norm(conv2d(x, self.conv.weight, self.conv.bias)))


class _NConvs(nn.Module):
    """Two ConvBatchNorms in sequence, the first from in_channels."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.nConvs = nn.ModuleList(
            ConvBatchNorm(in_channels if i == 0 else out_channels, out_channels)
            for i in range(2))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for conv in self.nConvs:
            x = conv(x)
        return x


class UpBlock(_NConvs):
    """x (B, h, w, in_channels) upsampled 2x at its own width, concatenated
    with skip (B, 2h, 2w, skip_channels), then two ConvBatchNorms."""

    def __init__(self, in_channels: int, skip_channels: int, out_channels: int):
        super().__init__(in_channels + skip_channels, out_channels)
        self.up = ConvTranspose2x2(in_channels, in_channels)

    def forward(self, x: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        return super().forward(torch.cat([self.up(x), skip], dim=-1))


class UNetBase(nn.Module):
    """x (B, H, W, n_channels), H and W divisible by 16 -> float32
    (B, H, W, 1 or n_classes + 1)."""

    def __init__(self, n_channels: int = 3, n_classes: int = 9, base_width: int = 64,
                 final_sigmoid: bool = True, dtype: torch.dtype | None = None):
        super().__init__()
        c = base_width
        self.sigmoid = n_classes == 1 and final_sigmoid
        self.dtype = dtype
        self.inc = ConvBatchNorm(n_channels, c)
        self.down1 = _NConvs(c, c * 2)
        self.down2 = _NConvs(c * 2, c * 4)
        self.down3 = _NConvs(c * 4, c * 8)
        self.down4 = _NConvs(c * 8, c * 8)
        self.up4 = UpBlock(c * 8, c * 8, c * 4)
        self.up3 = UpBlock(c * 4, c * 4, c * 2)
        self.up2 = UpBlock(c * 2, c * 2, c)
        self.up1 = UpBlock(c, c, c)
        self.outc = nn.Conv2d(c, n_classes if n_classes == 1 else n_classes + 1, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.outc.weight.dtype if self.dtype is None else self.dtype)
        x1 = self.inc(x)
        x2 = self.down1(max_pool2d(x1, 2))
        x3 = self.down2(max_pool2d(x2, 2))
        x4 = self.down3(max_pool2d(x3, 2))
        x5 = self.down4(max_pool2d(x4, 2))
        y = self.up1(self.up2(self.up3(self.up4(x5, x4), x3), x2), x1)
        y = conv1x1(y, self.outc.weight, self.outc.bias)
        return (torch.sigmoid(y) if self.sigmoid else y).float()
