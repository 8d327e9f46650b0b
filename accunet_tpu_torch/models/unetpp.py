"""UNet++ with nested dense skips (torch.nn, NHWC): counterpart of
accunet_tpu/models/unetpp.py (`ConvBlock`, `UNetPlusPlus`).

Widths are fixed at 64-1024. Node x{i}_{j} is a ConvBlock ((3x3 conv, BN,
ReLU) x 2, Sequential indices conv.0 / conv.1 / conv.3 / conv.4: U-KAN's
ConvLayer) over the concat of x{i}_0..x{i}_{j-1} and up{i+1}_0(x{i+1}_{j-1});
each up{i}_0 is one ConvTranspose2d(k2 s2) reused down its whole row, as in
the reference. Head: a 1x1 conv to n_classes (no +1, unlike UNet), sigmoid
probabilities for one class with final_sigmoid. Names follow the JAX tree
(`conv0__1` is `conv0_1`); `dtype` is the compute type, as UNetBase's.
"""

from __future__ import annotations

import torch
from torch import nn

from accunet_tpu_torch.models.acc_unet import ConvTranspose2x2
from accunet_tpu_torch.models.u_kan import ConvLayer as ConvBlock
from accunet_tpu_torch.ops.conv import conv1x1
from accunet_tpu_torch.ops.pooling import max_pool2d

WIDTHS = (64, 128, 256, 512, 1024)


class UNetPlusPlus(nn.Module):
    """x (B, H, W, n_channels), H and W divisible by 16 -> float32
    (B, H, W, n_classes)."""

    def __init__(self, n_channels: int = 3, n_classes: int = 1, final_sigmoid: bool = True,
                 dtype: torch.dtype | None = None):
        super().__init__()
        f = WIDTHS
        self.sigmoid = n_classes == 1 and final_sigmoid
        self.dtype = dtype
        for i in range(5):  # node (i, j) sees j earlier nodes of its row and one upsample
            for j in range(5 - i):
                cin = n_channels if (i, j) == (0, 0) else (f[i - 1] if j == 0 else f[i] * (j + 1))
                setattr(self, f"conv{i}_{j}", ConvBlock(cin, f[i]))
        for i in range(1, 5):
            setattr(self, f"up{i}_0", ConvTranspose2x2(f[i], f[i - 1]))
        self.final_conv = nn.Conv2d(f[0], n_classes, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.final_conv.weight.dtype if self.dtype is None else self.dtype)
        rows = [[self.conv0_0(x)]]
        for i in range(1, 5):
            rows.append([getattr(self, f"conv{i}_0")(max_pool2d(rows[-1][0], 2))])
        for j in range(1, 5):
            for i in range(5 - j):
                up = getattr(self, f"up{i + 1}_0")(rows[i + 1][j - 1])
                rows[i].append(getattr(self, f"conv{i}_{j}")(torch.cat([*rows[i], up], dim=-1)))
        y = conv1x1(rows[0][4], self.final_conv.weight, self.final_conv.bias)
        return (torch.sigmoid(y) if self.sigmoid else y).float()
