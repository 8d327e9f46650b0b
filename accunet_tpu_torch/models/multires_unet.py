"""MultiResUNet (torch.nn, NHWC): counterpart of
accunet_tpu/models/multires_unet.py (`Conv2dBN`, `_mrb_filters`,
`Multiresblock`, `Respath`, `MultiResUnet`).

    Multiresblock(W = num_filters * alpha): a chain of three 3x3 Conv2dBN
        + ReLU at int(0.167 W), int(0.333 W), int(0.5 W) channels,
        concatenated, BN; + a 1x1 Conv2dBN shortcut; BN; ReLU
    Respath(length): per step y = relu(bn(convs_i(x))), x = relu(bn(y +
        shortcuts_i(x))) with the SAME bns_i twice, as the reference does
        (in train mode its running statistics update twice, in order)
    MultiResUnet: four Multiresblock + Respath levels (nfilt * 2^l, path
        lengths 4..1), a fifth block at 16 nfilt, then ConvTranspose2d(k2
        s2) up, concat with the path, Multiresblock, down to nfilt; head a
        1x1 Conv2dBN without activation (1 or n_classes + 1 channels),
        sigmoid for one

The Respath is this plain conv + BN chain, not ACC-UNet's ResPath (whose
`respath_level` kernel computes another function); no hand-written kernel
runs on this model's path. Names follow the JAX tree (`bns_0` is `bns.0`);
`dtype` is the compute type, as UNetBase's. The registry parses the
reference's 'MultiResUnet1_<nfilt>_<alpha>' names (models/__init__.py).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from accunet_tpu_torch.models.acc_unet import ConvTranspose2x2
from accunet_tpu_torch.nn.acc_blocks import BatchNorm
from accunet_tpu_torch.ops.conv import conv2d
from accunet_tpu_torch.ops.pooling import max_pool2d


class Conv2dBN(nn.Module):
    def __init__(self, in_filters: int, out_filters: int, kernel_size: int = 3,
                 activation: str = "relu"):
        super().__init__()
        self.conv1 = nn.Conv2d(in_filters, out_filters, kernel_size, padding=kernel_size // 2)
        self.batchnorm = BatchNorm(out_filters)
        self.relu = activation == "relu"

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.batchnorm(conv2d(x, self.conv1.weight, self.conv1.bias))
        return F.relu(x) if self.relu else x


def _mrb_filters(num_filters: int, alpha: float) -> tuple[int, int, int]:
    w = num_filters * alpha
    return int(w * 0.167), int(w * 0.333), int(w * 0.5)


def mrb_width(num_filters: int, alpha: float) -> int:
    """A Multiresblock's output channels."""
    return sum(_mrb_filters(num_filters, alpha))


class Multiresblock(nn.Module):
    def __init__(self, in_channels: int, num_filters: int, alpha: float = 1.67):
        super().__init__()
        f3, f5, f7 = _mrb_filters(num_filters, alpha)
        out_f = f3 + f5 + f7
        self.shortcut = Conv2dBN(in_channels, out_f, 1, "none")
        self.conv_3x3 = Conv2dBN(in_channels, f3)
        self.conv_5x5 = Conv2dBN(f3, f5)
        self.conv_7x7 = Conv2dBN(f5, f7)
        self.batch_norm1 = BatchNorm(out_f)
        self.batch_norm2 = BatchNorm(out_f)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shortcut = self.shortcut(x)
        a = self.conv_3x3(x)
        b = self.conv_5x5(a)
        c = self.conv_7x7(b)
        y = self.batch_norm1(torch.cat([a, b, c], dim=-1))
        return F.relu(self.batch_norm2(y + shortcut))


class Respath(nn.Module):
    def __init__(self, in_channels: int, num_out_filters: int, length: int):
        super().__init__()
        cins = [in_channels] + [num_out_filters] * (length - 1)
        self.shortcuts = nn.ModuleList(Conv2dBN(c, num_out_filters, 1, "none") for c in cins)
        self.convs = nn.ModuleList(Conv2dBN(c, num_out_filters) for c in cins)
        self.bns = nn.ModuleList(BatchNorm(num_out_filters) for _ in cins)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for shortcut, conv, bn in zip(self.shortcuts, self.convs, self.bns):
            y = F.relu(bn(conv(x)))
            x = F.relu(bn(y + shortcut(x)))
        return x


class MultiResUnet(nn.Module):
    """x (B, H, W, n_channels), H and W divisible by 16 -> float32
    (B, H, W, 1 or n_classes + 1)."""

    def __init__(self, n_channels: int = 3, n_classes: int = 1, nfilt: int = 32,
                 alpha: float = 1.67, final_sigmoid: bool = True,
                 dtype: torch.dtype | None = None):
        super().__init__()
        nf, al = nfilt, alpha
        out_ch = n_classes if n_classes == 1 else n_classes + 1
        self.sigmoid = out_ch == 1 and final_sigmoid
        self.dtype = dtype
        cin = n_channels
        for lvl in range(4):
            setattr(self, f"multiresblock{lvl + 1}", Multiresblock(cin, nf * 2 ** lvl, al))
            cin = mrb_width(nf * 2 ** lvl, al)
            setattr(self, f"respath{lvl + 1}", Respath(cin, nf * 2 ** lvl, 4 - lvl))
        self.multiresblock5 = Multiresblock(cin, nf * 16, al)
        cin = mrb_width(nf * 16, al)
        for lvl in range(4):
            n_out = nf * 2 ** (3 - lvl)
            setattr(self, f"upsample{6 + lvl}", ConvTranspose2x2(cin, n_out))
            setattr(self, f"multiresblock{6 + lvl}", Multiresblock(2 * n_out, n_out, al))
            cin = mrb_width(n_out, al)
        self.conv_final = Conv2dBN(cin, out_ch, 1, "none")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.conv_final.conv1.weight
        x = x.to(w.dtype if self.dtype is None else self.dtype)
        skips = []
        for lvl in range(1, 5):
            x = getattr(self, f"multiresblock{lvl}")(x)
            skips.append(getattr(self, f"respath{lvl}")(x))
            x = max_pool2d(x, 2)
        x = self.multiresblock5(x)
        for lvl in range(6, 10):
            x = torch.cat([getattr(self, f"upsample{lvl}")(x), skips.pop()], dim=-1)
            x = getattr(self, f"multiresblock{lvl}")(x)
        y = self.conv_final(x)
        return (torch.sigmoid(y) if self.sigmoid else y).float()
