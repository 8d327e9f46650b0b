"""TinyU-Net, a lightweight CMRF UNet (torch.nn, NHWC): counterpart of
accunet_tpu/models/tiny_unet.py.

    encoder: four CMRF blocks (64, 128, 256, 512), each followed by a 2x2
        max pool; the skip is taken before the pool
    decoder: a 2x bicubic upsample (align_corners=False), the skip
        concatenated, a CMRF (in 1024, 768, 384, 192 -> 512, 256, 128, 64)
    final_conv: a 1x1 conv with bias, raw logits, n_classes channels (2 by
        default, as in the reference)

The CMRF blocks are `nn/cmrf_blocks.py`'s, whose depthwise chain is plain
grouped convs, as JAX's is; their BatchNorms follow the train mode. `dtype`
is the compute type, as UNetBase's. No hand-written kernel runs on this
model's path.
"""

from __future__ import annotations

import torch
from torch import nn

from accunet_tpu_torch.nn.cmrf_blocks import CMRF
from accunet_tpu_torch.ops.conv import conv1x1
from accunet_tpu_torch.ops.pooling import max_pool2d
from accunet_tpu_torch.ops.resize import resize_bicubic

ENC_OUT = (64, 128, 256, 512)
DEC_IN = (192, 384, 768, 1024)  # each level's upsampled input + its skip


class TinyUNet(nn.Module):
    """x (B, H, W, n_channels) -> float32 logits (B, H, W, n_classes); H and
    W divisible by 16."""

    def __init__(self, n_channels: int = 3, n_classes: int = 2,
                 dtype: torch.dtype | None = None):
        super().__init__()
        self.dtype = dtype
        cin = n_channels
        for i, cout in enumerate(ENC_OUT):
            setattr(self, f"encoder{i + 1}_cmrf", CMRF(cin, cout))
            cin = cout
        for i, (c1, c2) in enumerate(zip(DEC_IN, ENC_OUT)):
            setattr(self, f"decoder{i + 1}_cmrf", CMRF(c1, c2))
        self.final_conv = nn.Conv2d(ENC_OUT[0], n_classes, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.final_conv.weight.dtype if self.dtype is None else self.dtype)
        skips = []
        for i in range(len(ENC_OUT)):
            skips.append(getattr(self, f"encoder{i + 1}_cmrf")(x))
            x = max_pool2d(skips[-1], 2)
        for i in reversed(range(len(ENC_OUT))):
            x = resize_bicubic(x, (2 * x.shape[1], 2 * x.shape[2]))
            x = getattr(self, f"decoder{i + 1}_cmrf")(torch.cat([x, skips[i]], dim=-1))
        return conv1x1(x, self.final_conv.weight, self.final_conv.bias).float()
