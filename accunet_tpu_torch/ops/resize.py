"""Bilinear resize on NHWC tensors, counterpart of accunet_tpu/ops/resize.py
(`resize_bilinear`, `upsample_bilinear_2x`).

Both run `F.interpolate` on the channels_last NCHW view, as the JAX
functions are held to it (tests/test_resize.py). Where JAX departs from
torch the port follows JAX: an output axis of size 1 with
align_corners=False samples source 0 (`_axis_weights`), where torch samples
the centre.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def resize_bilinear(x: torch.Tensor, out_hw: tuple[int, int],
                    align_corners: bool = False) -> torch.Tensor:
    """Bilinear resize of (B, H, W, C) to (B, H', W', C)."""
    oh, ow = out_hw
    if not align_corners:
        # JAX's size-1 output takes source index 0
        if oh == 1:
            x = x[:, :1]
        if ow == 1:
            x = x[:, :, :1]
    if tuple(x.shape[1:3]) == (oh, ow):
        return x
    y = F.interpolate(x.permute(0, 3, 1, 2), size=(oh, ow), mode="bilinear",
                      align_corners=align_corners)
    return y.permute(0, 2, 3, 1)


def upsample_bilinear_2x(x: torch.Tensor, align_corners: bool = False) -> torch.Tensor:
    """F.interpolate(scale_factor=2, mode='bilinear') on NHWC."""
    return resize_bilinear(x, (2 * x.shape[1], 2 * x.shape[2]), align_corners)
