"""Pooling / nearest-resampling ops on NHWC tensors.

Counterpart of accunet_tpu/ops/pooling.py. Every window the ACC-UNet family
uses is a power of two that divides the spatial dims, so pooling is a reshape
plus a reduction (kernel = stride, no padding, as torch's AvgPool2d(s) /
MaxPool2d(s)); a non-divisible map is rejected instead of floored.
"""

from __future__ import annotations

import torch


def _windows(x: torch.Tensor, s: int) -> torch.Tensor:
    b, h, w, c = x.shape
    if h % s or w % s:
        raise ValueError(f"pool window {s} does not divide the map {h}x{w}")
    return x.reshape(b, h // s, s, w // s, s, c)


def avg_pool2d(x: torch.Tensor, s: int) -> torch.Tensor:
    """AvgPool kernel=s stride=s (NHWC)."""
    if s == 1:
        return x
    return _windows(x, s).mean(dim=(2, 4))


def max_pool2d(x: torch.Tensor, s: int) -> torch.Tensor:
    """MaxPool kernel=s stride=s (NHWC)."""
    if s == 1:
        return x
    return _windows(x, s).amax(dim=(2, 4))


def upsample_nearest(x: torch.Tensor, s: int) -> torch.Tensor:
    """Nearest-neighbour upsample by an integer factor (NHWC); equals
    torch.nn.Upsample(scale_factor=s, mode='nearest')."""
    if s == 1:
        return x
    b, h, w, c = x.shape
    x = x[:, :, None, :, None, :].expand(b, h, s, w, s, c)
    return x.reshape(b, h * s, w * s, c)


def global_avg_pool(x: torch.Tensor) -> torch.Tensor:
    """AdaptiveAvgPool2d(1) then squeeze: (B,H,W,C) -> (B,C)."""
    return x.mean(dim=(1, 2))


def hanc_features(x: torch.Tensor, k: int) -> torch.Tensor:
    """The HANC feature stack: variants [x, up(avg_2^i(x)), up(max_2^i(x))]
    for i=1..k-1, interleaved per channel — channel c*(2k-1)+j holds variant
    j of input channel c in the order [identity, avg2, avg4, .., max2, max4,
    ..]. (B,H,W,C) -> (B,H,W,C*(2k-1))."""
    if k == 1:
        return x
    variants = [x]
    for i in range(1, k):
        variants.append(upsample_nearest(avg_pool2d(x, 2 ** i), 2 ** i))
    for i in range(1, k):
        variants.append(upsample_nearest(max_pool2d(x, 2 ** i), 2 ** i))
    b, h, w, c = x.shape
    return torch.stack(variants, dim=-1).reshape(b, h, w, c * (2 * k - 1))


def interleave_channels(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """out[..., 2c] = a[..., c], out[..., 2c+1] = b[..., c] (the MLFC merge's
    concat-then-view)."""
    bb, h, w, c = a.shape
    return torch.stack([a, b], dim=-1).reshape(bb, h, w, 2 * c)
