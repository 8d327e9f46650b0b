"""One ResPath level:

    x_i = x_{i-1} + lrelu((y_{i-1} * g) * s_se + t_se)     (level > 0)
    y_i = lrelu(conv3x3(x_i) * s_bn + t_bn)                 (conv bias in t_bn)

plus fp32 per-tile channel sums of y_i for the next SE gate; the gate MLP
stays outside (nn/acc_blocks.py ResPath).

Replaces the TPU kernel `respath_level_frame` (accunet_tpu/ops/pallas/
respath.py:72, body `_kernel` :31-69), which ran a level as one pass over the
s2d frame with a packed 4Cx4C kernel.

Kernel (`csrc/respath_level.cu`): plain NHWC, no frame. One CTA per (image,
8x16-pixel tile, 32*NJ output channels). Per 8-channel chunk it stages the
10x18 halo of x_i — computing the SE apply of the previous level on load, so
x_i is formed and written in the same pass — and the 3x3 weights, then runs
the implicit-GEMM conv into fp32 registers (each warp owns one output row).
The epilogue applies BN + lrelu, writes y_i and reduces the tile's channel
sums in a fixed order (no atomics, so the sums are deterministic). What bounds
it on the card: fp32 FMAs on CUDA cores fed from shared memory (one load per
FMA at C=32); device-memory traffic is one read of x and y_{i-1} and one write
of x_i and y_i per level, which the design keeps by fusing the SE apply,
residual, conv, BN, activation and squeeze.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from accunet_tpu_torch.ops.activation import lrelu
from accunet_tpu_torch.ops.kernels import _build

TILE_H, TILE_W = 8, 16


def respath_level_reference(x, w, s_bn, t_bn, y_prev=None, gate=None,
                            s_se=None, t_se=None):
    """Plain PyTorch version. x, y_prev (B,H,W,C); w (3,3,C,C) HWIO fp32;
    s_bn/t_bn/s_se/t_se (C,) fp32; gate (B,C) fp32.
    Returns (y_i, x_i, sums (B,1,C) fp32); fp32 inside like the kernel."""
    xf = x.float()
    if y_prev is not None:
        se = (y_prev.float() * gate.float()[:, None, None, :]) * s_se.float() + t_se.float()
        xf = xf + lrelu(se)
    acc = F.conv2d(xf.permute(0, 3, 1, 2), w.float().permute(3, 2, 0, 1), padding=1)
    y = lrelu(acc.permute(0, 2, 3, 1) * s_bn.float() + t_bn.float()).to(x.dtype)
    x_new = xf.to(x.dtype) if y_prev is not None else x
    return y, x_new, y.float().sum(dim=(1, 2))[:, None, :]


def respath_level(x, w, s_bn, t_bn, y_prev=None, gate=None, s_se=None, t_se=None):
    """Fused ResPath level. Same arguments and results as
    `respath_level_reference`, except that the sums are per 8x16 tile:
    (B, T, C) — consumers reduce over dim 1."""
    if x.device.type == "cpu":
        return respath_level_reference(x, w, s_bn, t_bn, y_prev, gate, s_se, t_se)
    b, h, wd, c = x.shape
    dev = x.device
    _build.require(x, "x")
    f32 = [t.float().contiguous() for t in (w, s_bn, t_bn)]
    _build.require(f32[0], "w", (3, 3, c, c), device=dev)
    _build.require(f32[1], "s_bn", (c,), device=dev)
    _build.require(f32[2], "t_bn", (c,), device=dev)
    has_prev = y_prev is not None
    if has_prev:
        _build.require(y_prev, "y_prev", x.shape, x.dtype, dev)
        prev = [t.float().contiguous() for t in (gate, s_se, t_se)]
        _build.require(prev[0], "gate", (b, c), device=dev)
        _build.require(prev[1], "s_se", (c,), device=dev)
        _build.require(prev[2], "t_se", (c,), device=dev)
        x_new = torch.empty_like(x)
        ptrs = [y_prev.data_ptr()] + [t.data_ptr() for t in prev]
    else:
        x_new = x
        ptrs = [0, 0, 0, 0]
    n_tiles = -(-h // TILE_H) * -(-wd // TILE_W)
    y = torch.empty_like(x)
    sums = torch.empty((b, n_tiles, c), dtype=torch.float32, device=dev)
    err = _build.load_library().accunet_respath_level(
        x.data_ptr(), *ptrs, *(t.data_ptr() for t in f32),
        y.data_ptr(), x_new.data_ptr() if has_prev else 0, sums.data_ptr(),
        b, h, wd, c, int(has_prev), _build.dtype_code(x), _build.stream_of(x),
    )
    _build.check(err, "accunet_respath_level")
    respath_level.launches += 1
    return y, x_new, sums


respath_level.launches = 0
