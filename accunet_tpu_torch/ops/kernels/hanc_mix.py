"""HANC aggregation + 1x1 mix:

    y = x@w0 + sum_{i<k} up_{2^i}( avg_{2^i}(x)@w_i + max_{2^i}(x)@w_{k-1+i} ) + b

Replaces the TPU kernel `hanc_mix` (accunet_tpu/ops/pallas/hanc.py:154,
body `_kernel` :68-120), which ran the whole telescope per row tile in VMEM.

Kernel (`csrc/hanc_mix.cu`): one CTA per (image, 4x8-pixel tile, 32*NJ
output channels). Per 16-channel chunk it stages the tile, builds the avg/max
pyramid in shared memory, and runs the 2k-1 mixes as one grouped product
into fp32 registers; the upsample-adds telescope in the epilogue and y is
written once. What bounds it on the card: the mixes are fp32 FMAs on CUDA
cores fed from shared memory (0.75 shared-memory loads per FMA at 128 output
channels), and at the widest layer (cnv72, C=4352) every CTA re-reads the
11 MB weight from L2.
The design keeps the full-resolution map to one read of x and one write of y
(the pyramid and the partial sums never reach device memory); tensor cores
and larger tiles are later work.
"""

from __future__ import annotations

import torch

from accunet_tpu_torch.ops.kernels import _build
from accunet_tpu_torch.ops.pooling import avg_pool2d, max_pool2d, upsample_nearest


def hanc_mix_reference(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                       k: int) -> torch.Tensor:
    """Plain PyTorch version: x (B,H,W,C), w (C, 2k-1, Cout), bias (Cout,).
    Accumulates in fp32 like the kernel; returns x.dtype."""
    xf, wf = x.float(), w.float()
    avg_maps, max_maps = [], []
    a = m = xf
    for _ in range(1, k):
        a = avg_pool2d(a, 2)
        m = max_pool2d(m, 2)
        avg_maps.append(a)
        max_maps.append(m)
    acc = None
    for i in range(k - 1, 0, -1):  # coarsest first
        term = avg_maps[i - 1] @ wf[:, i, :] + max_maps[i - 1] @ wf[:, k - 1 + i, :]
        acc = term if acc is None else term + upsample_nearest(acc, 2)
    y = xf @ wf[:, 0, :]
    if acc is not None:
        y = y + upsample_nearest(acc, 2)
    return (y + bias.float()).to(x.dtype)


def hanc_mix(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor, k: int) -> torch.Tensor:
    """HANC mix (pre-BN). x (B,H,W,C) float32/bfloat16, w (C, 2k-1, Cout),
    bias (Cout,); k in {2, 3}; H and W divisible by 2^(k-1)."""
    if x.device.type == "cpu":
        return hanc_mix_reference(x, w, bias, k)
    b, h, wd, c = x.shape
    if k not in (2, 3):
        raise ValueError(f"hanc_mix kernel takes k in (2, 3), got {k}")
    if h % 2 ** (k - 1) or wd % 2 ** (k - 1):
        raise ValueError(f"spatial dims {h}x{wd} not divisible by {2 ** (k - 1)}")
    _build.require(x, "x")
    cout = w.shape[-1]
    wk = w.float().contiguous()
    bk = bias.float().contiguous()
    _build.require(wk, "w", (c, 2 * k - 1, cout), device=x.device)
    _build.require(bk, "bias", (cout,), device=x.device)
    y = torch.empty((b, h, wd, cout), dtype=x.dtype, device=x.device)
    err = _build.load_library().accunet_hanc_mix(
        x.data_ptr(), wk.data_ptr(), bk.data_ptr(), y.data_ptr(),
        b, h, wd, c, cout, k, _build.dtype_code(x), _build.stream_of(x),
    )
    _build.check(err, "accunet_hanc_mix")
    hanc_mix.launches += 1
    return y


hanc_mix.launches = 0
