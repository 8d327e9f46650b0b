"""HANC aggregation + 1x1 mix:

    y = x@w0 + sum_{i<k} up_{2^i}( avg_{2^i}(x)@w_i + max_{2^i}(x)@w_{k-1+i} ) + b

Replaces the TPU kernel `hanc_mix` (accunet_tpu/ops/pallas/hanc.py:154,
body `_kernel` :68-120), which ran the whole telescope per row tile in VMEM.

Kernel (`csrc/hanc_mix.cu`): a grouped GEMM on the tensor cores (mma.sync;
bf16 m16n8k16 in bf16, 3xTF32 m16n8k8 in fp32), one CTA per (image, pixel
tile of 128 or 256 pixels, 16-128 output channels). A ring of 3
shared-memory stages, filled by cp.async, holds the next K-chunks of x and of
the 2k-1 weight slabs; each K-chunk is pooled into the tile's avg/max pyramid
one iteration ahead of its products, with one barrier per chunk. The
upsample-adds telescope in the epilogue and y is written once. In bf16 the
wrapper rounds w to bf16, as JAX's kernel does (`w.astype(x.dtype)`). What
bounds it on the card: in fp32 the tensor cores at 3xTF32 (three products per
multiply-add), in bf16 the bytes of x; every CTA streams the weight of its
output columns from L2 once per pixel tile. `TILES` names the kernel's tiles;
`tile=0` picks one by the output width and type.
"""

from __future__ import annotations

import torch

from accunet_tpu_torch.ops.kernels import _build
from accunet_tpu_torch.ops.pooling import avg_pool2d, max_pool2d, upsample_nearest


def hanc_mix_reference(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                       k: int) -> torch.Tensor:
    """Plain PyTorch version: x (B,H,W,C), w (C, 2k-1, Cout), bias (Cout,).
    Accumulates in fp32 like the kernel (float64 stays float64); returns
    x.dtype."""
    ct = torch.promote_types(x.dtype, torch.float32)
    xf, wf = x.to(ct), w.to(ct)
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
    return (y + bias.to(ct)).to(x.dtype)


# the kernel's tiles: pixels (rows x columns) x output channels per CTA
TILES = {1: "8x16 x 128", 3: "8x16 x 32", 4: "8x16 x 16", 5: "16x16 x 64"}


def hanc_mix(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor, k: int,
             tile: int = 0) -> torch.Tensor:
    """HANC mix (pre-BN). x (B,H,W,C) float32/bfloat16, w (C, 2k-1, Cout),
    bias (Cout,); k in {2, 3}; H and W divisible by 2^(k-1). `tile` (CUDA
    only): 0 picks the kernel's tile by the output width and type, a key of
    `TILES` forces that tile (the tile sweep, tools/hanc_mix_sweep.py)."""
    if x.device.type == "cpu":
        return hanc_mix_reference(x, w, bias, k)
    b, h, wd, c = x.shape
    if k not in (2, 3):
        raise ValueError(f"hanc_mix kernel takes k in (2, 3), got {k}")
    if h % 2 ** (k - 1) or wd % 2 ** (k - 1):
        raise ValueError(f"spatial dims {h}x{wd} not divisible by {2 ** (k - 1)}")
    if tile and tile not in TILES:
        raise ValueError(f"tile {tile} is not one of {sorted(TILES)}")
    _build.require(x, "x")
    code = _build.dtype_code(x)
    cout = w.shape[-1]
    wk = w.to(x.dtype).contiguous()
    bk = bias.float().contiguous()
    _build.require(wk, "w", (c, 2 * k - 1, cout), device=x.device)
    _build.require(bk, "bias", (cout,), device=x.device)
    y = torch.empty((b, h, wd, cout), dtype=x.dtype, device=x.device)
    err = _build.load_library().accunet_hanc_mix(
        x.data_ptr(), wk.data_ptr(), bk.data_ptr(), y.data_ptr(),
        b, h, wd, c, cout, k, tile, code, _build.stream_of(x),
    )
    _build.check(err, "accunet_hanc_mix")
    hanc_mix.launches += 1
    return y


hanc_mix.launches = 0


class HancMixFn(torch.autograd.Function):
    """`hanc_mix` with a gradient. Forward: the kernel on a CUDA tensor, the
    plain version on a CPU tensor. Backward: the VJP of the plain formula,
    recomputed from the saved inputs, as JAX `_bwd` (hanc.py:183-186) does;
    the TPU package has no backward kernel either. From bf16 inputs the
    plain formula computes in fp32 and the gradients come back in the inputs'
    types (JAX's `_bwd` differentiates its formula in bf16)."""

    @staticmethod
    def forward(ctx, x, w, bias, k):
        ctx.save_for_backward(x, w, bias)
        ctx.k = k
        return hanc_mix(x, w, bias, k)

    @staticmethod
    def backward(ctx, g):
        grads = plain_vjp(lambda x, w, b: hanc_mix_reference(x, w, b, ctx.k),
                          ctx.saved_tensors, ctx.needs_input_grad[:3], (g,))
        return (*grads, None)


def plain_vjp(plain, saved, need, cotangents) -> list:
    """The backward of a kernel's autograd function: the VJP of its plain
    version `plain(*saved)` (a tensor or a tuple of them) with the given
    cotangents, recomputed from the saved inputs. A gradient for each saved
    input flagged in `need`; None for the others, for a None input and for
    an input that does not reach the outputs."""
    with torch.enable_grad():
        leaves = [t if t is None else t.detach().requires_grad_(n) for t, n in zip(saved, need)]
        outs = plain(*leaves)
        outs = outs if isinstance(outs, tuple) else (outs,)
        wanted = [t for t, n in zip(leaves, need) if n and t is not None]
        grads = iter(torch.autograd.grad(outs, wanted, cotangents, allow_unused=True))
    return [next(grads) if n and t is not None else None for t, n in zip(leaves, need)]
