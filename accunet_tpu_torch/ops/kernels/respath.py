"""One ResPath level:

    x_i = x_{i-1} + lrelu((y_{i-1} * g) * s_se + t_se)     (level > 0)
    y_i = lrelu(conv3x3(x_i) * s_bn + t_bn)                 (conv bias in t_bn)

plus fp32 per-tile channel sums of y_i for the next SE gate; the gate MLP
stays outside (nn/acc_blocks.py ResPath).

Replaces the TPU kernel `respath_level_frame` (accunet_tpu/ops/pallas/
respath.py:72, body `_kernel` :31-69), which ran a level as one pass over the
s2d frame with a packed 4Cx4C kernel.

Kernel (`csrc/respath_level.cu`): plain NHWC, no frame. The conv is an
implicit GEMM on the tensor cores through mma.sync (M = 16 pixels of a tile
row, N = 8 output channels, K = tap by tap over the input channels; 3xTF32
in fp32 with each 16-deep K-chunk's sum added to the accumulator in fp32,
bf16 in bf16). A persistent CTA walks tiles of 8x16 or 16x16 pixels with 32
or 64 output channels (`PLANS`); per tile it forms the halo of x_i once in
shared memory, K_MAX input channels at a time (the SE apply and residual of
the previous level, then the SAME zeroing), writing the tile's x_i from the
same pass; the 3x3 weights stay in shared memory for the CTA's life
(resident, C <= K_MAX) or stream tap by tap and K block by K block through a
cp.async ring (streamed, any C). The epilogue applies BN + lrelu to the fragments,
writes y_i and reduces the tile's channel sums in a fixed order (no atomics,
so the sums are deterministic). What bounds it on the card: in fp32 the
bytes (one read of x and y_{i-1}, one write of x_i and y_i) and the 3xTF32
products about equally, in bf16 the bytes. In bf16 the weights, gate, s_se
and t_se are rounded to bf16 (JAX's kernel casts them), x_i is bf16 and
y_i = lrelu(bf16(acc*s_bn + t_bn)), as in JAX; `respath_level_reference`
rounds at the same points. `RespathLevelFn` gives the kernel a gradient:
the VJP of the plain version, recomputed from the saved inputs (as
`HancBlockFn`).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from accunet_tpu_torch.ops.activation import lrelu
from accunet_tpu_torch.ops.kernels import _build
from accunet_tpu_torch.ops.kernels.hanc_mix import plain_vjp

K_MAX = 128  # input channels in one K block; the resident plans need C <= K_MAX
# the kernel's plans: pixel rows of the tile (16 columns), output channels a
# CTA owns, weights streamed (else resident for the CTA's life)
PLANS = {1: (8, 64, False), 2: (16, 32, False), 3: (8, 64, True)}
# the plans built for each type (by itemsize): those pick_plan picks
BUILT = {4: (2, 3), 2: (1, 2, 3)}
TILE_W = 16


def _conflict_free_ld(n: int, m: int) -> int:
    return n + (8 - n % m) % m


def smem_bytes(plan: int, c: int, itemsize: int) -> int:
    """Shared-memory bytes of a CTA: the plan of csrc/respath_level.cu
    `RpSmem`, which it mirrors."""
    th, ncol, stream = PLANS[plan]
    wm = 8 if ncol == 32 else 4
    kpad = min(-(-c // 16) * 16, K_MAX)
    ld = _conflict_free_ld(kpad, 32 if itemsize == 4 else 16)
    hpr = -(-(th + 2) * (TILE_W + 2) // 8) * 8
    align = lambda n: -(-n // 16) * 16  # noqa: E731
    return align((2 if stream else 9) * ncol * ld * itemsize) + align(hpr * ld * itemsize) \
        + wm * ncol * 4


def fits(plan: int, c: int, itemsize: int) -> bool:
    """Whether the kernel is built with `plan` for the type and takes C."""
    return plan in BUILT[itemsize] and (PLANS[plan][2] or c <= K_MAX) \
        and smem_bytes(plan, c, itemsize) <= _build.MAX_SMEM


def pick_plan(c: int, itemsize: int) -> int:
    """The plan for C channels, from the sweep of tools/kernel_ab.py on the
    H100 (PERF.md §6): 16x16 resident up to C 32; above, 8x16 with the
    weights resident in bf16 (two CTAs an SM) and streamed in fp32 (where
    the resident nine taps leave room for one CTA only, and for C > 64);
    streamed in both above K_MAX."""
    if c <= 32:
        return 2
    return 1 if itemsize == 2 and c <= K_MAX else 3


def respath_level_reference(x, w, s_bn, t_bn, y_prev=None, gate=None,
                            s_se=None, t_se=None):
    """Plain PyTorch version. x, y_prev (B,H,W,C); w (3,3,C,C) HWIO fp32;
    s_bn/t_bn/s_se/t_se (C,) fp32; gate (B,C) fp32.
    Returns (y_i, x_i, sums (B,1,C) fp32); fp32 inside like the kernel. For
    bf16 x also the kernel's bf16 operands and rounding points (JAX's
    kernel's): w, gate, s_se and t_se rounded to bf16, x_i rounded to bf16,
    y_i = lrelu(bf16(acc * s_bn + t_bn))."""
    low = x.dtype == torch.bfloat16

    def rnd(t):
        return t.to(torch.bfloat16).float() if low else t.float()

    xf = x.float()
    if y_prev is not None:
        se = (y_prev.float() * rnd(gate)[:, None, None, :]) * rnd(s_se) + rnd(t_se)
        xf = rnd(xf + lrelu(se))
    acc = F.conv2d(xf.permute(0, 3, 1, 2), rnd(w).permute(3, 2, 0, 1), padding=1)
    pre = acc.permute(0, 2, 3, 1) * s_bn.float() + t_bn.float()
    y = lrelu(pre.to(x.dtype)) if low else lrelu(pre).to(x.dtype)
    x_new = xf.to(x.dtype) if y_prev is not None else x
    return y, x_new, y.float().sum(dim=(1, 2))[:, None, :]


def respath_level(x, w, s_bn, t_bn, y_prev=None, gate=None, s_se=None, t_se=None):
    """Fused ResPath level. Same arguments and results as
    `respath_level_reference`, except that the sums are per pixel tile:
    (B, T, C) — consumers reduce over dim 1."""
    if x.device.type == "cpu":
        return respath_level_reference(x, w, s_bn, t_bn, y_prev, gate, s_se, t_se)
    return _launch(x, w, s_bn, t_bn, y_prev, gate, s_se, t_se,
                   plan=pick_plan(x.shape[-1], x.element_size()))


def _launch(x, w, s_bn, t_bn, y_prev=None, gate=None, s_se=None, t_se=None, *, plan):
    """The kernel in plan `plan` (the card tests and tools/kernel_ab.py's
    sweep force one here)."""
    b, h, wd, c = x.shape
    dev = x.device
    _build.require(x, "x")
    if not fits(plan, c, x.element_size()):
        raise ValueError(f"plan {plan} is not built for {x.dtype} or does not fit at C {c}")
    # the products' weights in the input type (bf16: rounded, as JAX does),
    # [tap][out][in]
    wk = w.to(x.dtype).transpose(2, 3).contiguous()
    f32 = [t.float().contiguous() for t in (s_bn, t_bn)]
    _build.require(wk, "w", (3, 3, c, c), device=dev)
    _build.require(f32[0], "s_bn", (c,), device=dev)
    _build.require(f32[1], "t_bn", (c,), device=dev)
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
    n_tiles = -(-h // PLANS[plan][0]) * -(-wd // TILE_W)
    y = torch.empty_like(x)
    sums = torch.empty((b, n_tiles, c), dtype=torch.float32, device=dev)
    err = _build.load_library().accunet_respath_level(
        x.data_ptr(), *ptrs, wk.data_ptr(), *(t.data_ptr() for t in f32),
        y.data_ptr(), x_new.data_ptr() if has_prev else 0, sums.data_ptr(),
        b, h, wd, c, int(has_prev), plan, _build.dtype_code(x), _build.stream_of(x),
    )
    _build.check(err, "accunet_respath_level")
    respath_level.launches += 1
    return y, x_new, sums


respath_level.launches = 0


class RespathLevelFn(torch.autograd.Function):
    """`respath_level` with a gradient: apply(x, w, s_bn, t_bn, y_prev,
    gate, s_se, t_se) -> (y_i, x_i, sums (B, C)), the per-tile sums already
    reduced over the tiles (x_i is x itself at level 0). Forward: the kernel
    on a CUDA tensor, the plain version on a CPU tensor. Backward: the VJP of
    the plain version with respect to every tensor input, recomputed from the
    saved inputs."""

    @staticmethod
    def forward(ctx, x, w, s_bn, t_bn, y_prev=None, gate=None, s_se=None, t_se=None):
        args = (x, w, s_bn, t_bn, y_prev, gate, s_se, t_se)
        ctx.save_for_backward(*args)
        y, x_new, sums = respath_level(*args)
        return y, x_new, sums.sum(dim=1)

    @staticmethod
    def backward(ctx, gy, gx, gs):
        def plain(*args):
            y, x_new, sums = respath_level_reference(*args)
            return y, x_new, sums[:, 0]

        return tuple(plain_vjp(plain, ctx.saved_tensors, ctx.needs_input_grad, (gy, gx, gs)))
