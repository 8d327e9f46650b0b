"""Hybrid HANCBlock front half, NHWC:

    u = lrelu((x@w1 + b1) * s1 + t1)                 1x1 expand + BN1
    y = lrelu((dw3x3(zero-pad(u)) + bd) * s2 + t2)   SAME depthwise + BN2

the part of an unfused HANCBlock before its HANC mix (nn/acc_blocks.py
`HANCBlock(hybrid=True)`); the mix and the block's tail stay outside.

Replaces the TPU kernel `expand_dw_nhwc` (accunet_tpu/ops/pallas/
expand_dw.py:77, body `_kernel` :29-55, pallas_call :102), which ran a
(batch, row block) grid with two-block halo staging in VMEM.

Kernel (`csrc/expand_dw.cu`): hanc_block's front half with y as the
output. A CTA owns one tile of 8x16 pixels and a group of chunks of E (64
channels in fp32, 32 in bf16); the tile's halo of x comes in once (cp.async)
and stays in shared memory while the CTA walks its chunks (`PLANS`; where
the whole halo does not fit, a second plan stages it 64 channels at a time
for each chunk). Per chunk the expand
runs on the halo on the tensor cores (mma.sync: 3xTF32 in fp32, each 16-deep
K-chunk's sum added in fp32; bf16 in bf16), then BN1 and lrelu, with
out-of-image halo pixels set to 0 AFTER the activation (SAME padding pads
the activated map); the nine taps, BN2 and lrelu run on the CUDA cores, a
3x3 window sliding in registers, and y leaves as 4-channel vectors with
consecutive threads on consecutive channels. The next chunk's weights come
by cp.async during the taps. What bounds it on the card: in fp32 the
expand's 3xTF32 products and the store of the E-wide y, in bf16 the bytes.
In bf16 w1 and wd are rounded to bf16 (JAX's kernel casts them), the
expand's product is rounded to bf16 before BN1, u is bf16 and y =
bf16(lrelu(acc*s2 + t2)); `expand_dw_plain` rounds at the same points.
`ExpandDwFn` gives the kernel a gradient: the VJP of `expand_dw_plain`,
recomputed from the saved inputs (as `HancBlockFn`).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from accunet_tpu_torch.ops.activation import lrelu
from accunet_tpu_torch.ops.kernels import _build
from accunet_tpu_torch.ops.kernels.hanc_mix import plain_vjp


# the kernel's plans: the 8x16 tile's x halo resident for the CTA's life, or
# staged 64 channels at a time for each chunk of E
PLANS = {1: "resident", 2: "staged"}
TILE = (8, 16)
STAGED_K = 64


def chunk(itemsize: int) -> int:
    """The E channels a CTA expands at a time: 64 in fp32, 32 in bf16."""
    return 64 if itemsize == 4 else 32


def _align16(n: int) -> int:
    return -(-n // 16) * 16


def smem_bytes(plan: int, cin: int, itemsize: int) -> int:
    """Shared-memory bytes of a CTA: the plan of csrc/expand_dw.cu `EdSmem`,
    which it mirrors."""
    resident = PLANS[plan] == "resident"
    hpr = -(-(TILE[0] + 2) * (TILE[1] + 2) // 8) * 8
    kdim = -(-cin // 16) * 16 if resident else STAGED_K
    m = 32 if itemsize == 4 else 16
    xld = kdim + (8 - kdim % m) % m
    ec = chunk(itemsize)
    w1ld = ec + (4 if itemsize == 4 else 8)
    wa = _align16(_align16(hpr * xld * itemsize) + hpr * (ec + 4) * 4)
    wa_bytes = _align16(_align16(kdim * w1ld * itemsize + 9 * ec * itemsize) + 4 * ec * 4)
    return wa + (2 if resident else 1) * wa_bytes


def pick_plan(cin: int, itemsize: int) -> int:
    """The plan for cin input channels: the resident halo where it fits,
    else the staged one (which fits at any cin)."""
    return 1 if smem_bytes(1, cin, itemsize) <= _build.MAX_SMEM else 2


def expand_dw_plain(x, w1, b1, wd, bd, bn1, bn2):
    """Plain PyTorch version. x (B,H,W,cin); w1 (cin,E); wd (3,3,E); b1, bd
    (E,) conv biases or None; bn1, bn2 inference (scale, shift) pairs of
    (E,). Computes in fp32 (float64 stays float64) and returns (B,H,W,E) in
    x.dtype; the taps sum in row-major order, as JAX's kernel does. For bf16
    x also the kernel's bf16 operands and rounding points (JAX's kernel's):
    w1 and wd rounded to bf16, the biases folded into the shifts, the
    expand's product rounded to bf16 before BN1, u rounded to bf16."""
    ct = torch.promote_types(x.dtype, torch.float32)
    (s1, t1), (s2, t2) = ((s.to(ct), t.to(ct)) for s, t in (bn1, bn2))
    low = x.dtype == torch.bfloat16

    def rnd(t):
        return t.to(torch.bfloat16).to(ct) if low else t

    if low:
        w1, wd = rnd(w1.to(ct)), rnd(wd.to(ct))
        if b1 is not None:
            t1, b1 = t1 + b1.to(ct) * s1, None
        if bd is not None:
            t2, bd = t2 + bd.to(ct) * s2, None
    y = rnd(x.to(ct) @ w1.to(ct))
    if b1 is not None:
        y = y + b1.to(ct)
    u = F.pad(rnd(lrelu(y * s1 + t1)), (0, 0, 1, 1, 1, 1))
    _, h, w, _ = x.shape
    wd = wd.to(ct)
    acc = None
    for dy in range(3):
        for dx in range(3):
            term = u[:, dy:dy + h, dx:dx + w, :] * wd[dy, dx]
            acc = term if acc is None else acc + term
    if bd is not None:
        acc = acc + bd.to(ct)
    return lrelu(acc * s2 + t2).to(x.dtype)


def expand_dw(x, w1, b1, wd, bd, bn1, bn2):
    """Fused front half. Same arguments and result as `expand_dw_plain`;
    x float32 or bfloat16, NHWC contiguous, any H, W, cin and E. The conv
    biases are folded into the BN shifts first (t + b*s), as the TPU
    kernel's wrapper does (accunet_tpu/ops/pallas/expand_dw.py:90-98)."""
    return _launch(x, w1, b1, wd, bd, bn1, bn2, plan=0)


def _launch(x, w1, b1, wd, bd, bn1, bn2, *, plan):
    """`expand_dw` with the kernel's plan: 0 picks it by cin and type
    (`pick_plan`), a key of `PLANS` forces it (the card tests and
    tools/kernel_ab.py's sweep)."""

    ct = torch.promote_types(x.dtype, torch.float32)

    def fold(pair, bias):
        s, t = (v.to(ct) for v in pair)
        return s, t if bias is None else t + bias.to(ct) * s

    (s1, t1), (s2, t2) = fold(bn1, b1), fold(bn2, bd)
    if x.device.type == "cpu":
        return expand_dw_plain(x, w1, None, wd, None, (s1, t1), (s2, t2))
    b, h, w, cin = x.shape
    e = w1.shape[1]
    _build.require(x, "x")
    dtype = _build.dtype_code(x)
    plan = plan or pick_plan(cin, x.element_size())
    if plan not in PLANS or smem_bytes(plan, cin, x.element_size()) > _build.MAX_SMEM:
        raise ValueError(f"plan {plan} is not one of {sorted(PLANS)} or does not fit at cin {cin}")
    # the products' weights in the input type (bf16: rounded, as JAX does)
    w1k = w1.to(x.dtype).contiguous()
    wdk = wd.to(x.dtype).reshape(9, e).contiguous()
    affe = torch.stack([s1, t1, s2, t2]).contiguous()
    _build.require(w1k, "w1", (cin, e), device=x.device)
    _build.require(wdk, "wd", (9, e), device=x.device)
    _build.require(affe, "bn", (4, e), device=x.device)
    y = torch.empty((b, h, w, e), dtype=x.dtype, device=x.device)
    err = _build.load_library().accunet_expand_dw(
        x.data_ptr(), w1k.data_ptr(), wdk.data_ptr(), affe.data_ptr(), y.data_ptr(),
        b, h, w, cin, e, plan, dtype, _build.stream_of(x),
    )
    _build.check(err, "accunet_expand_dw")
    expand_dw.launches += 1
    return y


expand_dw.launches = 0


class ExpandDwFn(torch.autograd.Function):
    """`expand_dw` with a gradient: apply(x, w1, b1, wd, bd, s1, t1, s2, t2),
    the BN pairs flattened (b1, bd may be None). Forward: the kernel on a
    CUDA tensor, the plain version on a CPU tensor. Backward: the VJP of
    `expand_dw_plain`, recomputed from the saved inputs."""

    @staticmethod
    def forward(ctx, x, w1, b1, wd, bd, s1, t1, s2, t2):
        ctx.save_for_backward(x, w1, b1, wd, bd, s1, t1, s2, t2)
        return expand_dw(x, w1, b1, wd, bd, (s1, t1), (s2, t2))

    @staticmethod
    def backward(ctx, gy):
        def plain(x, w1, b1, wd, bd, s1, t1, s2, t2):
            return expand_dw_plain(x, w1, b1, wd, bd, (s1, t1), (s2, t2))

        return tuple(plain_vjp(plain, ctx.saved_tensors, ctx.needs_input_grad, (gy,)))
