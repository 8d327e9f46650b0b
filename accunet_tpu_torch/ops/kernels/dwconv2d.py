"""Depthwise conv2d with a hand-written weight gradient, NHWC.

Counterpart of accunet_tpu/ops/pallas/dwconv2d.py (`dwconv2d` and its custom
VJP `_fwd`/`_bwd`, :135-214):

  * forward: the grouped convolution (cuDNN here, XLA's grouped conv there,
    :149-150);
  * dx: the same convolution of the cotangent with the spatially flipped
    kernel (:187-188);
  * dw and db: `dwconv2d_wgrad`, which replaces the TPU kernel
    `_dwconv2d_wgrad_pallas` (:76, pallas_call :111) and returns the bias
    gradient (the cotangent summed over batch and space, :189) from the same
    pass over g.

The wgrad kernel (`csrc/dwconv2d_wgrad.cu`) is bound by bytes: it reads x and
g once from device memory (2*kh*kw flops per element pair). A CTA owns a block
of channels (128 bytes of a pixel) and an equal share of the map's rows; the
rows stream through a ring of shared-memory stages of kh rows, filled by
cp.async two stages ahead (on narrow maps they are read straight from device
memory), and each thread slides a kh x kw window of its channels down one
column, keeping the kh*kw (+1) sums in fp32 registers. The partials of a
channel block's CTAs are summed in CTA order by the last CTA to finish (one
launch, deterministic). `wgrad_plan` picks the blocks, the segments, the path
and the CTA count. JAX dispatched its Pallas kernel only from C >= 1024 on
(`_wgrad_pallas_ok`), a TPU measurement against XLA's per-tap form; here the
kernel runs for every width.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from accunet_tpu_torch.ops.kernels import _build

KERNEL_SIZES = (3, 5, 7)  # square, odd: the kernel's instantiations
_SMS, _CTAS_PER_SM = 132, 2  # the H100's SMs; the kernel's launch bounds allow 2 CTAs each
_THREADS = 256
_AHEAD = 2  # ring stages in flight beyond the one in use (csrc kWgAhead)


class WgradPlan(NamedTuple):
    """The kernel's launch: `cb` channels per CTA block (`blocks` of them),
    column segments of `sw` pixels, `ctas` CTAs per channel block sharing
    its `units` (image, segment, row) rows, `direct` for reads without the
    ring, `smem` bytes of shared memory per CTA; `vec` for 16-byte copies."""

    vec: bool
    cb: int
    sw: int
    ctas: int
    direct: bool
    blocks: int
    units: int
    smem: int


@functools.cache
def wgrad_plan(b: int, h: int, w: int, c: int, k: int, itemsize: int, vec: bool,
               cb: int | None = None, ctas: int | None = None,
               direct: bool | None = None) -> WgradPlan:
    """Split the work of one call (csrc/dwconv2d_wgrad.cu):
    * a channel block is 128 bytes of a pixel with 16-byte copies (32 fp32,
      64 bf16), 32 channels with element copies, fewer when C is smaller;
      each thread owns cv channels of it (4 at k=3, 2 at k=5, 1 at k=7) and
      one column of a segment, so a segment is at most 256 / (cb / cv)
      pixels wide (32 in fp32, 16 in bf16), the segments of a row as even as
      they go; a stage holds k rows of x and g; where a segment would leave
      half the threads idle the kernel skips the ring and reads x and g
      straight from device memory, two or more bands at a time;
    * the (image, segment, row) units of a channel block are shared out
      evenly over `ctas` CTAs: one wave of 2 CTAs for each of the 132 SMs,
      or about four where there are many channel blocks; the partial buffer,
      ctas x (k*k + 1) x C floats, stays near 4 x 264 x 128 bytes x (k*k + 1)
      whatever B*H*W is.
    `cb`, `ctas` and `direct` override the choice (tools/kernel_ab.py
    --sweep)."""
    cv = (4 if k == 3 else 2 if k == 5 else 1) if vec else 1
    per_copy = 16 // itemsize if vec else 1
    cb = cb or min((128 // itemsize) if vec else 32, -(-c // per_copy) * per_copy)
    if cb % per_copy or cb % cv or cb // cv > _THREADS:
        raise ValueError(f"channel block {cb} does not fit the kernel's copies and threads")
    lanes = _THREADS // (cb // cv)
    nseg = -(-w // lanes)
    sw = -(-w // nseg)
    if direct is None:
        # where a segment leaves half the threads idle (cnv51/52, 14x14 in
        # fp32) the kernel reads straight from device memory, the idle
        # threads walking other bands (tools/kernel_ab.py --sweep)
        direct = lanes // sw >= 2
    ring = 0 if direct else (_AHEAD + 1) * k * (2 * sw + k - 1) * cb * itemsize
    smem = max(ring, _THREADS * (k * k + 1) * cv * 4)
    blocks = -(-c // cb)
    units = b * nseg * h
    if not ctas:
        # one wave of 2 CTAs per SM; with more than a third of a wave of
        # channel blocks (cnv72's 136) about 4 waves, so that no SM runs two
        # of the last CTAs alone (tools/kernel_ab.py --sweep)
        slots = _CTAS_PER_SM * _SMS
        ctas = slots // blocks if blocks <= slots // 3 else round(4 * slots / blocks)
    ctas = max(1, min(units, ctas))
    return WgradPlan(vec, cb, sw, ctas, direct, blocks, units, smem)


# per (device, stream): the kernel's int32 counters, one per channel block;
# each launch leaves them at 0
_COUNTERS: dict[tuple[int, int], torch.Tensor] = {}


def _counters(device: torch.device, stream: int, n: int) -> torch.Tensor:
    key = (device.index, stream)
    buf = _COUNTERS.get(key)
    if buf is None or buf.numel() < n:
        buf = _COUNTERS[key] = torch.zeros(max(n, 256), dtype=torch.int32, device=device)
    return buf


def dwconv2d_wgrad_reference(x: torch.Tensor, g: torch.Tensor, kh: int, kw: int) -> torch.Tensor:
    """Plain PyTorch version, the per-tap form of JAX `_bwd` (:200-211):
    dw[i, j, c] = sum_{b,h,w} x_pad[b, h+i, w+j, c] * g[b, h, w, c], SAME
    padding, accumulated in fp32 (float64 stays float64). x, g (B, H, W, C)
    -> dw (kh, kw, C) fp32."""
    _, h, w, _ = x.shape
    ph, pw = (kh - 1) // 2, (kw - 1) // 2
    ct = torch.promote_types(x.dtype, torch.float32)
    xp = F.pad(x.to(ct), (0, 0, pw, kw - 1 - pw, ph, kh - 1 - ph))
    gf = g.to(ct)
    return torch.stack([
        torch.stack([torch.einsum("bhwc,bhwc->c", xp[:, i:i + h, j:j + w], gf)
                     for j in range(kw)])
        for i in range(kh)
    ])


def dwconv2d_wgrad(x: torch.Tensor, g: torch.Tensor, kh: int, kw: int,
                   bias_grad: bool = False, plan: WgradPlan | None = None):
    """Depthwise weight gradient. x, g (B, H, W, C) float32/bfloat16, NHWC
    contiguous, kh == kw in KERNEL_SIZES -> dw (kh, kw, C) float32, or with
    `bias_grad` (dw, db), db = g summed over (B, H, W) in float32. `plan`
    (CUDA only) overrides `wgrad_plan`'s split."""
    if x.device.type == "cpu":
        dw = dwconv2d_wgrad_reference(x, g, kh, kw)
        return (dw, g.to(dw.dtype).sum(dim=(0, 1, 2))) if bias_grad else dw
    if kh != kw or kh not in KERNEL_SIZES:
        raise ValueError(f"dwconv2d_wgrad kernel takes kh == kw in {KERNEL_SIZES}, got {kh}x{kw}")
    _build.require(x, "x")
    _build.require(g, "g", x.shape, x.dtype, x.device)
    b, h, w, c = x.shape
    vec = (c * x.element_size()) % 16 == 0 and x.data_ptr() % 16 == 0 and g.data_ptr() % 16 == 0
    plan = plan or wgrad_plan(b, h, w, c, kh, x.element_size(), vec)
    stream = _build.stream_of(g)
    # dw, then db, then the CTAs' partials, in one allocation
    taps = kh * kw * c
    n_part = plan.ctas * (kh * kw + 1) * c if plan.ctas > 1 else 0
    buf = torch.empty(taps + c + n_part, dtype=torch.float32, device=x.device)
    at = buf.data_ptr()
    err = _build.load_library().accunet_dwconv2d_wgrad(
        x.data_ptr(), g.data_ptr(), at + 4 * (taps + c) if n_part else 0,
        _counters(x.device, stream, plan.blocks).data_ptr() if n_part else 0,
        at, at + 4 * taps if bias_grad else 0,
        b, h, w, c, kh, plan.cb, plan.sw, plan.ctas, int(plan.direct), int(plan.vec),
        _build.dtype_code(x),
        stream,
    )
    _build.check(err, "accunet_dwconv2d_wgrad")
    dwconv2d_wgrad.launches += 1
    dw = buf[:taps].view(kh, kw, c)
    return (dw, buf[taps:taps + c]) if bias_grad else dw


dwconv2d_wgrad.launches = 0


class DepthwiseConv2dFn(torch.autograd.Function):
    """y = depthwise SAME conv of x (B, H, W, C) with weight (C, 1, kh, kw)
    plus bias (C,) or None, in x's type (the weight and bias cast at use).
    The weight gradient is `dwconv2d_wgrad` (the kernel on a CUDA tensor,
    its plain version on a CPU tensor), fp32 from a bf16 x and g as out of
    the TPU kernel (:127); the bias gradient is rounded to g's type first,
    as in JAX."""

    @staticmethod
    def forward(ctx, x, weight, bias):
        kh, kw = weight.shape[2], weight.shape[3]
        if kh % 2 == 0 or kw % 2 == 0:
            raise ValueError(f"depthwise SAME conv takes odd kernels, got {kh}x{kw}")
        ctx.save_for_backward(x, weight)
        ctx.bias_dtype = None if bias is None else bias.dtype
        y = F.conv2d(x.permute(0, 3, 1, 2), weight.to(x.dtype),
                     None if bias is None else bias.to(x.dtype),
                     padding=((kh - 1) // 2, (kw - 1) // 2), groups=x.shape[-1])
        return y.permute(0, 2, 3, 1)

    @staticmethod
    def backward(ctx, g):
        x, weight = ctx.saved_tensors
        kh, kw = weight.shape[2], weight.shape[3]
        # a channels_last conv downstream may hand over g in another layout
        g = g.contiguous()
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            dx = F.conv2d(g.permute(0, 3, 1, 2), weight.flip(2, 3).to(g.dtype),
                          padding=((kh - 1) // 2, (kw - 1) // 2),
                          groups=g.shape[-1]).permute(0, 2, 3, 1)
        want_db = ctx.bias_dtype is not None and ctx.needs_input_grad[2]
        if ctx.needs_input_grad[1]:
            # the bias gradient comes from the same pass over g
            res = dwconv2d_wgrad(x.contiguous(), g, kh, kw, bias_grad=want_db)
            dw, db = res if want_db else (res, None)
            dw = dw.permute(2, 0, 1).unsqueeze(1).to(weight.dtype)
        elif want_db:
            db = g.sum(dim=(0, 1, 2))
        if db is not None:
            # rounded to the cotangent's type, as JAX's `_bwd` does (:189)
            db = db.to(g.dtype).to(ctx.bias_dtype)
        return dx, dw, db
