"""Depthwise conv2d with a hand-written weight gradient, NHWC.

Counterpart of accunet_tpu/ops/pallas/dwconv2d.py (`dwconv2d` and its custom
VJP `_fwd`/`_bwd`, :135-214):

  * forward: the grouped convolution (cuDNN here, XLA's grouped conv there,
    :149-150);
  * dx: the same convolution of the cotangent with the spatially flipped
    kernel (:187-188);
  * db: the cotangent summed over batch and space;
  * dw: `dwconv2d_wgrad`, which replaces the TPU kernel
    `_dwconv2d_wgrad_pallas` (:76, pallas_call :111).

The wgrad kernel (`csrc/dwconv2d_wgrad.cu`) is bound by bytes: it reads x and
g once from device memory (2*kh*kw flops per element pair). One CTA takes 32
channels (one per lane, coalesced) and a range of image rows; a warp sweeps a
row keeping the kh x kw window of x and the kh*kw sums in fp32 registers, the
CTA writes one partial per tap and channel, and a second pass sums the
partials in a fixed order (no atomics: deterministic). JAX dispatched its
Pallas kernel only from C >= 1024 on (`_wgrad_pallas_ok`), a TPU measurement
against XLA's per-tap form; here the kernel runs for every width.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from accunet_tpu_torch.ops.kernels import _build

KERNEL_SIZES = (3, 5, 7)  # square, odd: the kernel's instantiations
_CHANNELS_PER_CTA = 32
_ROWS_PER_WARP_PASS = 8  # a CTA's warps take 8 neighbouring rows at a time
_TARGET_CTAS = 8 * 132  # eight CTAs on each of the H100's 132 SMs


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


def row_split(rows: int, c: int) -> tuple[int, int]:
    """(row ranges, rows per range) for the kernel's first pass: enough CTAs
    to fill the card, at most one range per 8 rows, and no more ranges than
    the target CTA count allows per channel block, so the (ranges, kh*kw, C)
    partial buffer stays near _TARGET_CTAS * 32 * kh*kw floats whatever
    B*H*W is."""
    blocks = -(-c // _CHANNELS_PER_CTA)
    ranges = max(1, min(-(-rows // _ROWS_PER_WARP_PASS), -(-_TARGET_CTAS // blocks)))
    per = -(-rows // ranges)
    return -(-rows // per), per


def dwconv2d_wgrad(x: torch.Tensor, g: torch.Tensor, kh: int, kw: int) -> torch.Tensor:
    """Depthwise weight gradient. x, g (B, H, W, C) float32/bfloat16, NHWC
    contiguous, kh == kw in KERNEL_SIZES -> dw (kh, kw, C) float32."""
    if x.device.type == "cpu":
        return dwconv2d_wgrad_reference(x, g, kh, kw)
    if kh != kw or kh not in KERNEL_SIZES:
        raise ValueError(f"dwconv2d_wgrad kernel takes kh == kw in {KERNEL_SIZES}, got {kh}x{kw}")
    _build.require(x, "x")
    _build.require(g, "g", x.shape, x.dtype, x.device)
    b, h, w, c = x.shape
    ranges, per = row_split(b * h, c)
    part = torch.empty((ranges, kh * kw, c), dtype=torch.float32, device=x.device)
    dw = torch.empty((kh, kw, c), dtype=torch.float32, device=x.device)
    err = _build.load_library().accunet_dwconv2d_wgrad(
        x.data_ptr(), g.data_ptr(), part.data_ptr(), dw.data_ptr(),
        b, h, w, c, kh, kw, ranges, per, _build.dtype_code(x), _build.stream_of(g),
    )
    _build.check(err, "accunet_dwconv2d_wgrad")
    dwconv2d_wgrad.launches += 1
    return dw


dwconv2d_wgrad.launches = 0


class DepthwiseConv2dFn(torch.autograd.Function):
    """y = depthwise SAME conv of x (B, H, W, C) with weight (C, 1, kh, kw)
    plus bias (C,) or None. The weight gradient is `dwconv2d_wgrad` (the
    kernel on a CUDA tensor, its plain version on a CPU tensor)."""

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
        if ctx.needs_input_grad[1]:
            dw = dwconv2d_wgrad(x.contiguous(), g, kh, kw)
            dw = dw.permute(2, 0, 1).unsqueeze(1).to(weight.dtype)
        if ctx.bias_dtype is not None and ctx.needs_input_grad[2]:
            db = g.sum(dim=(0, 1, 2)).to(ctx.bias_dtype)
        return dx, dw, db
