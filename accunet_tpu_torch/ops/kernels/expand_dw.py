"""Hybrid HANCBlock front half, NHWC:

    u = lrelu((x@w1 + b1) * s1 + t1)                 1x1 expand + BN1
    y = lrelu((dw3x3(zero-pad(u)) + bd) * s2 + t2)   SAME depthwise + BN2

the part of an unfused HANCBlock before its HANC mix (nn/acc_blocks.py
`HANCBlock(hybrid=True)`); the mix and the block's tail stay outside.

Replaces the TPU kernel `expand_dw_nhwc` (accunet_tpu/ops/pallas/
expand_dw.py:77, body `_kernel` :29-55, pallas_call :102), which ran a
(batch, row block) grid with two-block halo staging in VMEM.

Kernel (`csrc/expand_dw.cu`): one CTA per (image, 14x14-pixel tile, 64 of
the E channels). It expands the tile's 16x16 halo from x and w1 staged in
shared memory (a register-tiled fp32 product, 8 pixels x 8 channels a
thread), sets out-of-image halo pixels to 0 AFTER the activation (SAME
padding pads the activated map), then runs the nine taps per channel and
stores with consecutive threads on consecutive channels. What bounds it on
the card: fp32 FMAs on CUDA cores, 2*px*E*(cin+9) flops times the halo
recompute (1.31x on a 56x56 map, 1.56x on 128x128 with its ragged last
tiles); device-memory traffic is one read of x and one write of y, against
several round trips of the E-wide interior for the unfused ops.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from accunet_tpu_torch.ops.activation import lrelu
from accunet_tpu_torch.ops.kernels import _build


def expand_dw_plain(x, w1, b1, wd, bd, bn1, bn2):
    """Plain PyTorch version. x (B,H,W,cin); w1 (cin,E); wd (3,3,E); b1, bd
    (E,) conv biases or None; bn1, bn2 inference (scale, shift) pairs of
    (E,). Computes in fp32 (float64 stays float64) and returns (B,H,W,E) in
    x.dtype; the taps sum in row-major order, as JAX's kernel does."""
    ct = torch.promote_types(x.dtype, torch.float32)
    (s1, t1), (s2, t2) = ((s.to(ct), t.to(ct)) for s, t in (bn1, bn2))
    y = x.to(ct) @ w1.to(ct)
    if b1 is not None:
        y = y + b1.to(ct)
    u = F.pad(lrelu(y * s1 + t1), (0, 0, 1, 1, 1, 1))
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
    w1k = w1.float().contiguous()
    wdk = wd.float().reshape(9, e).contiguous()
    affe = torch.stack([s1, t1, s2, t2]).contiguous()
    _build.require(w1k, "w1", (cin, e), device=x.device)
    _build.require(wdk, "wd", (9, e), device=x.device)
    _build.require(affe, "bn", (4, e), device=x.device)
    y = torch.empty((b, h, w, e), dtype=x.dtype, device=x.device)
    err = _build.load_library().accunet_expand_dw(
        x.data_ptr(), w1k.data_ptr(), wdk.data_ptr(), affe.data_ptr(), y.data_ptr(),
        b, h, w, cin, e, dtype, _build.stream_of(x),
    )
    _build.check(err, "accunet_expand_dw")
    expand_dw.launches += 1
    return y


expand_dw.launches = 0
