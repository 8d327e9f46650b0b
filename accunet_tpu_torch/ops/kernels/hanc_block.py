"""Whole HANCBlock inference body before the SE, with every BatchNorm folded:

    u = lrelu(x@w1 + t1)                         expand (BN1 scale in w1)
    d = lrelu(dw3x3(zero-pad(u)) + t2)           depthwise (BN2 scale in wd)
    h = HANC pyramid + (2k-1) mixes, telescoped  (hnc BN scale in wh)
    z = (lrelu(h + th) + x) * sres + tres        residual + 'norm' BN
    y = lrelu(z@w3 + t3)                         project (BN3 scale in w3)

plus fp32 per-tile channel sums of y, so the SE squeeze never re-reads y.
With `pre` (B, 2, cin) = [gate*se_scale, se_shift] the input is first put
through the previous block's SE apply, lrelu(x*gs + tb) (a chained pair).

Replaces the TPU kernel `hanc_block_frame` (accunet_tpu/ops/pallas/
hanc_block.py:335; bodies `_kernel`/`_kernel_one` :53-254 and the chained
`_kernel_parts` :82), which ran the body over the s2d frame with the E-wide
interior held in VMEM.

Kernel (`csrc/hanc_block.cu`): plain NHWC, no frame. One CTA per (image,
8x8-pixel tile). The tile's 10x10 halo of x (after the `pre` prologue) stays
in shared memory; the loop walks E in 16-channel chunks, so the E-wide
interior never has to fit: per chunk it recomputes the expand on the halo
(zeroing out-of-image halo pixels AFTER the activation — SAME padding pads
the activated map), runs the depthwise taps and the 2x2/4x4 avg/max pools,
and accumulates the 2k-1 mixes into fp32 registers. The epilogue telescopes
the upsample-adds, applies the residual, projects through w3 and reduces the
tile's channel sums in a fixed order. What bounds it on the card: fp32 FMAs
on CUDA cores fed from shared memory, and the 1.56x halo recompute of the
expand; device-memory traffic is one read of x and one write of y, against
seven round-trips of the E-wide interior for the unfused block.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from accunet_tpu_torch.ops.activation import lrelu
from accunet_tpu_torch.ops.kernels import _build
from accunet_tpu_torch.ops.kernels.hanc_mix import hanc_mix_reference

TILE = 8
MAX_CIN = 128  # widest nf == cin the kernel instantiates (csrc dispatch_nj)


class HANCBlockWeights(NamedTuple):
    """Folded HANCBlock weights, all fp32: w1 (cin,E), t1 (E), wd (9,E),
    t2 (E), wh (2k-1,E,nf), th/sres/tres (nf), w3 (nf,cout), t3 (cout)."""

    w1: torch.Tensor
    t1: torch.Tensor
    wd: torch.Tensor
    t2: torch.Tensor
    wh: torch.Tensor
    th: torch.Tensor
    sres: torch.Tensor
    tres: torch.Tensor
    w3: torch.Tensor
    t3: torch.Tensor


def fold(w1, b1, wd, bd, wh, bh, w3, b3, bns) -> HANCBlockWeights:
    """Fold the BN affines into the block's weights, as the TPU kernel's
    wrapper does (accunet_tpu/ops/pallas/hanc_block.py:409-433).

    w1 (cin,E), wd (3,3,E), wh (E,2k-1,nf), w3 (nf,cout); b* the conv biases;
    bns maps 'norm1','norm2','hnc','norm','norm3' to inference (scale, shift)
    pairs. Conv biases go into the following BN's shift, BN scales into the
    weights (in fp32)."""

    def affine(name, bias):
        s, t = (v.float() for v in bns[name])
        if bias is not None:
            t = t + bias.float() * s
        return s, t

    s1, t1 = affine("norm1", b1)
    s2, t2 = affine("norm2", bd)
    sh, th = affine("hnc", bh)
    sres, tres = affine("norm", None)
    s3, t3 = affine("norm3", b3)
    e = w1.shape[1]
    folded = HANCBlockWeights(
        w1=w1.float() * s1,
        t1=t1,
        wd=wd.float().reshape(9, e) * s2,
        t2=t2,
        wh=(wh.float() * sh).permute(1, 0, 2),
        th=th,
        sres=sres,
        tres=tres,
        w3=w3.float() * s3,
        t3=t3,
    )
    return HANCBlockWeights(*(t.contiguous() for t in folded))


def hanc_block_reference(x: torch.Tensor, p: HANCBlockWeights, k: int,
                         pre: torch.Tensor | None = None):
    """Plain PyTorch version. x (B,H,W,cin); returns (y (B,H,W,cout) in
    x.dtype, sums (B,1,cout) fp32). fp32 inside like the kernel."""
    xf = x.float()
    if pre is not None:
        pre = pre.float()
        xf = lrelu(xf * pre[:, 0, None, None, :] + pre[:, 1, None, None, :])
    u = lrelu(xf @ p.w1 + p.t1)
    _, h, w, _ = u.shape
    up = F.pad(u, (0, 0, 1, 1, 1, 1))
    acc = None
    for t in range(9):
        dy, dx = divmod(t, 3)
        term = up[:, dy:dy + h, dx:dx + w, :] * p.wd[t]
        acc = term if acc is None else acc + term
    d = lrelu(acc + p.t2)
    mixed = hanc_mix_reference(d, p.wh.permute(1, 0, 2), torch.zeros_like(p.th), k)
    z = (lrelu(mixed + p.th) + xf) * p.sres + p.tres
    y = lrelu(z @ p.w3 + p.t3).to(x.dtype)
    return y, y.float().sum(dim=(1, 2))[:, None, :]


def hanc_block(x: torch.Tensor, p: HANCBlockWeights, k: int,
               pre: torch.Tensor | None = None):
    """Fused HANCBlock body. Same arguments and results as
    `hanc_block_reference`, except that the sums are per 8x8 tile:
    (B, T, cout) — consumers reduce over dim 1. Needs nf == cin <= 128,
    k in {1,2,3}, H and W divisible by 2^(k-1)."""
    if x.device.type == "cpu":
        return hanc_block_reference(x, p, k, pre)
    b, h, wd, cin = x.shape
    e, nf, cout = p.w1.shape[1], p.w3.shape[0], p.w3.shape[1]
    if k not in (1, 2, 3):
        raise ValueError(f"hanc_block kernel takes k in (1, 2, 3), got {k}")
    if h % 2 ** (k - 1) or wd % 2 ** (k - 1):
        raise ValueError(f"spatial dims {h}x{wd} not divisible by {2 ** (k - 1)}")
    if nf != cin or nf > MAX_CIN:
        raise ValueError(f"hanc_block kernel needs nf == cin <= {MAX_CIN}, got {nf}, {cin}")
    dev = x.device
    _build.require(x, "x")
    shapes = dict(w1=(cin, e), t1=(e,), wd=(9, e), t2=(e,), wh=(2 * k - 1, e, nf),
                  th=(nf,), sres=(nf,), tres=(nf,), w3=(nf, cout), t3=(cout,))
    weights = []
    for name in HANCBlockWeights._fields:
        t = getattr(p, name)
        _build.require(t, name, shapes[name], torch.float32, dev)
        weights.append(t)
    if pre is not None:
        _build.require(pre, "pre", (b, 2, cin), torch.float32, dev)
    n_tiles = -(-h // TILE) * -(-wd // TILE)
    y = torch.empty((b, h, wd, cout), dtype=x.dtype, device=dev)
    sums = torch.empty((b, n_tiles, cout), dtype=torch.float32, device=dev)
    err = _build.load_library().accunet_hanc_block(
        x.data_ptr(), 0 if pre is None else pre.data_ptr(),
        *(t.data_ptr() for t in weights), y.data_ptr(), sums.data_ptr(),
        b, h, wd, cin, e, nf, cout, k, _build.dtype_code(x), _build.stream_of(x),
    )
    _build.check(err, "accunet_hanc_block")
    hanc_block.launches += 1
    return y, sums


hanc_block.launches = 0
