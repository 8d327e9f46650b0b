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
tile of 8x16 or 16x16 pixels, `TILES`). The tile's halo of x (after the `pre`
prologue) stays in shared memory; the loop walks E in K-chunks (16 channels
in fp32, 32 in bf16), so the E-wide interior never reaches device memory: per
chunk the expand on the halo runs on the tensor cores (mma.sync; 3xTF32 in
fp32, bf16 in bf16), its out-of-image pixels zeroed AFTER the activation
(SAME padding pads the activated map); the depthwise taps and the 2x2/4x4
avg/max pools run on the CUDA cores per channel and window; the 2k-1 mixes
accumulate on the tensor cores in registers, as in `hanc_mix`. The weight
chunks come by cp.async one chunk ahead. The epilogue telescopes the
upsample-adds, applies the residual, projects through w3 on the tensor cores
and reduces the tile's channel sums in a fixed order. What bounds it on the
card: the products (3xTF32 issues three per multiply-add); device-memory
traffic is one read of x and one write of y. In bf16 the wrapper rounds w1,
wd, wh and w3 to bf16, as JAX's wrapper does (`.astype(dt)`,
accunet_tpu/ops/pallas/hanc_block.py:430-433), and the kernel rounds the
interior to bf16 where JAX's kernel keeps it in bf16; `hanc_block_reference`
rounds at the same points.

`HancBlockFn` gives the kernel a gradient (Seg-Grad-CAM differentiates the
eval model): its backward is the VJP of `hanc_block_reference`, recomputed
from the saved inputs, the idiom of `HancMixFn`; the TPU package has no
backward kernel either.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from accunet_tpu_torch.ops.activation import lrelu
from accunet_tpu_torch.ops.kernels import _build
from accunet_tpu_torch.ops.kernels.hanc_mix import plain_vjp
from accunet_tpu_torch.ops.pooling import avg_pool2d, max_pool2d, upsample_nearest

MAX_CIN = 128  # widest nf == cin the kernel's tiles take
# the kernel's tiles: pixel rows, pixel columns, mix columns (nf <= it)
TILES = {1: (8, 16, 128), 2: (16, 16, 64), 3: (16, 16, 32)}


def _align16(n: int) -> int:
    return -(-n // 16) * 16


def _conflict_free_ld(n: int, m: int) -> int:
    return n + (8 - n % m) % m


def smem_bytes(tile: int, cin: int, cout: int, k: int, itemsize: int) -> tuple[int, int]:
    """(shared-memory bytes of a CTA, wh stages): the plan of csrc/hanc_block.cu
    `HbSmem`, which it mirrors."""
    th, tw, ncol = TILES[tile]
    kc, kstep, ldx, padw = (16, 8, 24, 4) if itemsize == 4 else (32, 16, 40, 8)
    p = th * tw
    nr = p + 2 * (p // 4 if k >= 2 else 0) + 2 * (p // 16 if k >= 3 else 0)
    hpr = -(-(th + 2) * (tw + 2) // 8) * 8
    cin_pad = -(-cin // kstep) * kstep
    xld = _conflict_free_ld(cin_pad, 32 if itemsize == 4 else 16)
    cout_pad = -(-cout // 16) * 16
    loop = _align16(hpr * xld * itemsize)
    wa = _align16(loop + hpr * (kc + 4) * 4 + nr * ldx * itemsize)
    wa_bytes = _align16(cin_pad * (kc + padw) * itemsize + 9 * kc * itemsize + 2 * kc * 4)
    wh = wa + 2 * wa_bytes
    wh_bytes = (2 * k - 1) * kc * (ncol + padw) * itemsize
    r_end = loop + nr * (ncol + 4) * 4
    z_end = r_end if itemsize == 4 else r_end + p * _conflict_free_ld(cin_pad, 16) * itemsize
    epilogue = _align16(z_end) + 8 * cout_pad * 4
    nwh = 2 if wh + 2 * wh_bytes <= _build.MAX_SMEM and epilogue <= _build.MAX_SMEM else 1
    return max(wh + nwh * wh_bytes, epilogue), nwh


def pick_tile(cin: int) -> int:
    """The tile for nf == cin: the narrowest mix columns that hold nf, on
    16x16 pixels where they fit (nf <= 64; an 8x16 x 64 tile lost to them at
    every shape of tools/kernel_ab.py --sweep on the H100, in fp32 and
    bf16, and was dropped)."""
    if cin <= 32:
        return 3
    if cin <= 64:
        return 2
    return 1


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
    x.dtype, sums (B,1,cout) fp32). fp32 inside like the kernel; for bf16 x
    also the kernel's bf16 operands and rounding points: w1, wd, wh and w3
    rounded to bf16, and the interior rounded after the prologue, the
    expand's activation, the depthwise activation, each avg pool, the hanc
    lrelu, z and y (JAX's kernel keeps these in bf16)."""
    low = x.dtype == torch.bfloat16

    def rnd(t):
        return t.to(torch.bfloat16).float() if low else t

    w1, wd, wh, w3 = (rnd(t) for t in (p.w1, p.wd, p.wh, p.w3))
    xf = x.float()
    if pre is not None:
        pre = pre.float()
        xf = rnd(lrelu(xf * pre[:, 0, None, None, :] + pre[:, 1, None, None, :]))
    u = rnd(lrelu(xf @ w1 + p.t1))
    _, h, w, _ = u.shape
    up = F.pad(u, (0, 0, 1, 1, 1, 1))
    acc = None
    for t in range(9):
        dy, dx = divmod(t, 3)
        term = up[:, dy:dy + h, dx:dx + w, :] * wd[t]
        acc = term if acc is None else acc + term
    d = rnd(lrelu(acc + p.t2))
    # the HANC pyramid and its mixes, telescoped coarsest-first (hanc_mix_reference)
    avg_maps, max_maps = [], []
    a = m = d
    for _ in range(1, k):
        a = rnd(avg_pool2d(a, 2))
        m = max_pool2d(m, 2)
        avg_maps.append(a)
        max_maps.append(m)
    tele = None
    for i in range(k - 1, 0, -1):
        term = avg_maps[i - 1] @ wh[i] + max_maps[i - 1] @ wh[k - 1 + i]
        tele = term if tele is None else term + upsample_nearest(tele, 2)
    mixed = d @ wh[0]
    if tele is not None:
        mixed = mixed + upsample_nearest(tele, 2)
    z = rnd((rnd(lrelu(mixed + p.th)) + xf) * p.sres + p.tres)
    y = lrelu(z @ w3 + p.t3).to(x.dtype)
    return y, y.float().sum(dim=(1, 2))[:, None, :]


def hanc_block(x: torch.Tensor, p: HANCBlockWeights, k: int,
               pre: torch.Tensor | None = None, tile: int = 0):
    """Fused HANCBlock body. Same arguments and results as
    `hanc_block_reference`, except that the sums are per pixel tile:
    (B, T, cout) — consumers reduce over dim 1. Needs nf == cin <= 128,
    k in {1,2,3}, H and W divisible by 2^(k-1). `tile` (CUDA only): 0 picks
    the kernel's tile by nf (`pick_tile`), a key of `TILES` forces
    that tile (if it holds nf)."""
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
    tile = tile or pick_tile(cin)
    if tile not in TILES or TILES[tile][2] < nf:
        raise ValueError(f"tile {tile} is not one of {sorted(TILES)} or is narrower than {nf}")
    if smem_bytes(tile, cin, cout, k, x.element_size())[0] > _build.MAX_SMEM:
        raise ValueError(f"hanc_block tile {tile} needs more shared memory at cout {cout}")
    dev = x.device
    _build.require(x, "x")
    shapes = dict(w1=(cin, e), t1=(e,), wd=(9, e), t2=(e,), wh=(2 * k - 1, e, nf),
                  th=(nf,), sres=(nf,), tres=(nf,), w3=(nf, cout), t3=(cout,))
    weights = []
    for name in HANCBlockWeights._fields:
        t = getattr(p, name)
        _build.require(t, name, shapes[name], torch.float32, dev)
        # the products' weights in the input type (bf16: rounded, as JAX does)
        weights.append(t.to(x.dtype) if name in ("w1", "wd", "wh", "w3") else t)
    if pre is not None:
        _build.require(pre, "pre", (b, 2, cin), torch.float32, dev)
    th_, tw_, _ = TILES[tile]
    n_tiles = -(-h // th_) * -(-wd // tw_)
    y = torch.empty((b, h, wd, cout), dtype=x.dtype, device=dev)
    sums = torch.empty((b, n_tiles, cout), dtype=torch.float32, device=dev)
    err = _build.load_library().accunet_hanc_block(
        x.data_ptr(), 0 if pre is None else pre.data_ptr(),
        *(t.data_ptr() for t in weights), y.data_ptr(), sums.data_ptr(),
        b, h, wd, cin, e, nf, cout, k, tile, _build.dtype_code(x), _build.stream_of(x),
    )
    _build.check(err, "accunet_hanc_block")
    hanc_block.launches += 1
    return y, sums


hanc_block.launches = 0


class HancBlockFn(torch.autograd.Function):
    """`hanc_block` with a gradient: apply(x, pre, k, *weights) with
    `weights` the ten tensors of a HANCBlockWeights -> (y, sums (B, cout)),
    the per-tile sums already reduced over the tiles. Forward: the kernel on
    a CUDA tensor, the plain version on a CPU tensor. Backward: the VJP of
    the plain version (x, the chained `pre` and the folded weights),
    recomputed from the saved inputs."""

    @staticmethod
    def forward(ctx, x, pre, k, *weights):
        ctx.save_for_backward(x, pre, *weights)
        ctx.k = k
        y, sums = hanc_block(x, HANCBlockWeights(*weights), k, pre)
        return y, sums.sum(dim=1)

    @staticmethod
    def backward(ctx, gy, gs):
        def plain(x, pre, *weights):
            y, sums = hanc_block_reference(x, HANCBlockWeights(*weights), ctx.k, pre)
            return y, sums[:, 0]

        x_grad, pre_grad, *w_grads = plain_vjp(
            plain, ctx.saved_tensors, ctx.needs_input_grad[:2] + ctx.needs_input_grad[3:],
            (gy, gs))
        return x_grad, pre_grad, None, *w_grads
