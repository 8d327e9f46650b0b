#!/usr/bin/env python3
"""Time the redesigned kernels (dwconv2d_wgrad, hanc_block, respath_level,
expand_dw, the selective scan, the standalone linear scan) and the models
that run them, for one tree of the port.

    python tools/kernel_ab.py [--tag NAME] [--json PATH] [--iters N] [--only KERNEL ...]
                              [--sweep] [--graphs] [--models] [--segmamba] [--contig] [--rh]
                              [--knunet]

On one CUDA card, at chip_smoke.py's shapes (ACC_UNet, n_filts=32, b8
224x224; expand_dw also at ACC_UNet_W b2 512x512), in fp32 (TF32 off) and
bf16:
  * dwconv2d_wgrad at cnv12, cnv52, cnv61 and cnv72, at UNext b8
    224x224's ShiftedBlock maps (14x14x160, 7x7x256, 28x28x128) and at U-KAN
    b8 256x256's DWBnRelu maps (16x16x320, 8x8x512, 32x32x256): the kernel for dw alone
    and, where the tree's wrapper takes `bias_grad`, for dw and db; cuDNN's
    weight-only `aten.convolution_backward` on the same inputs; the error of
    dw against the plain version (max abs error / max |plain|);
  * hanc_block at cnv12, cnv22 (chained `pre`), cnv81 and cnv91: the kernel
    and its error against the plain version;
  * respath_level at rspth1 level 0, rspth1 level 1 and rspth2 level 1: the
    kernel, cuDNN's 3x3 conv alone on the same x (a part of the level) and
    the error of y against the plain version;
  * expand_dw at cnv72 of ACC_UNet b8 224x224 and of ACC_UNet_W b2 512x512
    (a seeded cnv72-shaped HANCBlock's weights): the kernel, the unfused
    front half it replaces (the block's `front_unfused`) and its error;
  * selective_scan at the four BiMamba stage shapes of Segmamba b8 224x224
    (B 8, L 112^2 / 4^i, D 96 * 2^i, N 16), the operands as BiMamba hands
    them (delta, B, C and z transposed views): the public `selective_scan`
    forward (the fused kernel, or in an older tree the glue around the
    linear_scan kernel) and its forward + backward through autograd, with
    the peak memory the forward + backward adds;
  * linear_scan, linear_scan_reverse and the staged kernel (nbuf 2 and 4)
    at LINEAR_SCAN (Segmamba b8 224x224's four stages, BASELINE config 5's
    (8, 3136, 768) and the seq=2 shards of stage 0 and of config 5), a in
    (0.2, 0.99) and b in (-0.5, 0.5) as bench.py draws them: each beside
    its plain version and its bytes bound (3 tensors forward, 5 reverse),
    with Mtok/s (B * L / time), the errors against the plain versions and
    whether the staged h equals linear_scan's bitwise; the kernel's symbols
    are the parent's too, so a parent tree on PYTHONPATH runs these rows;
  * with --knunet: selective_scan_fwd (no chunk states) and
    selective_scan_bwd (from the forward's chunk states) at KNUnet b8
    256x256's three SS2D shapes (D 512 / 256 / 128, L 256 / 1024 / 4096, N
    16, no z, D, bias and softplus on, contiguous operands as SS2D hands
    them), each beside its bytes bound;
  * with --sweep (this tree only): dwconv2d_wgrad at each of its shapes
    under other splits (channel block, CTAs per block: `wgrad_plan`'s
    overrides), hanc_block at each of its shapes in every tile that holds
    its width (`TILES`), respath_level and expand_dw at each of their shapes
    in every plan that fits (`PLANS`), the standalone scan's kernel at every
    ring of LINEAR_SCAN_RINGS (rows a slot, slots) through dma_chunked_scan,
    each checked bitwise against linear_scan, and its reverse at every ring
    of LINEAR_SCAN_REVERSE_RINGS (copies of linear_scan.cu with kRevRing
    replaced, built side by side in build/linear_scan_sweep/), each checked
    bitwise against linear_scan_reverse;
  * with --models: ACC_UNet b8 224x224 and ACC_UNet_W (3 classes) b2 512x512
    forwards in fp32 and bf16 (W also with the hybrid front half on), and
    the ACC_UNet b8 224x224 fp32 train step;
  * with --segmamba: Segmamba b8 224x224 fp32 inference and train step
    (binary Dice+BCE, Adam), each with its peak memory and the device time
    of its 16 selective_scan forwards (CUDA events around each call);
  * with --contig: for one ACC_UNet b8 224x224 train step, whether each
    depthwise backward met an NHWC-contiguous x and g (if not, its
    `.contiguous()` copied the map);
  * with --rh (alone, unless --only names other kernels too): the
    return-hidden scan at RH_SHAPES (the Spatial-Mamba variant's four stages
    at b8 224x224, BASELINE config 5's block, N 1, and shapes at the
    kernels' edges), softplus and bias on as StructureAwareSSM runs them:
    selective_scan_rh_fwd as inference runs it (no chunk states) and
    selective_scan_rh_bwd from the forward's chunk states with the cotangent
    of h laid out as (B, D, N, L) (the order the model hands over) and as
    (B, L, D, N), each beside its plain version and its bytes bound (each
    input read once and each output written once at 3.35 TB/s), with the
    error of h and of the five gradients against the plain versions; then
    the Spatial-Mamba variant (2 classes) b8 224x224 fp32 inference and
    train step (multiclass Dice+CE, Adam) with their peak memory and rh
    launches, and config 5's SpatialMambaBlock (b8 56x56, C 64, d_state 16)
    forward.
Times are CUDA events over --iters calls after 3 warm-up; with --graphs the
kernel calls (not the models) replay from a CUDA graph, so that a call's
host time does not show between short kernels. Prints one line
per row and, with --json, writes the rows. Run it once per tree with that
tree's root first on PYTHONPATH (e.g. a `git archive` of an older commit
unpacked into an ignored directory), in turns (old, new, new, old), to put
two designs side by side in one chip call.
"""

from __future__ import annotations

import argparse
import inspect
import itertools
import json
import os
import re
import subprocess
import sys

import torch
import torch.nn.functional as F

B, HW, NF = 8, 224, 32
KERNELS = ("dwconv2d_wgrad", "hanc_block", "respath_level", "expand_dw", "selective_scan",
           "selective_scan_rh", "linear_scan")
# name, map side, C
WGRAD = [("cnv12", HW, 3 * NF), ("cnv52", HW // 16, 48 * NF), ("cnv61", HW // 8, 48 * NF),
         ("cnv72", HW // 4, 136 * NF), ("unext.block1_0", HW // 16, 160),
         ("unext.block2_0", HW // 32, 256), ("unext.dblock2_0", HW // 8, 128),
         # U-KAN b8 256x256's DWBnRelu maps (its preset is 256x256)
         ("ukan.block1_0", 256 // 16, 320), ("ukan.block2_0", 256 // 32, 512),
         ("ukan.dblock2_0", 256 // 8, 256)]
# KNUnet b8 256x256's SS2D scans (the last block of up1-up3): name, L, d_inner
KNUNET_SCAN = [("knunet.up1", 16 ** 2, 512), ("knunet.up2", 32 ** 2, 256),
               ("knunet.up3", 64 ** 2, 128)]
# name, map side, cin, E, cout, chained
BLOCKS = [("cnv12", HW, NF, 3 * NF, NF, False), ("cnv22", HW // 2, 2 * NF, 6 * NF, 2 * NF, True),
          ("cnv81", HW // 2, 4 * NF, 12 * NF, 2 * NF, False),
          ("cnv91", HW, 2 * NF, 6 * NF, NF, False)]
# name, map side, C, with the previous level's SE apply
RESPATH = [("rspth1.level0", HW, NF, False), ("rspth1.level1", HW, NF, True),
           ("rspth2.level1", HW // 2, 2 * NF, True)]
# name, x shape (cnv72: cin 128 -> E 4352)
EXPAND = [("cnv72.b8_224", (B, HW // 4, HW // 4, 4 * NF)), ("cnv72.w_b2_512", (2, 128, 128, 4 * NF))]
# the standalone scan (name, B, L, D): Segmamba b8 224x224's four stages
# (D = d_inner * 16), BASELINE config 5's (8, 3136, 768) (bench.py:150-179),
# and the seq=2 shards of stage 0 and of config 5
LINEAR_SCAN = tuple((f"stage{i}", B, (HW // 2 >> i) ** 2, 2 * f * 16)
                    for i, f in enumerate((48, 96, 192, 384))) + (
    ("config5", B, 3136, 768), ("stage0.seq2", B, 6272, 1536), ("config5.seq2", B, 1568, 768))
# the rings --sweep gives the standalone scan's kernel: (rows a slot, slots);
# the forward's through dma_chunked_scan, the reverse's in scratch builds
LINEAR_SCAN_RINGS = tuple((r, n) for r in (16, 32, 64, 128) for n in (2, 3, 4))
LINEAR_SCAN_REVERSE_RINGS = tuple((r, n) for r in (16, 32, 48, 64) for n in (2, 3, 4))
# Segmamba b8 224x224's BiMamba stages: name, L, d_inner (N 16)
SCAN = [(f"stage{i}", (HW // 2 >> i) ** 2, 2 * f) for i, f in enumerate((48, 96, 192, 384))]
# the return-hidden scan (name, B, L, D, N): the Spatial-Mamba variant's stages
# at b8 224x224; BASELINE config 5's block (b8 56x56, C 64); the classifier's
# d_state 1; L below one 128-step chunk with D 20 (a partial cluster of 8 d);
# N 1 with D 40 and L 1000 (a partial chunk, 5 CTAs); N 3 (lanes padded to
# 4) with L 129 and D 9 (chip_smoke.py's RH_SHAPES but the odd one)
RH_SHAPES = tuple((f"stage{i}", B, (HW // 2 >> i) ** 2, 2 * f, 16)
                  for i, f in enumerate((48, 96, 192, 384))) + (
    ("config5", B, 56 * 56, 128, 16), ("n1", B, 56 * 56, 128, 1), ("short", 2, 100, 20, 16),
    ("n1_edge", 2, 1000, 40, 1), ("n3_edge", 2, 129, 9, 3))
SPM_VARIANT = "Segmamba_hybrid_gsc_KAN_PE_ds_CrossAttn_HSLCA_SpatialMamba_no_text"
HBM_BYTES_PER_S = 3.35e12


GRAPHS = False  # --graphs: replay the calls from a CUDA graph (no host time between them)


def time_ms(fn, iters: int, graphs: bool | None = None) -> float:
    """CUDA-event time of fn per call; replayed from a CUDA graph with
    --graphs unless `graphs` says otherwise."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    run = fn
    if GRAPHS if graphs is None else graphs:
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            fn()
        run = graph.replay
        run()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        run()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def rel_err(got, want) -> float:
    got, want = got.float(), want.float()
    return float((got - want).abs().max()) / max(float(want.abs().max()), 1e-30)


def wgrad_library(x, g, k=3):
    c = x.shape[-1]
    w = torch.empty(c, 1, k, k, device=x.device, dtype=x.dtype)
    return torch.ops.aten.convolution_backward(
        g.permute(0, 3, 1, 2), x.permute(0, 3, 1, 2), w, None, [1, 1], [(k - 1) // 2] * 2,
        [1, 1], False, [0, 0], c, [False, True, False])[1]


def respath_args(rn, hw, c, prev, dt):
    args = [rn(B, hw, hw, c).to(dt), rn(3, 3, c, c, s=1 / (9 * c) ** 0.5), 1 + rn(c, s=0.1),
            rn(c, s=0.1)]
    if prev:
        args += [rn(B, hw, hw, c).to(dt), 0.5 + 0.5 * rn(B, c, s=0.5).sigmoid(),
                 1 + rn(c, s=0.1), rn(c, s=0.1)]
    return args


def cnv72_block(dt):
    """A cnv72-shaped hybrid HANCBlock (cin 128, inv_fctr 34) with seeded
    weights, as chip_smoke.py builds it: its `expand_dw_args` and its
    `front_unfused`."""
    from accunet_tpu_torch.models import init_parameters
    from accunet_tpu_torch.nn.acc_blocks import HANCBlock

    block = init_parameters(HANCBlock(4 * NF, 4 * NF, 3, 34, hybrid=True),
                            torch.Generator().manual_seed(15))
    return block.eval().to(device="cuda", dtype=dt).requires_grad_(False)


def kernel_rows(iters: int, emit, only=KERNELS):
    from accunet_tpu_torch.ops.kernels import dwconv2d as DW
    from accunet_tpu_torch.ops.kernels import expand_dw as ED
    from accunet_tpu_torch.ops.kernels import hanc_block as HB
    from accunet_tpu_torch.ops.kernels import respath as RP

    takes_db = "bias_grad" in inspect.signature(DW.dwconv2d_wgrad).parameters
    g = torch.Generator(device="cuda").manual_seed(0)

    def rn(*shape, s=1.0):
        return torch.randn(*shape, generator=g, device="cuda") * s

    for dt in (torch.float32, torch.bfloat16):
        for name, hw, c in WGRAD if "dwconv2d_wgrad" in only else ():
            x, gy = rn(B, hw, hw, c).to(dt), rn(B, hw, hw, c).to(dt)
            with torch.inference_mode():
                err = rel_err(DW.dwconv2d_wgrad(x, gy, 3, 3),
                              DW.dwconv2d_wgrad_reference(x, gy, 3, 3))
                row = {"kernel": "dwconv2d_wgrad", "shape": name, "dtype": str(dt)[6:],
                       "ms": time_ms(lambda: DW.dwconv2d_wgrad(x, gy, 3, 3), iters),
                       "ms_with_db": (time_ms(lambda: DW.dwconv2d_wgrad(x, gy, 3, 3,
                                                                        bias_grad=True), iters)
                                      if takes_db else None),
                       "library_ms": time_ms(lambda: wgrad_library(x, gy), iters), "rel_err": err}
            emit(row)
            del x, gy
        for name, hw, cin, e, cout, chained in BLOCKS if "hanc_block" in only else ():
            f = lambda n: 1.0 / n ** 0.5  # noqa: E731
            bns = {n: (1 + rn(d, s=0.1), rn(d, s=0.1)) for n, d in
                   [("norm1", e), ("norm2", e), ("hnc", cin), ("norm", cin), ("norm3", cout)]}
            p = HB.fold(rn(cin, e, s=f(cin)), rn(e, s=0.1), rn(3, 3, e, s=f(9)), rn(e, s=0.1),
                        rn(e, 5, cin, s=f(e)), rn(cin, s=0.1), rn(cin, cout, s=f(cin)),
                        rn(cout, s=0.1), bns)
            x = rn(B, hw, hw, cin).to(dt)
            pre = torch.stack([0.5 + rn(B, cin, s=0.1), rn(B, cin, s=0.1)], 1).contiguous() \
                if chained else None
            with torch.inference_mode():
                err = rel_err(HB.hanc_block(x, p, 3, pre)[0],
                              HB.hanc_block_reference(x, p, 3, pre)[0])
                row = {"kernel": "hanc_block", "shape": name, "dtype": str(dt)[6:],
                       "ms": time_ms(lambda: HB.hanc_block(x, p, 3, pre), iters), "rel_err": err}
            emit(row)
            del x, p, pre
        for name, hw, c, prev in RESPATH if "respath_level" in only else ():
            args = respath_args(rn, hw, c, prev, dt)
            w_oihw = args[1].permute(3, 2, 0, 1).contiguous().to(dt)
            with torch.inference_mode():
                err = rel_err(RP.respath_level(*args)[0], RP.respath_level_reference(*args)[0])
                row = {"kernel": "respath_level", "shape": name, "dtype": str(dt)[6:],
                       "ms": time_ms(lambda: RP.respath_level(*args), iters),
                       "conv_alone_ms": time_ms(lambda: F.conv2d(
                           args[0].permute(0, 3, 1, 2), w_oihw, padding=1), iters),
                       "rel_err": err}
            emit(row)
            del args
        if "expand_dw" in only:
            block = cnv72_block(dt)
            front = block.expand_dw_args()
            for name, shape in EXPAND:
                x = rn(*shape).to(dt)
                with torch.inference_mode():
                    err = rel_err(ED.expand_dw(x, *front), ED.expand_dw_plain(x, *front))
                    row = {"kernel": "expand_dw", "shape": name, "dtype": str(dt)[6:],
                           "ms": time_ms(lambda: ED.expand_dw(x, *front), iters),
                           "unfused_ms": time_ms(lambda: block.front_unfused(x), iters),
                           "rel_err": err}
                emit(row)
                del x
            del block, front
        torch.cuda.empty_cache()
    if "selective_scan" in only:
        scan_rows(iters, emit)
    if "linear_scan" in only:
        linear_scan_rows(iters, emit)


def linear_scan_inputs(b, l, d, seed=21):
    """a in (0.2, 0.99) and b in (-0.5, 0.5), as bench.py's config 5 draws
    them; a cotangent g ~ N(0, 1)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    a = 0.2 + 0.79 * torch.rand(b, l, d, generator=g, device="cuda")
    return a, torch.rand(b, l, d, generator=g, device="cuda") - 0.5, \
        torch.randn(b, l, d, generator=g, device="cuda")


def linear_scan_rows(iters: int, emit):
    """linear_scan, linear_scan_reverse and the staged kernel (nbuf 2 and 4)
    at LINEAR_SCAN, fp32, beside the plain versions and the bytes bound (3
    tensors forward, 5 reverse, at 3.35 TB/s); Mtok/s = B * L / time; the
    errors against the plain versions, and whether the staged h equals the
    forward's bitwise."""
    from accunet_tpu_torch.ops.kernels import scan as S

    for name, b, l, d in LINEAR_SCAN:
        a, x, gy = linear_scan_inputs(b, l, d)
        tensor_ms = a.numel() * 4 / HBM_BYTES_PER_S * 1e3
        with torch.inference_mode():
            h = S.linear_scan(a, x)
            da, db = S.linear_scan_reverse(a, h, gy)
            staged = S.dma_chunked_scan(a, x, nbuf=2)
            hp = S.linear_scan_plain(a, x)
            dap, dbp = S.linear_scan_grads_plain(a, h, gy)
            errs = {"h_rel_err": rel_err(h, hp), "da_rel_err": rel_err(da, dap),
                    "db_rel_err": rel_err(db, dbp), "staged_bitwise": bool(torch.equal(staged, h))}
            del da, db, staged, hp, dap, dbp
            torch.cuda.empty_cache()
            timed = {
                "linear_scan": (lambda: S.linear_scan(a, x), 3),
                "linear_scan_reverse": (lambda: S.linear_scan_reverse(a, h, gy), 5),
                "linear_scan_staged_nbuf2": (lambda: S.dma_chunked_scan(a, x, nbuf=2), 3),
                "linear_scan_staged_nbuf4": (lambda: S.dma_chunked_scan(a, x, nbuf=4), 3)}
            plain = {"linear_scan": time_ms(lambda: S.linear_scan_plain(a, x), 3, False),
                     "linear_scan_reverse": time_ms(
                         lambda: S.linear_scan_grads_plain(a, h, gy), 3, False)}
            for kname, (run, n_tensors) in timed.items():
                ms = time_ms(run, iters)
                bound = n_tensors * tensor_ms
                emit({"kernel": kname, "shape": f"{name} B{b} L{l} D{d}", "dtype": "float32",
                      "ms": ms, "plain_ms": plain.get(kname, plain["linear_scan"]),
                      "bound_ms": bound, "pct_of_bound": 100 * bound / ms,
                      "mtok_per_s": b * l / ms / 1e3, **errs})
        del a, x, gy, h
        torch.cuda.empty_cache()


def linear_scan_reverse_builds():
    """linear_scan.cu built once per ring of LINEAR_SCAN_REVERSE_RINGS
    (kRevRing replaced), nvcc in parallel, into build/linear_scan_sweep/:
    {ring: that library's accunet_linear_scan_reverse}."""
    import ctypes
    from concurrent.futures import ThreadPoolExecutor

    from accunet_tpu_torch.ops.kernels import _build

    src = (_build.CSRC / "linear_scan.cu").read_text()
    old = re.search(r"constexpr Ring kRevRing\{\d+, \d+\};", src).group(0)
    out = _build.build_dir().parent / "linear_scan_sweep"
    out.mkdir(parents=True, exist_ok=True)

    def build(ring):
        cu, so = out / f"reverse_{ring[0]}x{ring[1]}.cu", out / f"reverse_{ring[0]}x{ring[1]}.so"
        cu.write_text(src.replace(old, f"constexpr Ring kRevRing{{{ring[0]}, {ring[1]}}};"))
        subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-shared",
                        str(cu), "-o", str(so)], check=True, capture_output=True)
        fn = ctypes.CDLL(str(so)).accunet_linear_scan_reverse
        fn.argtypes, fn.restype = _build.SIGNATURES["accunet_linear_scan_reverse"], ctypes.c_int
        return fn

    with ThreadPoolExecutor(8) as pool:
        return dict(zip(LINEAR_SCAN_REVERSE_RINGS, pool.map(build, LINEAR_SCAN_REVERSE_RINGS)))


def linear_scan_sweep_rows(iters: int, emit):
    """The standalone scan's kernel at LINEAR_SCAN in every ring of
    LINEAR_SCAN_RINGS, forward, through dma_chunked_scan (the entry that
    takes the ring from its caller), each checked bitwise against
    linear_scan; its reverse in every ring of LINEAR_SCAN_REVERSE_RINGS
    (linear_scan_reverse_builds), each checked bitwise against
    linear_scan_reverse."""
    from accunet_tpu_torch.ops.kernels import _build
    from accunet_tpu_torch.ops.kernels import scan as S

    reverse = linear_scan_reverse_builds()
    for name, b, l, d in LINEAR_SCAN:
        a, x, gy = linear_scan_inputs(b, l, d)
        tensor_ms = a.numel() * 4 / HBM_BYTES_PER_S * 1e3
        with torch.inference_mode():
            h = S.linear_scan(a, x)
            want = S.linear_scan_reverse(a, h, gy)
            for chunk, nbuf in LINEAR_SCAN_RINGS:
                same = torch.equal(S.dma_chunked_scan(a, x, chunk, nbuf), h)
                ms = time_ms(lambda: S.dma_chunked_scan(a, x, chunk, nbuf), iters)
                bound = 3 * tensor_ms
                emit({"kernel": "linear_scan_staged",
                      "shape": f"{name} B{b} L{l} D{d} chunk{chunk} nbuf{nbuf}",
                      "dtype": "float32", "ms": ms, "bound_ms": bound,
                      "pct_of_bound": 100 * bound / ms, "bitwise_linear_scan": same})
            da, db = torch.empty_like(a), torch.empty_like(a)
            for (chunk, nbuf), fn in reverse.items():
                def run():
                    _build.check(fn(a.data_ptr(), h.data_ptr(), gy.data_ptr(), da.data_ptr(),
                                    db.data_ptr(), b, l, d, _build.stream_of(a)),
                                 "accunet_linear_scan_reverse")
                run()
                same = torch.equal(da, want[0]) and torch.equal(db, want[1])
                ms = time_ms(run, iters)
                bound = 5 * tensor_ms
                emit({"kernel": "linear_scan_reverse",
                      "shape": f"{name} B{b} L{l} D{d} chunk{chunk} nbuf{nbuf}",
                      "dtype": "float32", "ms": ms, "bound_ms": bound,
                      "pct_of_bound": 100 * bound / ms, "bitwise_linear_scan_reverse": same})
        del a, x, gy, h, want, da, db
        torch.cuda.empty_cache()


def bimamba_operands(g, l, d, n=16):
    """selective_scan's operands as BiMamba._branch makes them: u (B, D, L)
    contiguous; delta, B, C and z transposed views of (B, L, .) tensors."""
    def rn(*shape, s=1.0):
        return torch.randn(*shape, generator=g, device="cuda") * s

    x_dbl = rn(B, l, 2 * n)
    a = -torch.arange(1, n + 1, device="cuda", dtype=torch.float32).expand(d, n).contiguous()
    return (F.silu(rn(B, d, l)), rn(B, l, d, s=0.5).transpose(1, 2), a,
            x_dbl[..., :n].transpose(1, 2), x_dbl[..., n:].transpose(1, 2),
            torch.ones(d, device="cuda"), rn(B, l, 2 * d)[..., d:].transpose(1, 2), rn(d, s=0.1))


def scan_rows(iters: int, emit):
    """The public selective_scan at each stage: forward (CUDA-graph replays
    with --graphs) and forward + backward (CUDA events), fp32."""
    from accunet_tpu_torch.ops.selective_scan import selective_scan

    g = torch.Generator(device="cuda").manual_seed(0)
    for name, l, d in SCAN:
        ops = bimamba_operands(g, l, d)
        gy = torch.randn(B, d, l, generator=g, device="cuda")

        def fwd():
            return selective_scan(*ops[:6], z=ops[6], delta_bias=ops[7], delta_softplus=True)

        with torch.inference_mode():
            fwd_ms = time_ms(fwd, iters)
        leaves = [t.detach().clone().requires_grad_(True) for t in ops]

        def fwd_bwd():
            y = selective_scan(*leaves[:6], z=leaves[6], delta_bias=leaves[7],
                               delta_softplus=True)
            y.backward(gy)

        fwd_bwd()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        fwd_bwd_ms = time_ms(fwd_bwd, max(iters // 4, 3), graphs=False)
        emit({"kernel": "selective_scan", "shape": f"{name} B{B} L{l} D{d} N16",
              "dtype": "float32", "fwd_ms": fwd_ms, "fwd_bwd_ms": fwd_bwd_ms,
              "fwd_bwd_peak_mib": (torch.cuda.max_memory_allocated() - base) / 2 ** 20})
        del ops, leaves, gy
        torch.cuda.empty_cache()


def segmamba_rows(iters: int, emit):
    """Segmamba b8 224x224 fp32 inference and train step, with peak memory
    and the summed device spans of the selective_scan forwards."""
    from accunet_tpu_torch.models import build, init_parameters
    from accunet_tpu_torch.nn import ssm
    from accunet_tpu_torch.train import losses as L
    from accunet_tpu_torch.train.engine import make_train_fns

    spans, scan = [], ssm.selective_scan

    def timed_scan(*a, **kw):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = scan(*a, **kw)
        end.record()
        spans.append((start, end))
        return out

    def span_ms(fn):
        spans.clear()
        ssm.selective_scan = timed_scan
        try:
            fn()
        finally:
            ssm.selective_scan = scan
        torch.cuda.synchronize()
        return sum(s.elapsed_time(e) for s, e in spans), len(spans)

    model = init_parameters(build("Segmamba", in_chans=3, out_chans=1),
                            torch.Generator().manual_seed(0)).cuda().eval()
    g = torch.Generator("cuda").manual_seed(14)
    x = torch.rand(B, HW, HW, 3, generator=g, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode():
        ms = time_ms(lambda: model(x), iters)
        scan_ms, calls = span_ms(lambda: model(x))
    emit({"kernel": "model", "shape": f"Segmamba b{B} {HW}x{HW} forward", "dtype": "float32",
          "ms": ms, "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
          "selective_scan_fwd_ms": scan_ms, "selective_scan_calls": calls})
    fns = make_train_fns(model.train(), loss_fn=L.binary_dice_bce)
    batch = {"image": x, "mask": (torch.rand(B, HW, HW, 1, generator=g, device="cuda") > 0.5)
             .float()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms = time_ms(lambda: fns.train_step(fns.state, batch), iters)
    scan_ms, calls = span_ms(lambda: fns.train_step(fns.state, batch))
    emit({"kernel": "model", "shape": f"Segmamba b{B} {HW}x{HW} train step", "dtype": "float32",
          "ms": ms, "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
          "selective_scan_fwd_ms": scan_ms, "selective_scan_calls": calls})
    del model, fns
    torch.cuda.empty_cache()


def sweep_rows(iters: int, emit, only=KERNELS):
    from accunet_tpu_torch.ops.kernels import _build
    from accunet_tpu_torch.ops.kernels import dwconv2d as DW
    from accunet_tpu_torch.ops.kernels import expand_dw as ED
    from accunet_tpu_torch.ops.kernels import hanc_block as HB
    from accunet_tpu_torch.ops.kernels import respath as RP

    g = torch.Generator(device="cuda").manual_seed(0)

    def rn(*shape, s=1.0):
        return torch.randn(*shape, generator=g, device="cuda") * s

    for dt in (torch.float32, torch.bfloat16):
        size = torch.finfo(dt).bits // 8
        for name, hw, c in WGRAD if "dwconv2d_wgrad" in only else ():
            x, gy = rn(B, hw, hw, c).to(dt), rn(B, hw, hw, c).to(dt)
            base = DW.wgrad_plan(B, hw, hw, c, 3, size, True)
            whole = -(-c // (16 // size)) * (16 // size)  # every channel in one block
            cbs = {base.cb * m for m in (1, 2, 4, 8)} | ({whole} if c <= 256 else set())
            for cb in sorted(cbs):
                for mult, direct in itertools.product((1, 2, 4, 8), (False, True)):
                    try:
                        one = DW.wgrad_plan(B, hw, hw, c, 3, size, True, cb=cb)
                        plan = DW.wgrad_plan(B, hw, hw, c, 3, size, True, cb=cb,
                                             ctas=one.ctas * mult, direct=direct)
                    except ValueError:
                        continue
                    with torch.inference_mode():
                        ms = time_ms(lambda: DW.dwconv2d_wgrad(x, gy, 3, 3, plan=plan), iters)
                    emit({"kernel": "dwconv2d_wgrad", "shape": f"{name} cb{cb} sw{plan.sw} "
                          f"ctas{plan.ctas}{' direct' if direct else ''}",
                          "dtype": str(dt)[6:], "ms": ms})
            del x, gy
        for name, hw, cin, e, cout, chained in BLOCKS if "hanc_block" in only else ():
            p = HB.fold(rn(cin, e, s=cin ** -0.5), rn(e, s=0.1), rn(3, 3, e, s=1 / 3),
                        rn(e, s=0.1), rn(e, 5, cin, s=e ** -0.5), rn(cin, s=0.1),
                        rn(cin, cout, s=cin ** -0.5), rn(cout, s=0.1),
                        {n: (1 + rn(d, s=0.1), rn(d, s=0.1)) for n, d in
                         [("norm1", e), ("norm2", e), ("hnc", cin), ("norm", cin),
                          ("norm3", cout)]})
            x = rn(B, hw, hw, cin).to(dt)
            for tile, (th, tw, ncol) in HB.TILES.items():
                if ncol < cin:
                    continue
                with torch.inference_mode():
                    ms = time_ms(lambda: HB.hanc_block(x, p, 3, tile=tile), iters)
                emit({"kernel": "hanc_block", "shape": f"{name} tile{tile} {th}x{tw}x{ncol}",
                      "dtype": str(dt)[6:], "ms": ms})
            del x, p
        for name, hw, c, prev in RESPATH if "respath_level" in only else ():
            args = respath_args(rn, hw, c, prev, dt)
            for plan, (th, ncol, streamed) in RP.PLANS.items():
                if not RP.fits(plan, c, size):
                    continue
                with torch.inference_mode():
                    ms = time_ms(lambda: RP._launch(*args, plan=plan), iters)
                emit({"kernel": "respath_level", "shape": f"{name} plan{plan} {th}x16x{ncol} "
                      f"{'streamed' if streamed else 'resident'}", "dtype": str(dt)[6:], "ms": ms})
            del args
        front = cnv72_block(dt).expand_dw_args() if "expand_dw" in only else None
        for name, shape in EXPAND if "expand_dw" in only else ():
            x = rn(*shape).to(dt)
            for plan, halo in ED.PLANS.items():
                if ED.smem_bytes(plan, shape[-1], size) > _build.MAX_SMEM:
                    continue
                with torch.inference_mode():
                    ms = time_ms(lambda: ED._launch(x, *front, plan=plan), iters)
                emit({"kernel": "expand_dw", "shape": f"{name} plan{plan} {halo}",
                      "dtype": str(dt)[6:], "ms": ms})
            del x
        del front
        torch.cuda.empty_cache()


def rh_operands(g, b, l, d, n):
    """The rh kernels' operands as StructureAwareSSM hands them (u =
    silu(N(0, 1)), delta N(0, 0.5^2) before its softplus, A = -(1..N), B ~
    N(0, 1), bias ~ N(0, 0.1^2)) and a cotangent gh ~ N(0, 1) of h (B, L,
    D, N)."""
    def rn(*shape, s=1.0):
        return torch.randn(*shape, generator=g, device="cuda") * s

    ops = (F.silu(rn(b, d, l)), rn(b, d, l, s=0.5),
           -torch.arange(1, n + 1, device="cuda", dtype=torch.float32).expand(d, n).contiguous(),
           rn(b, n, l), rn(d, s=0.1))
    return ops, rn(b, l, d, n)


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def rh_rows(iters: int, emit):
    """selective_scan_rh_fwd / _bwd at RH_SHAPES, fp32 (CUDA-graph replays
    with --graphs), beside the plain versions and the bytes bound."""
    from accunet_tpu_torch.ops.kernels import selective_scan as SS

    g = torch.Generator(device="cuda").manual_seed(29)
    for name, b, l, d, n in RH_SHAPES:
        ops, gh = rh_operands(g, b, l, d, n)
        gh_dnl = gh.permute(0, 2, 3, 1).contiguous().permute(0, 3, 1, 2)
        with torch.inference_mode():
            h, states = SS.selective_scan_rh_fwd(*ops, True, save_states=True)
            want = SS.selective_scan_rh_fwd_plain(*ops, True)
            h_err = rel_err(h, want)
            del want
            grads = SS.selective_scan_rh_bwd(*ops, True, states, gh_dnl)
            wants = SS.selective_scan_rh_bwd_plain(*ops, True, gh)
            g_err = max(rel_err(p, q) for p, q in zip(grads, wants))
            same = all(torch.equal(p, q) for p, q in
                       zip(grads, SS.selective_scan_rh_bwd(*ops, True, states, gh)))
            del wants
            fwd_bytes = nbytes(*ops, h)
            bwd_bytes = nbytes(*ops, states, gh, *grads)
            del h, grads
            torch.cuda.empty_cache()
            fwd_ms = time_ms(lambda: SS.selective_scan_rh_fwd(*ops, True), iters)
            bwd_ms = time_ms(lambda: SS.selective_scan_rh_bwd(*ops, True, states, gh_dnl), iters)
            bldn_ms = time_ms(lambda: SS.selective_scan_rh_bwd(*ops, True, states, gh), iters)
            plain_fwd = time_ms(lambda: SS.selective_scan_rh_fwd_plain(*ops, True), 3, False)
            plain_bwd = time_ms(lambda: SS.selective_scan_rh_bwd_plain(*ops, True, gh_dnl), 3,
                                False)
        fb, bb = fwd_bytes / HBM_BYTES_PER_S * 1e3, bwd_bytes / HBM_BYTES_PER_S * 1e3
        emit({"kernel": "selective_scan_rh", "shape": f"{name} B{b} L{l} D{d} N{n}",
              "dtype": "float32", "fwd_ms": fwd_ms, "bwd_dnl_ms": bwd_ms, "bwd_bldn_ms": bldn_ms,
              "plain_fwd_ms": plain_fwd, "plain_bwd_ms": plain_bwd, "fwd_bound_ms": fb,
              "bwd_bound_ms": bb, "fwd_pct_of_bound": 100 * fb / fwd_ms,
              "bwd_pct_of_bound": 100 * bb / bwd_ms, "h_rel_err": h_err, "grads_rel_err": g_err,
              "bwd_layouts_bitwise": same, "states_shape": list(states.shape)})
        del ops, gh, gh_dnl, states
        torch.cuda.empty_cache()


def spm_rows(iters: int, emit):
    """The Spatial-Mamba variant (2 classes) b8 224x224 fp32 inference and
    train step, and config 5's SpatialMambaBlock forward, each with its peak
    memory; the rh launches per forward and per step."""
    from accunet_tpu_torch.models import build, init_parameters
    from accunet_tpu_torch.nn.ssm import SpatialMambaBlock
    from accunet_tpu_torch.ops.kernels import selective_scan as SS
    from accunet_tpu_torch.train import losses as L
    from accunet_tpu_torch.train import metrics as M
    from accunet_tpu_torch.train.engine import make_train_fns

    model = init_parameters(build(SPM_VARIANT, in_chans=3, out_chans=2),
                            torch.Generator().manual_seed(0)).cuda().eval()
    g = torch.Generator("cuda").manual_seed(32)
    x = torch.rand(B, HW, HW, 3, generator=g, device="cuda")
    steps = max(iters // 2, 3)

    def launches(fn):
        before = (SS.selective_scan_rh_fwd.launches, SS.selective_scan_rh_bwd.launches)
        fn()
        torch.cuda.synchronize()
        return (SS.selective_scan_rh_fwd.launches - before[0],
                SS.selective_scan_rh_bwd.launches - before[1])

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode():
        ms = time_ms(lambda: model(x), steps)
        fwd, _ = launches(lambda: model(x))
    emit({"kernel": "model", "shape": f"{SPM_VARIANT} b{B} {HW}x{HW} forward", "dtype": "float32",
          "ms": ms, "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
          "rh_fwd_launches": fwd})
    fns = make_train_fns(model.train(), loss_fn=L.multiclass_dice_ce,
                         dice_show=L.multiclass_dice_show, iou_fn=M.multiclass_batch_iou)
    batch = {"image": x, "mask": torch.randint(0, 3, (B, HW, HW, 1), generator=g,
                                               device="cuda").float()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms = time_ms(lambda: fns.train_step(fns.state, batch), steps, graphs=False)
    fwd, bwd = launches(lambda: fns.train_step(fns.state, batch))
    emit({"kernel": "model", "shape": f"{SPM_VARIANT} b{B} {HW}x{HW} train step",
          "dtype": "float32", "ms": ms, "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
          "rh_fwd_launches": fwd, "rh_bwd_launches": bwd})
    del model, fns, batch
    torch.cuda.empty_cache()
    blk = init_parameters(SpatialMambaBlock(64, d_state=16),
                          torch.Generator().manual_seed(1)).cuda().eval()
    xb = torch.randn(B, 56, 56, 64, generator=g, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode():
        ms = time_ms(lambda: blk(xb), iters, graphs=False)
    emit({"kernel": "model", "shape": f"SpatialMambaBlock b{B} 56x56 C64 d_state16 forward "
          "(BASELINE config 5)", "dtype": "float32", "ms": ms,
          "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30})


def model_rows(iters: int, emit):
    from accunet_tpu_torch.models import build, init_parameters
    from accunet_tpu_torch.train.engine import make_train_fns

    for name, n_classes, hw, b, hybrid in (("ACC_UNet", 1, HW, B, False),
                                           ("ACC_UNet_W", 3, 512, 2, False),
                                           ("ACC_UNet_W", 3, 512, 2, True)):
        x = torch.randn(b, hw, hw, 3, device="cuda",
                        generator=torch.Generator("cuda").manual_seed(1))
        for dt in (torch.float32, torch.bfloat16):
            m = init_parameters(build(name, n_channels=3, n_classes=n_classes, n_filts=NF,
                                      final_sigmoid=False, hybrid_expand_dw=hybrid),
                                torch.Generator().manual_seed(0))
            m, xd = m.eval().to(device="cuda", dtype=dt), x.to(dt)
            with torch.inference_mode():
                ms = time_ms(lambda: m(xd), iters)
            emit({"kernel": "model", "shape": f"{name} b{b} {hw}x{hw} forward"
                  + (" hybrid" if hybrid else ""), "dtype": str(dt)[6:], "ms": ms})
            del m, xd
        torch.cuda.empty_cache()
    model = init_parameters(build("ACC_UNet", n_channels=3, n_classes=1, n_filts=NF),
                            torch.Generator().manual_seed(0)).cuda()
    fns = make_train_fns(model)
    g = torch.Generator("cuda").manual_seed(6)
    batch = {"image": torch.rand(B, HW, HW, 3, generator=g, device="cuda"),
             "mask": (torch.rand(B, HW, HW, 1, generator=g, device="cuda") > 0.5).float()}
    emit({"kernel": "model", "shape": f"ACC_UNet b{B} {HW}x{HW} train step", "dtype": "float32",
          "ms": time_ms(lambda: fns.train_step(fns.state, batch), iters)})


def contig_rows(emit):
    from accunet_tpu_torch.models import build, init_parameters
    from accunet_tpu_torch.ops.kernels import dwconv2d as DW
    from accunet_tpu_torch.train.engine import make_train_fns

    seen = []
    backward = DW.DepthwiseConv2dFn.backward

    def recording(ctx, g):
        x = ctx.saved_tensors[0]
        seen.append((tuple(x.shape), x.is_contiguous(), g.is_contiguous()))
        return backward(ctx, g)

    DW.DepthwiseConv2dFn.backward = staticmethod(recording)
    try:
        model = init_parameters(build("ACC_UNet", n_channels=3, n_classes=1, n_filts=NF),
                                torch.Generator().manual_seed(0)).cuda()
        fns = make_train_fns(model)
        g = torch.Generator("cuda").manual_seed(6)
        batch = {"image": torch.rand(B, HW, HW, 3, generator=g, device="cuda"),
                 "mask": (torch.rand(B, HW, HW, 1, generator=g, device="cuda") > 0.5).float()}
        fns.train_step(fns.state, batch)
        torch.cuda.synchronize()
    finally:
        DW.DepthwiseConv2dFn.backward = backward
    emit({"kernel": "contiguity", "shape": f"ACC_UNet b{B} {HW}x{HW} train step",
          "backwards": len(seen), "x_not_contiguous": sum(not x for _, x, _ in seen),
          "g_not_contiguous": sum(not g_ for _, _, g_ in seen), "maps": seen})


def knunet_rows(iters: int, emit):
    """The fused kernels at KNUNET_SCAN (CUDA-graph replays with --graphs),
    fp32, beside the bytes bound: each operand read and each result written
    once (the backward also reads the chunk states and the cotangent)."""
    from accunet_tpu_torch.ops.kernels import selective_scan as SS

    g = torch.Generator(device="cuda").manual_seed(0)

    def rn(*shape, s=1.0):
        return torch.randn(*shape, generator=g, device="cuda") * s

    n = 16
    for name, l, d in KNUNET_SCAN:
        a = -torch.arange(1, n + 1, device="cuda", dtype=torch.float32).expand(d, n).contiguous()
        ops = (F.silu(rn(B, d, l)), rn(B, d, l, s=0.5), a, rn(B, n, l), rn(B, n, l),
               1 + rn(d, s=0.1), None, rn(d, s=0.1))
        gy = rn(B, d, l)
        with torch.inference_mode():
            out, last, states = SS.selective_scan_fwd(*ops, True, save_states=True)
            grads = SS.selective_scan_bwd(*ops, True, states, gy)
            row = {"kernel": "selective_scan", "shape": f"{name} B{B} L{l} D{d} N{n}",
                   "dtype": "float32",
                   "fwd_ms": time_ms(lambda: SS.selective_scan_fwd(*ops, True), iters),
                   "bwd_ms": time_ms(lambda: SS.selective_scan_bwd(*ops, True, states, gy),
                                     iters),
                   "fwd_bound_ms": nbytes(*ops, out, last) / HBM_BYTES_PER_S * 1e3,
                   "bwd_bound_ms": nbytes(*ops, states, gy, *grads) / HBM_BYTES_PER_S * 1e3}
        emit(row)
        del ops, gy, out, last, states, grads
        torch.cuda.empty_cache()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tag", default="", help="a name for this tree, copied into every row")
    ap.add_argument("--json", default=None, help="write the rows here")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--only", nargs="+", choices=KERNELS, default=None,
                    help="time (and sweep) these kernels alone")
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--graphs", action="store_true")
    ap.add_argument("--models", action="store_true")
    ap.add_argument("--segmamba", action="store_true")
    ap.add_argument("--contig", action="store_true")
    ap.add_argument("--rh", action="store_true")
    ap.add_argument("--knunet", action="store_true")
    args = ap.parse_args(argv)
    only = args.only or (("selective_scan_rh",) if args.rh else KERNELS)
    if not torch.cuda.is_available():
        print("kernel_ab: needs a CUDA device", file=sys.stderr)
        return 2
    # appended, so that a tree on PYTHONPATH comes first
    sys.path.append(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import accunet_tpu_torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    tree = os.path.dirname(os.path.dirname(os.path.abspath(accunet_tpu_torch.__file__)))
    print(f"{card}; tree {tree} ({args.tag})", flush=True)
    rows = []

    def emit(row):
        row.update(tag=args.tag, card=card, graphs=GRAPHS)
        rows.append(row)
        print(json.dumps(row), flush=True)

    global GRAPHS
    GRAPHS = args.graphs
    kernel_rows(args.iters, emit, only)
    if "selective_scan_rh" in only:
        rh_rows(args.iters, emit)
    if args.knunet:
        knunet_rows(args.iters, emit)
    if args.sweep:
        sweep_rows(args.iters, emit, only)
        if "linear_scan" in only:
            linear_scan_sweep_rows(args.iters, emit)
    GRAPHS = False
    if args.rh:
        spm_rows(args.iters, emit)
    if args.models:
        model_rows(args.iters, emit)
    if args.segmamba:
        segmamba_rows(args.iters, emit)
    if args.contig:
        contig_rows(emit)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
