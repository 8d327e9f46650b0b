#!/usr/bin/env python3
"""Time the redesigned kernels (dwconv2d_wgrad, hanc_block, respath_level,
expand_dw, the selective scan) and the models that run them, for one tree of
the port.

    python tools/kernel_ab.py [--tag NAME] [--json PATH] [--iters N] [--only KERNEL ...]
                              [--sweep] [--graphs] [--models] [--segmamba] [--contig]

On one CUDA card, at chip_smoke.py's shapes (ACC_UNet, n_filts=32, b8
224x224; expand_dw also at ACC_UNet_W b2 512x512), in fp32 (TF32 off) and
bf16:
  * dwconv2d_wgrad at cnv12, cnv52, cnv61 and cnv72, and at UNext b8
    224x224's ShiftedBlock maps (14x14x160, 7x7x256, 28x28x128): the kernel for dw alone
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
  * with --sweep (this tree only): dwconv2d_wgrad at each of its shapes
    under other splits (channel block, CTAs per block: `wgrad_plan`'s
    overrides), hanc_block at each of its shapes in every tile that holds
    its width (`TILES`), respath_level and expand_dw at each of their shapes
    in every plan that fits (`PLANS`);
  * with --models: ACC_UNet b8 224x224 and ACC_UNet_W (3 classes) b2 512x512
    forwards in fp32 and bf16 (W also with the hybrid front half on), and
    the ACC_UNet b8 224x224 fp32 train step;
  * with --segmamba: Segmamba b8 224x224 fp32 inference and train step
    (binary Dice+BCE, Adam), each with its peak memory and the device time
    of its 16 selective_scan forwards (CUDA events around each call);
  * with --contig: for one ACC_UNet b8 224x224 train step, whether each
    depthwise backward met an NHWC-contiguous x and g (if not, its
    `.contiguous()` copied the map).
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
import subprocess
import sys

import torch
import torch.nn.functional as F

B, HW, NF = 8, 224, 32
KERNELS = ("dwconv2d_wgrad", "hanc_block", "respath_level", "expand_dw", "selective_scan")
# name, map side, C
WGRAD = [("cnv12", HW, 3 * NF), ("cnv52", HW // 16, 48 * NF), ("cnv61", HW // 8, 48 * NF),
         ("cnv72", HW // 4, 136 * NF), ("unext.block1_0", HW // 16, 160),
         ("unext.block2_0", HW // 32, 256), ("unext.dblock2_0", HW // 8, 128)]
# name, map side, cin, E, cout, chained
BLOCKS = [("cnv12", HW, NF, 3 * NF, NF, False), ("cnv22", HW // 2, 2 * NF, 6 * NF, 2 * NF, True),
          ("cnv81", HW // 2, 4 * NF, 12 * NF, 2 * NF, False),
          ("cnv91", HW, 2 * NF, 6 * NF, NF, False)]
# name, map side, C, with the previous level's SE apply
RESPATH = [("rspth1.level0", HW, NF, False), ("rspth1.level1", HW, NF, True),
           ("rspth2.level1", HW // 2, 2 * NF, True)]
# name, x shape (cnv72: cin 128 -> E 4352)
EXPAND = [("cnv72.b8_224", (B, HW // 4, HW // 4, 4 * NF)), ("cnv72.w_b2_512", (2, 128, 128, 4 * NF))]
# Segmamba b8 224x224's BiMamba stages: name, L, d_inner (N 16)
SCAN = [(f"stage{i}", (HW // 2 >> i) ** 2, 2 * f) for i, f in enumerate((48, 96, 192, 384))]


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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tag", default="", help="a name for this tree, copied into every row")
    ap.add_argument("--json", default=None, help="write the rows here")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--only", nargs="+", choices=KERNELS, default=KERNELS,
                    help="time (and sweep) these kernels alone")
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--graphs", action="store_true")
    ap.add_argument("--models", action="store_true")
    ap.add_argument("--segmamba", action="store_true")
    ap.add_argument("--contig", action="store_true")
    args = ap.parse_args(argv)
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
    kernel_rows(args.iters, emit, args.only)
    if args.sweep:
        sweep_rows(args.iters, emit, args.only)
    GRAPHS = False
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
