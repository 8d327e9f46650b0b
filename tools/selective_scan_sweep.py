#!/usr/bin/env python3
"""Time variants of the fused selective scan (csrc/selective_scan.cu) at the
BiMamba stage shapes of Segmamba b8 224x224, or (--rh) of the return-hidden
scan at the Spatial-Mamba shapes.

    python tools/selective_scan_sweep.py [--iters N] [--json out.json] [--ablate] [--rh]

On one CUDA card: builds copies of selective_scan.cu with other values of
its design constants side by side (nvcc, one library per variant, in
build/selective_scan_sweep/), and times each variant's forward and backward
(the backward from that variant's own chunk states) per stage, fp32, CUDA
events over --iters calls after warm-up; checks each variant against this
tree's kernels (max abs error / max magnitude). The variants:
  * states: kFwdStates, the states the forward scans at once (1, 2, 4);
  * long: runs of 16 steps for L > 4096 (on) or 8 (off). With --ablate the variants are instead
the kernels as they are and with one part taken out (ABLATIONS: the exp2,
the shuffle scans, the shared-memory reads of B and C, the copies of the
next chunk's B and C, the softplus; in the backward the exp2, the scans,
the copies, the dB / dC reduction): where the time goes, since ncu does not
run there. An ablated variant computes wrong values (its error is not
reported); only its time is read. Prints one line per (stage, variant).

With --rh the kernels are selective_scan_rh_fwd / _bwd (the backward from
the variant's own chunk states, the cotangent laid out as (B, D, N, L) as the
model hands it over) at chip_smoke.py's RH_SHAPES but the odd one, each
variant's buffers sized by its own library's geometry query. The variants
(RH_VARIANTS): the steps a thread scans and the warps that split a chunk
(the chunk stays 128 steps: for N > 4 16 x 8 as built or 8 x 16, for N <=
4 the reverse); the CTAs of a backward cluster for N > 4 (4 as built, 2,
8: the d of a dB partial) and for N <= 4 (none as built, 2); and the
backward's 4 CTAs an SM for N > 4 (its register cap: 64) lowered to 3.
With --ablate instead (RH_ABLATIONS): the cluster's dB sum, the
reduce-scatters, the stores of du, ddelta and dB, the copies of the next
chunk, the conversion of delta (backward and forward), and the forward's
stores of h.
"""

from __future__ import annotations

import argparse
import ctypes
import itertools
import json
import os
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as C  # noqa: E402
from accunet_tpu_torch.ops.kernels import _build  # noqa: E402
from accunet_tpu_torch.ops.kernels import selective_scan as SS  # noqa: E402

VARIANTS = list(itertools.product((1, 2, 4), (True, False)))
# name -> (old text, new text) of selective_scan.cu; forward parts first
ABLATIONS = {
    "fwd_no_exp": ("a[j][k] = exp2f(dl[k] * a2);\n            x[j]",
                   "a[j][k] = fmaf(dl[k], a2, 1.f);\n            x[j]"),
    "fwd_no_scan": ("        scan_up(pa, pb, lane);\n        float ta", "        float ta"),
    "fwd_no_bc_reads": ("x[j][k] = du[k] * bn[k];", "x[j][k] = du[k];"),
    "fwd_no_bc_copies": ("stage_bc<K>(s, b, t0 + kChunk, nb, nb + s.ns * kRow);", ""),
    "fwd_no_softplus": ("(s.softplus ? softplus(rd[k] + bias) : rd[k] + bias)", "rd[k] + bias"),
    "bwd_no_exp": ("for (int k = 0; k < K; ++k) a[k] = exp2f(dl[k] * a2);",
                   "for (int k = 0; k < K; ++k) a[k] = fmaf(dl[k], a2, 1.f);"),
    "bwd_no_scans": ("        scan_up(pa, pb, lane);\n        const float carry = sS[n];",
                     "        const float carry = sS[n];"),
    "bwd_no_bc_copies": ("    stage_bc<K>(s, b, t0, sB, sC);\n", ""),
    "bwd_no_reduction": ("for (int e = threadIdx.x; e < 2 * kChunk; e += blockDim.x) {",
                         "for (int e = threadIdx.x; e < 0; e += blockDim.x) {"),
}


# name -> (old text, new text) pairs of selective_scan.cu (the return-hidden kernels)
RH_PLAN = ("  static constexpr int W = NP == 4 ? 16 : 8;\n"
           "  static constexpr int T = NP == 4 ? 8 : 16;\n")
RH_CTAS = "static constexpr int kBwdCtas = NP == 4 ? 1 : 4;"
RH_CLUSTER = "static constexpr int kCluster = NP == 4 ? 1 : 4;"
RH_VARIANTS = {
    "as_built": [],
    # N > 4 in 16 warps of 8 steps (512 threads: 2 backward CTAs an SM)
    "n_gt4_steps8_warps16": [(RH_PLAN, "  static constexpr int W = 16;\n"
                                       "  static constexpr int T = 8;\n"),
                             (RH_CTAS, "static constexpr int kBwdCtas = NP == 4 ? 1 : 2;")],
    # N <= 4 in 8 warps of 16 steps (3 backward CTAs an SM)
    "n_le4_steps16_warps8": [(RH_PLAN, "  static constexpr int W = 8;\n"
                                       "  static constexpr int T = 16;\n"),
                             (RH_CTAS, "static constexpr int kBwdCtas = NP == 4 ? 3 : 4;")],
    # N > 4 in clusters of 2 (dB partials per 4 d: twice the bytes) or 8
    "n_gt4_cluster2": [(RH_CLUSTER, "static constexpr int kCluster = NP == 4 ? 1 : 2;")],
    "n_gt4_cluster8": [(RH_CLUSTER, "static constexpr int kCluster = NP == 4 ? 1 : 8;")],
    # N <= 4 in clusters of 2
    "n_le4_cluster2": [(RH_CLUSTER, "static constexpr int kCluster = NP == 4 ? 2 : 4;")],
    # the backward for N > 4 at 3 CTAs an SM (80 registers, no fourth CTA)
    "n_gt4_bwd_3_ctas": [(RH_CTAS, "static constexpr int kBwdCtas = NP == 4 ? 1 : 3;")],
}
RH_ABLATIONS = {
    "as_built": [],
    "bwd_no_cluster_sum": [("      cluster_wait();  // the cluster's dB of chunk c + 1 is in\n"
                            "      sum_cluster(c + 1);\n", ""),
                           ("    cluster_wait();\n    sum_cluster(0);\n", ""),
                           ("    if (kCluster > 1) cluster_arrive();  // this CTA's dB of chunk c is in\n",
                            ""),
                           ("    cluster_arrive();  // no CTA leaves while the cluster may still read "
                            "its dB\n    cluster_wait();\n", "")],
    "bwd_no_scatter": [("      reduce_scatter<H, 2>(sn, q, NP >> 1, LNP, iu[half], ou[half]);\n", ""),
                       ("      reduce_scatter<H, 1>(sd, q, kLanes >> 1, 5 - LNP, idb, ob);\n", "")],
    "bwd_no_grad_stores": [("    if (d < s.nd) {\n      const long long row",
                            "    if (false) {\n      const long long row"),
                           ("      if (ob && n < s.ns) {\n", "      if (false) {\n")],
    "bwd_no_copies": [("    if (c > 0) stage_raw(c - 1);\n", ""),
                      ("        if (c > 0) stage_bg(c - 1);\n", "")],
    "bwd_no_convert": [("    if (c > 0) rh_convert<NP, true>(s, d0, t0 - kRhChunk, raw, cur);\n", "")],
    "fwd_no_h_stores": [("        if (tw + k < s.L) o[k * step] = h;\n",
                         "        if (tw + k < s.L && h == 12345.f) o[k * step] = h;\n")],
    "fwd_no_convert": [("    if (c + 1 < nchunks)\n      rh_convert<NP, false>(",
                        "    if (false)\n      rh_convert<NP, false>(")],
}


def rh_source(src: str, edits) -> str:
    for old, new in edits:
        if src.count(old) != 1:
            raise RuntimeError(f"the text to replace is not in the source once: {old[:60]!r}")
        src = src.replace(old, new)
    return src


def variant_source(src: str, states: int, long_runs: bool) -> str:
    src = re.sub(r"constexpr int kFwdStates = \d+;", f"constexpr int kFwdStates = {states};", src)
    if not long_runs:
        src = src.replace("L > 4096 && ns <= 16", "false")
    return src


def build(out_dir: str, name: str, text: str):
    cu, so = os.path.join(out_dir, name + ".cu"), os.path.join(out_dir, name + ".so")
    with open(cu, "w") as f:
        f.write(text)
    r = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-shared", cu,
                        "-o", so], capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError(f"{name}: nvcc failed\n{(r.stdout + r.stderr)[-3000:]}")
    lib = ctypes.CDLL(so)
    for fn in ("accunet_selective_scan_fwd", "accunet_selective_scan_bwd",
               "accunet_selective_scan_rh_fwd", "accunet_selective_scan_rh_bwd",
               "accunet_selective_scan_rh_geometry"):
        getattr(lib, fn).argtypes = _build.SIGNATURES[fn]
        getattr(lib, fn).restype = ctypes.c_int
    return lib, re.findall(r"Used (\d+) registers", r.stdout + r.stderr)


def ptr(t):
    return 0 if t is None else t.data_ptr()


def run_variant(lib, long_runs, ops, gy, iters):
    """(fwd ms, bwd ms, outputs) of one variant on one stage's operands."""
    b, d, l = ops[0].shape
    n = ops[2].shape[1]
    k = SS.chunk_steps(l, n) if long_runs or l <= 4096 else 8
    f32 = dict(device="cuda", dtype=torch.float32)
    out, last = torch.empty_like(ops[0]), torch.empty(b, d, n, **f32)
    states = torch.empty(b, d, -(-l // (32 * k)), n, **f32)
    stream = torch.cuda.current_stream().cuda_stream

    def fwd(st=0):
        err = lib.accunet_selective_scan_fwd(*map(ptr, ops), ptr(out), ptr(last), st, b, d, l, n, 1,
                                             stream)
        if err:
            raise RuntimeError(f"forward failed with code {err}")

    fwd(ptr(states))
    blocks = -(-d // SS.BWD_WARPS)
    du, ddl, dz = (torch.empty_like(ops[0]) for _ in range(3))
    dB, dC = torch.empty(b, n, l, **f32), torch.empty(b, n, l, **f32)
    dA, dD, dbias = torch.empty(d, n, **f32), torch.empty(d, **f32), torch.empty(d, **f32)
    part = torch.empty(2, blocks, b, n, l, **f32) if blocks > 1 else None
    part_b = torch.empty(b, d, n + 2, **f32)

    def bwd():
        err = lib.accunet_selective_scan_bwd(
            *map(ptr, ops), ptr(states), ptr(gy), 0, ptr(du), ptr(ddl), ptr(dz),
            ptr(part[0] if blocks > 1 else dB), ptr(part[1] if blocks > 1 else dC), ptr(part_b),
            ptr(dA), ptr(dB), ptr(dC), ptr(dD), ptr(dbias), b, d, l, n, 1, stream)
        if err:
            raise RuntimeError(f"backward failed with code {err}")

    bwd()
    torch.cuda.synchronize()
    return (C.time_ms(fwd, iters=iters), C.time_ms(bwd, iters=iters),
            (out, du, ddl, dA, dB, dC, dD, dz, dbias))


def run_rh_variant(lib, ops, gh_dnl, iters):
    """(fwd ms, bwd ms, outputs) of one return-hidden variant on one shape's
    operands, its buffers sized by its own geometry."""
    b, d, l = ops[0].shape
    n = ops[2].shape[1]
    geo = (ctypes.c_int * 4)()
    if lib.accunet_selective_scan_rh_geometry(d, l, n, geo):
        raise RuntimeError("geometry query failed")
    _, n_chunks, _, blocks = geo
    f32 = dict(device="cuda", dtype=torch.float32)
    h = torch.empty(b, l, d, n, **f32)
    states = torch.empty(b, d, n_chunks, n, **f32)
    stream = torch.cuda.current_stream().cuda_stream

    def fwd(st=0):
        err = lib.accunet_selective_scan_rh_fwd(*map(ptr, ops), ptr(h), st, b, d, l, n, 1, stream)
        if err:
            raise RuntimeError(f"forward failed with code {err}")

    fwd(ptr(states))
    du, ddl = torch.empty_like(ops[0]), torch.empty_like(ops[0])
    dA, dB, dbias = torch.empty(d, n, **f32), torch.empty(b, n, l, **f32), torch.empty(d, **f32)
    part = torch.empty(blocks, b, n, l, **f32) if blocks > 1 else dB
    part_bd = torch.empty(b, d, n + 2, **f32)

    def bwd():
        err = lib.accunet_selective_scan_rh_bwd(
            *map(ptr, ops), ptr(states), ptr(gh_dnl), ptr(du), ptr(ddl), ptr(part), ptr(part_bd),
            ptr(dA), ptr(dB), ptr(dbias), b, d, l, n, 1, 1, stream)
        if err:
            raise RuntimeError(f"backward failed with code {err}")

    bwd()
    torch.cuda.synchronize()
    return C.time_ms(fwd, iters=iters), C.time_ms(bwd, iters=iters), (h, du, ddl, dA, dB, dbias)


def rh_main(args, card, out_dir) -> list:
    src = (_build.CSRC / "selective_scan.cu").read_text()
    edits = RH_ABLATIONS if args.ablate else RH_VARIANTS
    texts = {"rh_" + name: rh_source(src, e) for name, e in edits.items()}
    with ThreadPoolExecutor(8) as pool:
        built = dict(zip(texts, pool.map(lambda kv: build(out_dir, *kv), texts.items())))
    for name, (_, regs) in built.items():
        print(f"{name}: registers {regs}", flush=True)
    g = torch.Generator("cuda").manual_seed(29)
    rows = []
    for stage, b, l, d, n in C.RH_SHAPES[:-1]:
        ops, gh = C.rh_inputs(g, b, l, d, n)
        gh_dnl = gh.permute(0, 2, 3, 1).contiguous()
        want = None
        for name, (lib, _) in built.items():
            fwd_ms, bwd_ms, got = run_rh_variant(lib, ops, gh_dnl, args.iters)
            if want is None:
                want = got  # the first variant is the source as built
            err = (None if args.ablate and name != "rh_as_built"
                   else max(C.rel_err(p, q)[1] for p, q in zip(got, want)))
            rows.append({"stage": stage, "variant": name, "fwd_ms": fwd_ms, "bwd_ms": bwd_ms,
                         "rel_vs_as_built": err, "card": card})
            print(json.dumps(rows[-1]), flush=True)
            del got
        del ops, gh, gh_dnl, want
        torch.cuda.empty_cache()
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--json", default=None)
    ap.add_argument("--ablate", action="store_true")
    ap.add_argument("--rh", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("selective_scan_sweep: needs a CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    out_dir = os.path.join(_build.build_dir().parent, "selective_scan_sweep")
    os.makedirs(out_dir, exist_ok=True)
    if args.rh:
        rows = rh_main(args, card, out_dir)
        if args.json:
            with open(args.json, "w") as f:
                json.dump(rows, f, indent=1)
        return 0
    src = (_build.CSRC / "selective_scan.cu").read_text()
    if args.ablate:
        texts = {"as_is": src}
        for name, (old, new) in ABLATIONS.items():
            if src.count(old) != 1:
                raise RuntimeError(f"{name}: the text to take out is not in the source once")
            texts[name] = src.replace(old, new)
            if name == "bwd_no_scans":
                texts[name] = texts[name].replace("        scan_down(pa, pb, lane);\n", "")
        names = dict.fromkeys(texts, (0, True))
    else:
        names = {f"states{s}_long{'on' if lr else 'off'}": (s, lr) for s, lr in VARIANTS}
        texts = {name: variant_source(src, *v) for name, v in names.items()}
    with ThreadPoolExecutor(8) as pool:
        built = dict(zip(texts, pool.map(lambda kv: build(out_dir, *kv), texts.items())))
    for name, (_, regs) in built.items():
        print(f"{name}: registers {regs}", flush=True)
    g = torch.Generator("cuda").manual_seed(17)
    rows = []
    for stage, b, l, d in C.FUSED_STAGES:
        ops, gy = C.fused_inputs(g, b, l, d)
        out, _, states = SS.selective_scan_fwd(*ops, True, save_states=True)
        want = (out, *SS.selective_scan_bwd(*ops, True, states, gy))
        for name, (lib, _) in built.items():
            fwd_ms, bwd_ms, got = run_variant(lib, names[name][1], ops, gy, args.iters)
            err = (None if args.ablate and name != "as_is"
                   else max(C.rel_err(p, q)[1] for p, q in zip(got, want)))
            rows.append({"stage": stage, "variant": name, "fwd_ms": fwd_ms, "bwd_ms": bwd_ms,
                         "rel_vs_tree": err, "card": card})
            print(json.dumps(rows[-1]), flush=True)
        del ops, gy, out, states, want
        torch.cuda.empty_cache()
    if args.json:
        with open(args.json, "w") as f:
            json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
