#!/usr/bin/env python3
"""Time variants of the fused selective scan (csrc/selective_scan.cu) at the
BiMamba stage shapes of Segmamba b8 224x224.

    python tools/selective_scan_sweep.py [--iters N] [--json out.json] [--ablate]

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
    for fn in ("accunet_selective_scan_fwd", "accunet_selective_scan_bwd"):
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--json", default=None)
    ap.add_argument("--ablate", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("selective_scan_sweep: needs a CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    out_dir = os.path.join(_build.build_dir().parent, "selective_scan_sweep")
    os.makedirs(out_dir, exist_ok=True)
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
