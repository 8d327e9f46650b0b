#!/usr/bin/env python3
"""Where hanc_mix's time goes: time variants of csrc/hanc_mix.cu, each with one
part of the kernel taken out, at cnv61 and cnv72 of ACC_UNet b8 224x224.

    python tools/hanc_mix_ablate.py [--tiles 0 5] [--iters 20] [--json PATH]

On one CUDA card with nvcc. Each variant is the kernel's source with one
substitution (the variants' outputs are wrong by design and are not checked):
  base            the kernel as it is;
  no_promote      fp32 sums every 3xTF32 product into the accumulator (no
                  per-chunk fp32 add);
  no_pool         the pools are not computed (the pooled rows keep stale data);
  no_copies       no K-chunk is copied to shared memory;
  prepare_first   fp32 issues its copies and pools before its products, as bf16
                  does.
A variant's time below `base` is what that part costs. The profilers that
would show it directly (ncu, nsys) do not run on the card's machine. Each
variant builds into build/hanc_mix_ablate/ and is called through its C entry
point, as the wrapper calls the kernel. Run from the root of a checkout.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "accunet_tpu_torch" / "csrc" / "hanc_mix.cu"
OUT = ROOT / "build" / "hanc_mix_ablate"
B = 8
LAYERS = [("cnv61", 28, 1536, 512, 2), ("cnv72", 56, 4352, 128, 3)]
VARIANTS = {
    "base": [],
    "no_promote": [("kPromote = true, kPrepareFirst = false",
                    "kPromote = false, kPrepareFirst = false")],
    "no_pool": [("    if (ch + 1 < nchunks) pool(next);\n", ""), ("  pool(smem);\n", "")],
    "no_copies": [("    if (ch >= nchunks) return;\n", "    return;\n")],
    "prepare_first": [("kPromote = true, kPrepareFirst = false",
                       "kPromote = true, kPrepareFirst = true")],
}


def build(name: str, subs) -> Path:
    text = SRC.read_text()
    for old, new in subs:
        if old not in text:
            raise SystemExit(f"variant {name}: {old!r} is not in {SRC.name}")
        text = text.replace(old, new)
    cu, so = OUT / f"{name}.cu", OUT / f"{name}.so"
    cu.write_text(text)
    nvcc = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                    "-Xcompiler", "-fPIC", "-shared", "-I", str(SRC.parent), str(cu), "-o",
                    str(so)], check=True)
    return so


def time_ms(fn, iters: int) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tiles", type=int, nargs="+", default=[0],
                    help="the kernel's tiles (0: its own choice by shape)")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--json", default=None, help="write the rows here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("hanc_mix_ablate: needs a CUDA device", file=sys.stderr)
        return 2
    OUT.mkdir(parents=True, exist_ok=True)
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        libs = dict(zip(VARIANTS, pool.map(lambda kv: build(*kv), VARIANTS.items())))
    fns = {}
    for name, so in libs.items():
        fn = ctypes.CDLL(str(so)).accunet_hanc_mix
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[name] = fn
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    g = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for lname, hw, c, cout, k in LAYERS:
        for dt in (torch.float32, torch.bfloat16):
            x = torch.randn(B, hw, hw, c, generator=g, device="cuda").to(dt)
            w = (torch.randn(c, 2 * k - 1, cout, generator=g, device="cuda") * c ** -0.5).to(dt)
            bias = torch.zeros(cout, device="cuda")
            y = torch.empty(B, hw, hw, cout, device="cuda", dtype=dt)
            code, stream = int(dt == torch.bfloat16), torch.cuda.current_stream().cuda_stream
            for tile in args.tiles:
                row = {"layer": lname, "dtype": str(dt)[6:], "tile": tile, "card": card}
                for name, fn in fns.items():
                    call = lambda fn=fn: fn(x.data_ptr(), w.data_ptr(), bias.data_ptr(),  # noqa: E731
                                            y.data_ptr(), B, hw, hw, c, cout, k, tile, code,
                                            stream)
                    if call():
                        raise SystemExit(f"{name} refused {lname} tile {tile}")
                    row[name] = time_ms(call, args.iters)
                rows.append(row)
                print(f"{lname} {row['dtype']:8s} tile {tile} "
                      + " | ".join(f"{n} {row[n]:.3f}" for n in fns), flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
