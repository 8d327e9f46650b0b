#!/usr/bin/env python3
"""Time the hanc_mix kernel's tiles at the HANC layers of ACC_UNet b8 224x224.

    python tools/hanc_mix_sweep.py [--tiles 0 1 5] [--iters 20] [--json PATH]

On one CUDA card, for cnv11, cnv31, cnv61 and cnv72 (the shapes of
chip_smoke.py's phase 3), in fp32 (TF32 off) and bf16, and for each tile
(`hanc_mix.TILES`; 0 is the wrapper's own choice by shape): the kernel's
error against `hanc_mix_reference` (max abs error / max |plain|), the
kernel's time and the plain version's (CUDA events over --iters launches
after 3 warm-up). Prints one line per run and, with --json, writes them all.
Run from the root of a checkout. Where the package's `hanc_mix` takes no
`tile` (an older tree on PYTHONPATH), only tile 0 is timed.
"""

from __future__ import annotations

import argparse
import inspect
import json
import os
import subprocess
import sys

import torch

B = 8
# name, map side, C, Cout, k
LAYERS = [("cnv11", 224, 9, 3, 3), ("cnv31", 56, 192, 64, 3), ("cnv61", 28, 1536, 512, 2),
          ("cnv72", 56, 4352, 128, 3)]


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
    ap.add_argument("--tiles", type=int, nargs="+", default=None,
                    help="tiles to time (default: 0 and every key of TILES)")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--json", default=None, help="write the rows here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("hanc_mix_sweep: needs a CUDA device", file=sys.stderr)
        return 2
    # appended, so that a tree on PYTHONPATH comes first
    sys.path.append(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from accunet_tpu_torch.ops.kernels import hanc_mix as HM

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    takes_tile = "tile" in inspect.signature(HM.hanc_mix).parameters
    tiles = args.tiles or [0, *sorted(getattr(HM, "TILES", {}))]
    if not takes_tile:
        tiles = [0]
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    g = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for name, hw, c, cout, k in LAYERS:
        for dt in (torch.float32, torch.bfloat16):
            x = (torch.randn(B, hw, hw, c, generator=g, device="cuda")).to(dt)
            w = torch.randn(c, 2 * k - 1, cout, generator=g, device="cuda") * c ** -0.5
            bias = torch.randn(cout, generator=g, device="cuda") * 0.1
            with torch.inference_mode():
                want = HM.hanc_mix_reference(x, w, bias, k).float()
                plain_ms = time_ms(lambda: HM.hanc_mix_reference(x, w, bias, k), args.iters)
                for tile in tiles:
                    kw = {"tile": tile} if takes_tile else {}
                    run = lambda: HM.hanc_mix(x, w, bias, k, **kw)  # noqa: E731
                    got = run().float()
                    rel = float((got - want).abs().max()) / float(want.abs().max())
                    ms = time_ms(run, args.iters)
                    label = getattr(HM, "TILES", {}).get(tile, "by shape")
                    row = {"layer": name, "dtype": str(dt)[6:], "tile": tile, "tile_shape": label,
                           "ms": ms, "plain_ms": plain_ms, "rel_err": rel, "card": card}
                    rows.append(row)
                    print(f"{name} {row['dtype']:8s} tile {tile} ({label:10s}) kernel {ms:8.3f} ms"
                          f"  plain {plain_ms:8.3f} ms  rel err {rel:.2e}", flush=True)
            del x, w, bias, want
            torch.cuda.empty_cache()
    if args.json:
        with open(args.json, "w") as f:
            json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
