#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (accunet_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

From the root of a checkout, with one CUDA device:
  1. prints the card's name and power limit (nvidia-smi);
  2. builds the hand-written kernels from accunet_tpu_torch/csrc (timed);
  3. holds each kernel against its plain PyTorch version at the shapes of
     ACC-UNet's main path (n_filts=32, 224x224, batch 8), in fp32 (TF32 off)
     and in bf16;
  4. runs ACC_UNet through the eval entry point (accunet_tpu_torch.cli.eval)
     on a synthetic ISIC-style npy folder, with seeded random weights, and
     checks that every kernel launched there;
  5. compares the whole model on the GPU (kernels) with the CPU (plain
     versions) at batch 1, fp32;
  6. times ACC_UNet b8 224x224 inference in fp32 and bf16 and each kernel
     against its plain version (CUDA events, warm-up excluded).
It prints a JSON line of the kernels, then as its last line
    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}
A failed phase raises, so the run exits non-zero and prints no result; so
does a host without CUDA or a directory without the package.
"""

from __future__ import annotations

import copy
import csv
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

B, HW, NF = 8, 224, 32  # the main path: ACC_UNet, n_filts=32, 224x224, batch 8
FP32_TOL = 1e-4  # max |kernel - plain| / max |plain| in fp32 (sums reassociate)
# bf16: both sides compute in fp32 from the same bf16 inputs and round once;
# a value on a rounding boundary may land one bf16 ulp (2^-8 relative) apart
BF16_TOL = 1e-2
# whole model, GPU (kernels) vs CPU (plain versions), fp32: relative error of
# the logits and of the block outputs, absolute error of the probabilities
MODEL_TOL = 1e-3


class SmokeError(RuntimeError):
    pass


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def rel_err(got, want) -> tuple[float, float]:
    """(max abs error, max abs error / max |want|) over fp32 copies."""
    got, want = got.float(), want.float()
    if got.shape != want.shape:
        raise SmokeError(f"shape {tuple(got.shape)} != {tuple(want.shape)}")
    if not bool(got.isfinite().all()):
        raise SmokeError("non-finite kernel output")
    err = float((got - want).abs().max())
    return err, err / max(float(want.abs().max()), 1e-30)


def kernel_cases(dev):
    """(kernel name, case name, kernel fn, plain fn) at the main path's shapes,
    as closures over random inputs of dtype dt."""
    from accunet_tpu_torch.ops.kernels import hanc_block as HB
    from accunet_tpu_torch.ops.kernels import hanc_mix as HM
    from accunet_tpu_torch.ops.kernels import respath as RP

    g = torch.Generator(device=dev).manual_seed(0)

    def rn(*shape, s=1.0):
        return torch.randn(*shape, generator=g, device=dev) * s

    def block(cin, e, cout, k=3):
        f = lambda n: 1.0 / n ** 0.5  # noqa: E731
        bns = {n: (1 + rn(d, s=0.1), rn(d, s=0.1))
               for n, d in [("norm1", e), ("norm2", e), ("hnc", cin), ("norm", cin), ("norm3", cout)]}
        return HB.fold(rn(cin, e, s=f(cin)), rn(e, s=0.1), rn(3, 3, e, s=f(9)), rn(e, s=0.1),
                       rn(e, 2 * k - 1, cin, s=f(e)), rn(cin, s=0.1), rn(cin, cout, s=f(cin)),
                       rn(cout, s=0.1), bns)

    def cases(dt):
        out = []
        # HANCBlock bodies: cnv12, cnv22 (chained: cnv21's SE in the prologue), cnv91
        for name, hw, cin, e, cout, chained in [("cnv12", HW, NF, 3 * NF, NF, False),
                                                ("cnv22", HW // 2, 2 * NF, 6 * NF, 2 * NF, True),
                                                ("cnv91", HW, 2 * NF, 6 * NF, NF, False)]:
            x, p = rn(B, hw, hw, cin).to(dt), block(cin, e, cout)
            pre = torch.stack([0.5 + rn(B, cin, s=0.1), rn(B, cin, s=0.1)], 1).contiguous() \
                if chained else None
            out.append(("hanc_block", name,
                        lambda x=x, p=p, pre=pre: HB.hanc_block(x, p, 3, pre),
                        lambda x=x, p=p, pre=pre: HB.hanc_block_reference(x, p, 3, pre)))
        # ResPath levels: rspth1 level 0 and a later level, rspth2 a later level
        for name, hw, c, prev in [("rspth1.level0", HW, NF, False), ("rspth1.level1", HW, NF, True),
                                  ("rspth2.level1", HW // 2, 2 * NF, True)]:
            args = [rn(B, hw, hw, c).to(dt), rn(3, 3, c, c, s=1 / (9 * c) ** 0.5),
                    1 + rn(c, s=0.1), rn(c, s=0.1)]
            if prev:
                args += [rn(B, hw, hw, c).to(dt), torch.rand(B, c, generator=g, device=dev),
                         1 + rn(c, s=0.1), rn(c, s=0.1)]
            out.append(("respath_level", name,
                        lambda a=args: RP.respath_level(*a),
                        lambda a=args: RP.respath_level_reference(*a)))
        # HANC mixes of the unfused blocks: cnv11 (E=9), cnv31, cnv61 (k=2), cnv72 (E=4352)
        for name, hw, c, cout, k in [("cnv11", HW, 9, 3, 3), ("cnv31", HW // 4, 6 * NF, 2 * NF, 3),
                                     ("cnv61", HW // 8, 48 * NF, 16 * NF, 2),
                                     ("cnv72", HW // 4, 136 * NF, 4 * NF, 3)]:
            args = [rn(B, hw, hw, c).to(dt), rn(c, 2 * k - 1, cout, s=1 / c ** 0.5),
                    rn(cout, s=0.1), k]
            out.append(("hanc_mix", name, lambda a=args: HM.hanc_mix(*a),
                        lambda a=args: HM.hanc_mix_reference(*a)))
        return out

    return cases


def check_kernels(cases):
    """Phase 3. Returns {kernel: max abs error in fp32}; raises after
    reporting every disagreement."""
    worst, bad = {}, []
    for dt, tol in ((torch.float32, FP32_TOL), (torch.bfloat16, BF16_TOL)):
        for kname, cname, kern, plain in cases(dt):
            got = kern()
            torch.cuda.synchronize()
            want = plain()
            torch.cuda.synchronize()
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            errs = []
            for i, (g_, w_) in enumerate(zip(got, want)):
                if kname in ("hanc_block", "respath_level") and i == len(got) - 1:
                    g_, w_ = g_.sum(dim=1), w_.sum(dim=1)  # per-tile sums -> per image
                errs.append(rel_err(g_, w_))
            abs_err = max(e[0] for e in errs)
            rel = max(e[1] for e in errs)
            ok = rel <= tol
            log(f"  {'ok ' if ok else 'BAD'} {kname:13s} {cname:14s} {str(dt)[6:]:8s} "
                f"max_abs_err {abs_err:.3e}  rel {rel:.3e}  (tol {tol:g})")
            if dt == torch.float32:
                worst[kname] = max(worst.get(kname, 0.0), abs_err)
            if not ok:
                bad.append(f"{kname} {cname} {dt}")
            del got, want
    if bad:
        raise SmokeError(f"kernels disagree with their plain versions: {bad}")
    return worst


def run_eval_cli(counters):
    """Phase 4: the eval entry point on a synthetic ISIC-style folder."""
    from accunet_tpu_torch.cli import eval as cli

    with tempfile.TemporaryDirectory() as tmp:
        rs = np.random.default_rng(0)
        for sub in ("images", "masks"):
            os.makedirs(os.path.join(tmp, "data", sub))
        n = 2 * B
        for i in range(n):
            np.save(os.path.join(tmp, "data", "images", f"isic{i:03d}.npy"),
                    rs.random((4, HW, HW), dtype=np.float32))
            np.save(os.path.join(tmp, "data", "masks", f"isic{i:03d}.npy"),
                    (rs.random((HW, HW)) > 0.5).astype(np.float32))
        argv = ["--model", "ACC_UNet", "--test-dir", os.path.join(tmp, "data"),
                "--img-size", str(HW), "--batch", str(B), "--device", "cuda",
                "--csv", os.path.join(tmp, "m.csv"), "--result", os.path.join(tmp, "test.result"),
                "--dump-dir", os.path.join(tmp, "dump")]
        for fn in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        res = cli.main(argv)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = {name: fn.launches for name, fn in counters.items()}
        if res.n_images != n:
            raise SmokeError(f"eval saw {res.n_images} images, expected {n}")
        with open(os.path.join(tmp, "m.csv")) as f:
            rows = list(csv.DictReader(f))
        if len(rows) != n or not all(0.0 <= float(r["dice"]) <= 1.0 for r in rows):
            raise SmokeError("metrics CSV incomplete or dice out of range")
        for name in sorted(os.listdir(os.path.join(tmp, "dump"))):
            out = np.load(os.path.join(tmp, "dump", name))["output"]
            if out.shape != (HW, HW, 1) or not np.isfinite(out).all():
                raise SmokeError(f"{name}: output {out.shape} not finite (HW, HW, 1)")
    missing = [k for k, v in launches.items() if v == 0]
    if missing:
        raise SmokeError(f"the eval path never launched {missing}")
    log(f"  eval: {n} images in {seconds:.2f} s (build cached), dice {res.dice:.4f}, "
        f"{res.seconds_per_image * 1e3:.2f} ms/image timed forward; launches {launches}")
    return launches


def seeded_model():
    """ACC_UNet (n_filts=32, logits) with seeded weights and BN statistics
    moved off their init values, so every folded affine is non-trivial."""
    from accunet_tpu_torch.models import ACC_UNet, init_parameters
    from accunet_tpu_torch.nn.acc_blocks import BatchNorm

    model = init_parameters(ACC_UNet(3, 1, NF, final_sigmoid=False),
                            torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(3)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, BatchNorm):
                c = mod.num_features
                mod.weight.copy_(1 + 0.1 * torch.randn(c, generator=g))
                mod.bias.copy_(0.1 * torch.randn(c, generator=g))
                mod.running_mean.copy_(0.1 * torch.randn(c, generator=g))
                mod.running_var.copy_(1 + 0.1 * torch.rand(c, generator=g))
    return model.eval()


# block outputs compared besides the logits (the logits of a random model are
# small, the features are O(0.1-1))
TAPS = ("cnv12", "cnv22", "rspth1", "rspth2", "cnv72", "cnv82", "cnv92")


def forward_with_taps(model, x):
    feats = {}
    hooks = [getattr(model, n).register_forward_hook(
        lambda mod, inp, out, n=n: feats.__setitem__(n, out.float().cpu())) for n in TAPS]
    try:
        out = model(x).cpu()
    finally:
        for h in hooks:
            h.remove()
    return out, feats


def compare_model():
    """Phase 5: ACC_UNet fp32, GPU (kernels) vs CPU (plain versions), b1."""
    model = seeded_model()
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((1, HW, HW, 3), dtype=np.float32))
    with torch.inference_mode():
        t0 = time.perf_counter()
        want, want_f = forward_with_taps(model, x)
        cpu_s = time.perf_counter() - t0
        got, got_f = forward_with_taps(copy.deepcopy(model).cuda(), x.cuda())
    worst = 0.0
    for n in TAPS:
        abs_err, rel = rel_err(got_f[n], want_f[n])
        worst = max(worst, rel)
        log(f"  {n:7s} {tuple(want_f[n].shape)}: max_abs_err {abs_err:.3e} (rel {rel:.3e})")
    abs_err, rel = rel_err(got, want)
    prob_err = float((torch.sigmoid(got) - torch.sigmoid(want)).abs().max())
    log(f"  logits: max_abs_err {abs_err:.3e} (rel {rel:.3e}, |logit| <= "
        f"{float(want.abs().max()):.3g}); probabilities max_abs_err {prob_err:.3e}; "
        f"CPU forward {cpu_s:.1f} s")
    if max(worst, rel, prob_err) > MODEL_TOL:
        raise SmokeError("whole model on the GPU disagrees with the CPU")
    return model


def time_model(model):
    """Phase 6a: ACC_UNet b8 224x224 inference, fp32 and bf16."""
    x = torch.randn(B, HW, HW, 3, device="cuda", generator=torch.Generator("cuda").manual_seed(2))
    rates = {}
    for dt in (torch.float32, torch.bfloat16):
        m = copy.deepcopy(model).to(device="cuda", dtype=dt)
        torch.cuda.reset_peak_memory_stats()
        with torch.inference_mode():
            out = m(x)
            if not bool(out.isfinite().all()):
                raise SmokeError(f"non-finite model output in {dt}")
            ms = time_ms(lambda: m(x), iters=10, warmup=3)
        name = str(dt)[6:]
        rates[name] = {"ms_per_batch": ms, "img_per_s": B * 1e3 / ms,
                       "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
        log(f"  ACC_UNet b{B} {HW}x{HW} {name}: {ms:.3f} ms/batch, {B * 1e3 / ms:.1f} img/s, "
            f"peak {rates[name]['peak_mem_gib']:.2f} GiB")
        del m
    return rates


def time_kernels(cases):
    """Phase 6b: each kernel vs its plain version, per case, fp32 and bf16."""
    times = {}
    for dt in (torch.float32, torch.bfloat16):
        for kname, cname, kern, plain in cases(dt):
            with torch.inference_mode():
                k_ms, p_ms = time_ms(kern), time_ms(plain)
            times[(kname, cname, str(dt)[6:])] = (k_ms, p_ms)
            log(f"  {kname:13s} {cname:14s} {str(dt)[6:]:8s} kernel {k_ms:8.3f} ms   "
                f"plain {p_ms:8.3f} ms")
    return times


def ptxas_summary(log_text: str) -> str:
    regs = [int(m) for m in re.findall(r"Used (\d+) registers", log_text)]
    spills = [int(m) for m in re.findall(r"(\d+) bytes spill stores", log_text)]
    return (f"{len(regs)} kernels, registers max {max(regs, default=0)}, "
            f"spill stores max {max(spills, default=0)} bytes")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    try:
        from accunet_tpu_torch.nn import acc_blocks  # noqa: F401
        from accunet_tpu_torch.ops.kernels import _build
        from accunet_tpu_torch.ops.kernels.hanc_block import hanc_block
        from accunet_tpu_torch.ops.kernels.hanc_mix import hanc_mix
        from accunet_tpu_torch.ops.kernels.respath import respath_level
    except ImportError as e:
        print(f"chip_smoke: run from the root of the repository ({e})", file=sys.stderr)
        return 2
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    dev = torch.device("cuda", 0)

    log("[1] device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    log(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}, "
        f"{torch.cuda.device_count()} device(s)")

    log("[2] build")
    t0 = time.perf_counter()
    _build.load_library()
    build_log = _build.build_dir() / "build.log"
    log(f"  built in {time.perf_counter() - t0:.1f} s into {_build.build_dir()}; "
        + (ptxas_summary(build_log.read_text()) if build_log.exists() else "no build log"))

    log("[3] kernels vs plain versions (main-path shapes, b8)")
    cases = kernel_cases(dev)
    worst = check_kernels(cases)

    log("[4] ACC_UNet through accunet_tpu_torch.cli.eval on cuda")
    counters = {"hanc_block": hanc_block, "respath_level": respath_level, "hanc_mix": hanc_mix}
    launches = run_eval_cli(counters)

    log("[5] whole model, GPU vs CPU")
    model = compare_model()

    log("[6] timing")
    rates = time_model(model)
    times = time_kernels(cases)
    log("  " + json.dumps({"card": card, "acc_unet": rates}))

    timed_case = {"hanc_block": "cnv91", "respath_level": "rspth1.level1", "hanc_mix": "cnv72"}
    meta = {
        "hanc_block": ("accunet_tpu_torch/csrc/hanc_block.cu",
                       "accunet_tpu/ops/pallas/hanc_block.py:335"),
        "respath_level": ("accunet_tpu_torch/csrc/respath_level.cu",
                          "accunet_tpu/ops/pallas/respath.py:72"),
        "hanc_mix": ("accunet_tpu_torch/csrc/hanc_mix.cu", "accunet_tpu/ops/pallas/hanc.py:154"),
    }
    kernels = []
    for name, (source, replaces) in meta.items():
        k_ms, p_ms = times[(name, timed_case[name], "float32")]
        kernels.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                        "launches": launches[name], "max_abs_err": worst[name],
                        "ms": k_ms, "plain_ms": p_ms, "shape": f"{timed_case[name]} fp32 b{B}"})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
