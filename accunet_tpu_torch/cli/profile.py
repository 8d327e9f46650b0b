"""Profiling entry point of the port (counterpart of accunet_tpu/cli/profile.py).

    python -m accunet_tpu_torch.cli.profile --model ACC_UNet --img 224 --batch 8 \
        [--dtype bfloat16] [--steps 5] [--device cuda]

Runs the model in eval mode with seeded random weights on one CUDA device
and prints, for one batch of 3-channel images of the given size:
  - the parameter count;
  - ms per batch and img/s: CUDA events over --steps forwards after warm-up;
  - module spans: CUDA events in forward pre/post hooks on the model's
    top-level modules, one forward;
  - the port kernels' launches per forward (the wrappers' counters);
  - torch.profiler over --steps forwards: the window per batch (CUDA events,
    profiler on), device busy time (union of the device kernel and copy
    intervals) and its share of the window, device kernels per forward,
    device time per kernel family and the top device kernels.
Raises when CUDA is unavailable; it never profiles on the CPU.
"""

from __future__ import annotations

import argparse
import ast
from collections import defaultdict

# device-kernel name fragment -> family (first match wins)
FAMILIES = (
    ("hanc_block_kernel", "hanc_block"),
    ("respath_level_kernel", "respath_level"),
    ("hanc_mix_kernel", "hanc_mix"),
    ("batch_norm", "batchnorm"),
    ("bn_fw", "batchnorm"),
    ("gemm", "gemm/conv"),
    ("cutlass", "gemm/conv"),
    ("xmma", "gemm/conv"),
    ("conv2d", "gemm/conv"),
    ("convolve", "gemm/conv"),
    ("memcpy", "copy/fill"),
    ("memset", "copy/fill"),
)


def kernel_family(name: str) -> str:
    """The family a device kernel's name belongs to; 'elementwise/other' for
    the rest (torch's elementwise, reduction and copy kernels)."""
    low = name.lower()
    for frag, fam in FAMILIES:
        if frag in low:
            return fam
    return "elementwise/other"


def busy_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="ACC_UNet")
    ap.add_argument("--img", type=int, default=224)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"])
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--model-kwargs", default=None,
                    help="python dict literal of extra model kwargs")
    ap.add_argument("--device", default="cuda", help="CUDA device, e.g. cuda, cuda:1")
    args = ap.parse_args(argv)

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from accunet_tpu_torch.models import build as build_model, init_parameters
    from accunet_tpu_torch.ops.kernels.hanc_block import hanc_block
    from accunet_tpu_torch.ops.kernels.hanc_mix import hanc_mix
    from accunet_tpu_torch.ops.kernels.respath import respath_level

    device = torch.device(args.device)
    if device.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device}: profiling needs an available CUDA device")
    dtype = getattr(torch, args.dtype)
    kwargs = ast.literal_eval(args.model_kwargs) if args.model_kwargs else {}
    model = build_model(args.model, n_channels=3, n_classes=1, **kwargs)
    init_parameters(model, torch.Generator().manual_seed(0))
    model = model.to(device=device, dtype=dtype).eval()
    x = torch.randn(args.batch, args.img, args.img, 3, device=device,
                    generator=torch.Generator(device).manual_seed(1))
    n_params = sum(p.numel() for p in model.parameters())
    print(f"model={args.model} input={args.batch}x{args.img}x{args.img}x3 "
          f"{args.dtype} on {torch.cuda.get_device_name(device)}")
    print(f"params: {n_params / 1e6:.2f} M")

    def timed(n):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(n):
            model(x)
        end.record()
        torch.cuda.synchronize(device)
        return start.elapsed_time(end) / n

    with torch.inference_mode():
        for _ in range(3):
            model(x)
        torch.cuda.synchronize(device)
        ms = timed(args.steps)
        print(f"wall: {ms:.3f} ms/batch ({args.batch * 1e3 / ms:.1f} img/s), "
              f"CUDA events over {args.steps} forwards")

        spans, hooks = {}, []
        for name, mod in model.named_children():
            def pre(_m, _i, name=name):
                spans[name] = [torch.cuda.Event(enable_timing=True)]
                spans[name][0].record()

            def post(_m, _i, _o, name=name):
                spans[name].append(torch.cuda.Event(enable_timing=True))
                spans[name][1].record()

            hooks += [mod.register_forward_pre_hook(pre), mod.register_forward_hook(post)]
        counters = {"hanc_block": hanc_block, "respath_level": respath_level, "hanc_mix": hanc_mix}
        for fn in counters.values():
            fn.launches = 0
        model(x)
        torch.cuda.synchronize(device)
        for h in hooks:
            h.remove()
        print("launches per forward: "
              + ", ".join(f"{k} {fn.launches}" for k, fn in counters.items()))
        span_ms = sorted(((s.elapsed_time(e), n) for n, (s, e) in spans.items()), reverse=True)
        print("module spans (ms, one forward): "
              + ", ".join(f"{n} {t:.3f}" for t, n in span_ms)
              + f"; sum {sum(t for t, _ in span_ms):.3f}")

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            window = timed(args.steps)

    dev_events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    intervals = [(e.time_range.start, e.time_range.end) for e in dev_events]
    busy = busy_us(intervals) / 1e3 / args.steps
    by_family, by_kernel = defaultdict(float), defaultdict(lambda: [0.0, 0])
    for e, (s, t) in zip(dev_events, intervals):
        by_family[kernel_family(e.name)] += (t - s) / 1e3 / args.steps
        by_kernel[e.name][0] += (t - s) / 1e3 / args.steps
        by_kernel[e.name][1] += 1
    print(f"profiler: window {window:.3f} ms/batch, device busy {busy:.3f} ms "
          f"({100 * busy / window:.1f}%), {len(dev_events) / args.steps:.0f} device "
          f"kernels per forward")
    for fam, t in sorted(by_family.items(), key=lambda kv: -kv[1]):
        print(f"  {t:8.3f} ms  {fam}")
    print("top device kernels (ms per forward, launches per forward):")
    for name, (t, n) in sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:15]:
        print(f"  {t:8.3f} ms  x{n / args.steps:4.0f}  {name[:100]}")
    return {"ms_per_batch": ms, "window_ms": window, "busy_ms": busy,
            "kernels_per_forward": len(dev_events) / args.steps,
            "families_ms": dict(by_family), "spans_ms": {n: t for t, n in span_ms}}


if __name__ == "__main__":
    main()
