"""Profiling entry point of the port (counterpart of accunet_tpu/cli/profile.py).

    python -m accunet_tpu_torch.cli.profile --model ACC_UNet --img 224 --batch 8 \
        [--dtype bfloat16] [--steps 5] [--device cuda] [--train] [--channels 3] \
        [--trace DIR]
    python -m accunet_tpu_torch.cli.profile --model Segmamba [--train]
    python -m accunet_tpu_torch.cli.profile --n-classes 2 [--train] \
        --model Segmamba_hybrid_gsc_KAN_PE_ds_CrossAttn_HSLCA_SpatialMamba_no_text
    python -m accunet_tpu_torch.cli.profile --model Segmamba_hybrid_gsc_KAN_PE_ds_CrossAttn_HSLCA \
        --n-classes 2 --text [--train --batch 4]
    python -m accunet_tpu_torch.cli.profile --model UNext [--dtype bfloat16] [--train]
    python -m accunet_tpu_torch.cli.profile --model ACC_UNet_W --img 512 --batch 2 \
        [--model-kwargs "{'hybrid_expand_dw': True}"]

ACC-UNet models are built with n_classes=1, as the JAX profile CLI does
(accunet_tpu/cli/profile.py:42): for a multi-class configuration the 1x1
head has 1 output channel instead of n_classes+1 (4 for 3 classes), which is
noise beside the rest of the model. SegMamba models are built with
out_chans=--n-classes (1 by default), as the train CLIs build them; with
--n-classes > 1 the train step takes multiclass_dice_ce on class ids
0..n_classes (a deep-supervision model's binary loss raises, as in JAX).

Runs the model with seeded random weights on one CUDA device, in eval mode
(a forward per step) or with --train a train step (train-mode forward, the
model's configured loss, backward, Adam), and prints, for one batch of
--channels-channel images of the given size:
  - the parameter count;
  - ms per step and img/s: CUDA events over --steps steps after warm-up;
  - module spans: CUDA events in forward pre/post hooks on the model's
    top-level modules, the forward of one step;
  - the port kernels' launches per step (the wrappers' counters);
  - torch.profiler over --steps steps: the window per step (CUDA events,
    profiler on), device busy time (union of the device kernel and copy
    intervals) and its share of the profiler-off wall time above (the
    profiler's own host cost stretches its window, not the kernels), device
    kernels per step, device time per kernel family and the top device
    kernels.
With --trace DIR the profiled steps also run one `record_function` range per
top-level module (utils/trace_report.py `module_ranges`), the Chrome trace
goes to DIR/trace.json, and the report's per-module and top-op tables
(`module_times`, `top_ops`) print, with the report's device time per step
beside the CUDA-event time per step of the same profiled window.
--dtype bfloat16 builds the model with dtype=torch.bfloat16 (fp32 parameters
cast at use, as the train CLI trains under train.compute_dtype=bfloat16);
SegMamba models take no dtype and run in fp32, as in JAX.
fp32 runs with TF32 off in cuDNN and matmuls, as chip_smoke.py times it.
Raises when CUDA is unavailable; it never profiles on the CPU.
"""

from __future__ import annotations

import argparse
import ast
import contextlib
import os
from collections import defaultdict

# device-kernel name fragment -> family (first match wins)
FAMILIES = (
    ("selective_scan_rh_fwd", "selective_scan_rh_fwd"),
    ("selective_scan_rh_bwd", "selective_scan_rh_bwd"),  # (its reduce launch is the next one's)
    ("selective_scan_fwd_kernel", "selective_scan_fwd"),
    ("selective_scan_bwd", "selective_scan_bwd"),  # the kernel and its reduce launch
    ("linear_scan_kernel<true>", "linear_scan_reverse"),
    ("linear_scan_kernel<false>", "linear_scan"),
    ("hanc_block_kernel", "hanc_block"),
    ("respath_level_kernel", "respath_level"),
    ("hanc_mix_kernel", "hanc_mix"),
    ("expand_dw_kernel", "expand_dw"),
    ("dwconv_wgrad", "dwconv2d_wgrad"),
    # the library's depthwise / grouped convs (cuDNN's conv2d_c1_k1_nhwc for
    # a depthwise 3x3 on NHWC, its grouped direct kernel, torch's own), apart
    # from the hand-written kernels above and the dense convs below
    ("conv2d_c1_k1", "grouped conv (library)"),
    ("depthwise", "grouped conv (library)"),
    ("grouped", "grouped conv (library)"),
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
    ap.add_argument("--n-classes", type=int, default=1,
                    help="SegMamba models' head width; > 1 trains with multiclass_dice_ce")
    ap.add_argument("--train", action="store_true",
                    help="profile a train step instead of a forward")
    ap.add_argument("--channels", type=int, default=3, help="input channels")
    ap.add_argument("--text", action="store_true",
                    help="give a text-conditioned SegMamba model FakeTextEncoder embeddings "
                         "(B, 16, 768) of --batch prompts as its text_tokens")
    ap.add_argument("--trace", default=None,
                    help="write the profiled steps' Chrome trace (with module ranges) to "
                         "DIR/trace.json and print its report")
    args = ap.parse_args(argv)

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from accunet_tpu_torch.config import get_config
    from accunet_tpu_torch.models import build as build_model, init_parameters
    from accunet_tpu_torch.ops.kernels.dwconv2d import dwconv2d_wgrad
    from accunet_tpu_torch.ops.kernels.expand_dw import expand_dw
    from accunet_tpu_torch.ops.kernels.hanc_block import hanc_block
    from accunet_tpu_torch.ops.kernels.hanc_mix import hanc_mix
    from accunet_tpu_torch.ops.kernels.respath import respath_level
    from accunet_tpu_torch.ops.kernels.scan import linear_scan, linear_scan_reverse
    from accunet_tpu_torch.ops.kernels.selective_scan import (selective_scan_bwd,
                                                              selective_scan_fwd,
                                                              selective_scan_rh_bwd,
                                                              selective_scan_rh_fwd)
    from accunet_tpu_torch.train import losses as L
    from accunet_tpu_torch.train import metrics as M
    from accunet_tpu_torch.utils import trace_report

    device = torch.device(args.device)
    if device.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device}: profiling needs an available CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dtype = getattr(torch, args.dtype)
    kwargs = ast.literal_eval(args.model_kwargs) if args.model_kwargs else {}
    if args.model.startswith("Segmamba"):  # SegMamba builders, as in JAX: no dtype
        model = build_model(args.model, in_chans=args.channels, out_chans=args.n_classes, **kwargs)
        if dtype != torch.float32:
            print(f"{args.model} takes no compute dtype and runs in float32, as in JAX")
            args.dtype, dtype = "float32", torch.float32
    else:
        model = build_model(args.model, n_channels=args.channels, n_classes=1, dtype=dtype,
                            **kwargs)
    init_parameters(model, torch.Generator().manual_seed(0))
    model = model.to(device).eval()
    gen = torch.Generator(device).manual_seed(1)
    x = torch.randn(args.batch, args.img, args.img, args.channels, device=device, generator=gen)
    text = None
    if args.text:
        from accunet_tpu_torch.nn.text import FakeTextEncoder

        text = torch.from_numpy(FakeTextEncoder()([f"prompt {i}" for i in range(args.batch)]))
        text = text.to(device)
    inputs = (x,) if text is None else (x, text)
    n_params = sum(p.numel() for p in model.parameters())
    kind = "train step" if args.train else "forward"
    print(f"model={args.model} input={args.batch}x{args.img}x{args.img}x{args.channels} "
          f"{args.dtype} {kind} on {torch.cuda.get_device_name(device)}, TF32 off")
    print(f"params: {n_params / 1e6:.2f} M")
    if args.train:
        from accunet_tpu_torch.train.engine import make_train_fns

        if args.n_classes > 1:
            fns = make_train_fns(model, loss_fn=L.multiclass_dice_ce,
                                 dice_show=L.multiclass_dice_show, iou_fn=M.multiclass_batch_iou)
            mask = torch.randint(0, args.n_classes + 1, (args.batch, args.img, args.img, 1),
                                 device=device, generator=gen).float()
        else:
            fns = make_train_fns(model, loss_fn=L.LOSSES[get_config(args.model).train.loss])
            mask = (torch.rand(args.batch, args.img, args.img, 1, device=device, generator=gen)
                    > 0.5).float()

        def step():
            fns.train_step(fns.state, {"image": x, "mask": mask, "text_emb": text})
    else:
        def step():
            model(*inputs)

    def timed(n):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(n):
            step()
        end.record()
        torch.cuda.synchronize(device)
        return start.elapsed_time(end) / n

    with contextlib.nullcontext() if args.train else torch.inference_mode():
        for _ in range(3):
            step()
        torch.cuda.synchronize(device)
        ms = timed(args.steps)
        print(f"wall: {ms:.3f} ms/step ({args.batch * 1e3 / ms:.1f} img/s), "
              f"CUDA events over {args.steps} steps")

        spans, hooks = {}, []
        for name, mod in model.named_children():
            def pre(_m, _i, name=name):
                spans[name] = [torch.cuda.Event(enable_timing=True)]
                spans[name][0].record()

            def post(_m, _i, _o, name=name):
                spans[name].append(torch.cuda.Event(enable_timing=True))
                spans[name][1].record()

            hooks += [mod.register_forward_pre_hook(pre), mod.register_forward_hook(post)]
        counters = {"hanc_block": hanc_block, "respath_level": respath_level,
                    "hanc_mix": hanc_mix, "expand_dw": expand_dw, "dwconv2d_wgrad": dwconv2d_wgrad,
                    "linear_scan": linear_scan, "linear_scan_reverse": linear_scan_reverse,
                    "selective_scan_fwd": selective_scan_fwd,
                    "selective_scan_bwd": selective_scan_bwd,
                    "selective_scan_rh_fwd": selective_scan_rh_fwd,
                    "selective_scan_rh_bwd": selective_scan_rh_bwd}
        for fn in counters.values():
            fn.launches = 0
        step()
        torch.cuda.synchronize(device)
        for h in hooks:
            h.remove()
        print(f"launches per {kind}: "
              + ", ".join(f"{k} {fn.launches}" for k, fn in counters.items()))
        span_ms = sorted(((s.elapsed_time(e), n) for n, (s, e) in spans.items()), reverse=True)
        print("module spans (ms, the forward of one step): "
              + ", ".join(f"{n} {t:.3f}" for t, n in span_ms)
              + f"; sum {sum(t for t, _ in span_ms):.3f}")

        ranges = trace_report.module_ranges(model) if args.trace else contextlib.nullcontext()
        with ranges, profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            window = timed(args.steps)

    # device work only: the optimizer's step also shows as a device-side user
    # annotation that spans the kernels it launches
    dev_events = [e for e in prof.events()
                  if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
    intervals = [(e.time_range.start, e.time_range.end) for e in dev_events]
    busy = busy_us(intervals) / 1e3 / args.steps
    by_family, by_kernel = defaultdict(float), defaultdict(lambda: [0.0, 0])
    for e, (s, t) in zip(dev_events, intervals):
        by_family[kernel_family(e.name)] += (t - s) / 1e3 / args.steps
        by_kernel[e.name][0] += (t - s) / 1e3 / args.steps
        by_kernel[e.name][1] += 1
    print(f"profiler: device busy {busy:.3f} ms/step = {100 * busy / ms:.1f}% of the wall "
          f"time without the profiler ({ms:.3f} ms); window with it {window:.3f} ms; "
          f"{len(dev_events) / args.steps:.0f} device kernels per step")
    for fam, t in sorted(by_family.items(), key=lambda kv: -kv[1]):
        print(f"  {t:8.3f} ms  {fam}")
    print("top device kernels (ms per step, launches per step):")
    for name, (t, n) in sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:15]:
        print(f"  {t:8.3f} ms  x{n / args.steps:4.0f}  {name[:100]}")
    out = {"ms_per_batch": ms, "window_ms": window, "busy_ms": busy, "busy_share": busy / ms,
           "kernels_per_forward": len(dev_events) / args.steps,
           "families_ms": dict(by_family), "spans_ms": {n: t for t, n in span_ms}}
    if args.trace:
        os.makedirs(args.trace, exist_ok=True)
        path = os.path.join(args.trace, "trace.json")
        prof.export_chrome_trace(path)
        modules = trace_report.module_times(args.trace, steps=args.steps)
        ops = trace_report.top_ops(args.trace, n=15, steps=args.steps)
        print(f"trace written to {path}; per-module device time (ms per {kind}):")
        for mod, t in modules[:25]:
            print(f"  {t:8.3f}  {mod}")
        print("top device ops (ms per step, module):")
        for name, t, mod in ops:
            print(f"  {t:8.3f}  {name[:60]:60s} {mod}")
        trace_ms = modules[-1][1]
        print(f"trace report: {trace_ms:.3f} ms of device work per {kind} (kernel and copy "
              f"times summed) beside {window:.3f} ms per {kind} by CUDA events over the same "
              f"profiled window")
        out.update(trace_dir=args.trace, trace_ms=trace_ms, trace_modules=modules,
                   trace_top_ops=ops)
    return out


if __name__ == "__main__":
    main()
