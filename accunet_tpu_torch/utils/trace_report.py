"""Per-op and per-module device-time tables from a torch.profiler Chrome
trace, counterpart of accunet_tpu/utils/trace_report.py (which reads a
jax.profiler trace).

`module_ranges(model)` opens one `record_function` range named
"module:<name>" around each top-level module's forward (each entry of a
top-level ModuleList: "block1.0"); a trace taken with
it on (`cli/profile.py --trace DIR` writes DIR/trace.json) carries the
ranges on the host threads. The work events are the device's kernel, copy
and set events (a CUDA trace) or, in a trace without any, the outermost
host ops (a CPU trace). Each is attributed to the module ranges that enclose
its launch: a device event through its correlation id to the runtime call
that launched it, on that call's thread. A launch outside every module
range goes to the innermost other range around it: "(backward)" for the
autograd engine's backward ops, a `record_function` name such as the
optimizer's step, else "(other)".
"""

from __future__ import annotations

import collections
import contextlib
import glob
import gzip
import json
import os

PREFIX = "module:"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
BACKWARD = "autograd::engine::evaluate_function"


@contextlib.contextmanager
def module_ranges(model):
    """A `record_function` range around the forward of each of `model`'s
    top-level modules while the context is open. A module the model applies
    through its parameters, not its forward (UNext's 3x3 convs, ACC-UNet's
    head), gets none: its ops count as the model's own, "(other)"."""
    from torch.autograd.profiler import record_function

    from torch import nn

    open_ranges, hooks, mods = {}, [], []
    for name, mod in model.named_children():
        if isinstance(mod, (nn.ModuleList, nn.ModuleDict)):  # no forward of its own
            mods += [(f"{name}.{sub}", m) for sub, m in mod.named_children()]
        else:
            mods.append((name, mod))
    for name, mod in mods:
        def pre(_m, _i, name=name):
            rf = record_function(PREFIX + name)
            rf.__enter__()
            open_ranges.setdefault(name, []).append(rf)

        def post(_m, _i, _o, name=name):
            open_ranges[name].pop().__exit__(None, None, None)

        hooks += [mod.register_forward_pre_hook(pre), mod.register_forward_hook(post)]
    try:
        yield
    finally:
        for h in hooks:
            h.remove()


def trace_path(trace_dir: str) -> str:
    """The newest Chrome trace (*.json or *.json.gz) under `trace_dir`."""
    paths = glob.glob(os.path.join(trace_dir, "**", "*.json*"), recursive=True)
    paths = [p for p in paths if p.endswith((".json", ".json.gz"))]
    if not paths:
        raise FileNotFoundError(f"no Chrome trace (*.json, *.json.gz) under {trace_dir}")
    return max(paths, key=os.path.getmtime)


def _load(trace_dir: str) -> list[dict]:
    path = trace_path(trace_dir)
    with (gzip.open(path, "rt") if path.endswith(".gz") else open(path)) as f:
        trace = json.load(f)
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    return [e for e in events if e.get("ph") == "X"]


def _outermost(events: list[dict]) -> list[dict]:
    """The events of `events` that no other of them encloses on its thread."""
    out, by_thread = [], collections.defaultdict(list)
    for e in events:
        by_thread[(e.get("pid"), e.get("tid"))].append(e)
    for evs in by_thread.values():
        end = float("-inf")
        for e in sorted(evs, key=lambda e: (e["ts"], -e.get("dur", 0.0))):
            if e["ts"] >= end:
                out.append(e)
                end = e["ts"] + e.get("dur", 0.0)
    return out


def _work(events: list[dict]):
    """[(name, duration us, (pid, tid, ts) of its launch)]."""
    device = [e for e in events if e.get("cat") in DEVICE_CATS]
    if not device:
        cpu = _outermost([e for e in events if e.get("cat") == "cpu_op"
                          and not e["name"].startswith(BACKWARD)])
        return [(e["name"], e.get("dur", 0.0), (e.get("pid"), e.get("tid"), e["ts"]))
                for e in cpu]
    launches = {}
    for e in events:
        corr = e.get("args", {}).get("correlation")
        if corr is not None and e.get("cat") in ("cuda_runtime", "cuda_driver"):
            launches[corr] = (e.get("pid"), e.get("tid"), e["ts"])
    return [(e["name"], e.get("dur", 0.0), launches.get(e.get("args", {}).get("correlation")))
            for e in device]


def _ranges(events: list[dict]):
    """{(pid, tid): [(start, end, name)]} sorted by start, the outer of two
    ranges that start together first: the module ranges, the other
    record_function ranges and the autograd engine's backward ops."""
    by_thread = collections.defaultdict(list)
    for e in events:
        name = e["name"]
        if e.get("cat") == "cpu_op" and name.startswith(BACKWARD):
            name = "(backward)"
        elif e.get("cat") != "user_annotation":
            continue
        by_thread[(e.get("pid"), e.get("tid"))].append((e["ts"], e["ts"] + e.get("dur", 0.0), name))
    for rs in by_thread.values():
        rs.sort(key=lambda r: (r[0], -r[1]))
    return by_thread


def _paths(ranges, launches) -> list[list[str]]:
    """For each launch (pid, tid, ts) or None, the names of the ranges that
    enclose it on its thread, outermost first: one sweep per thread over
    its launches in time order, with the open ranges on a stack (ranges of
    one thread nest)."""
    out = [[] for _ in launches]
    by_thread = collections.defaultdict(list)
    for i, launch in enumerate(launches):
        if launch is not None:
            by_thread[launch[:2]].append((launch[2], i))
    for key, queries in by_thread.items():
        rs, stack, j = ranges.get(key, []), [], 0
        for ts, i in sorted(queries):
            while j < len(rs) and rs[j][0] <= ts:
                while stack and stack[-1][1] <= rs[j][0]:
                    stack.pop()
                stack.append(rs[j])
                j += 1
            while stack and stack[-1][1] <= ts:
                stack.pop()
            out[i] = [r[2] for r in stack]
    return out


def _module(path: list[str], depth: int) -> str:
    mods = [p[len(PREFIX):] for p in path if p.startswith(PREFIX)]
    if mods:
        return "/".join(mods[:depth])
    return path[-1] if path else "(other)"


def _attributed(trace_dir: str, depth: int):
    events = _load(trace_dir)
    work = _work(events)
    paths = _paths(_ranges(events), [launch for _, _, launch in work])
    return [(name, dur, _module(path, depth)) for (name, dur, _), path in zip(work, paths)]


def top_ops(trace_dir: str, n: int = 30, steps: int = 1):
    """[(op name, ms per step, module)], the n ops with the most time; the
    module is where the op first ran."""
    agg, src = collections.defaultdict(float), {}
    for name, dur, mod in _attributed(trace_dir, 1):
        agg[name] += dur
        src.setdefault(name, mod)
    rows = sorted(agg.items(), key=lambda kv: -kv[1])[:n]
    return [(name, us / 1e3 / steps, src[name]) for name, us in rows]


def module_times(trace_dir: str, steps: int = 1, depth: int = 1):
    """[(module, ms per step)] by time, then ("total", ms per step): the
    work events' time summed by the module ranges enclosing their launches
    (nested ranges joined by "/", `depth` of them kept)."""
    grp, total = collections.defaultdict(float), 0.0
    for _, dur, mod in _attributed(trace_dir, depth):
        grp[mod] += dur
        total += dur
    rows = [(m, us / 1e3 / steps) for m, us in sorted(grp.items(), key=lambda kv: -kv[1])]
    return rows + [("total", total / 1e3 / steps)]
