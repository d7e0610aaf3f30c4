#!/usr/bin/env python3
"""The stage account of a cell: where a step's host time, the device's idle
time and the kernel launches go, by the port's stage spans
(``tf_faster_rcnn_torch/utils/trace.py``).

    python3 frcnn_bench/stages.py --workload <cell> --seed <n> [--seconds 10]

runs the cell as ``run.py --trace 1`` does, with one difference in the
traced span: ``trace`` below takes the place of ``profiling.trace``. It
runs ``HOST_STEPS`` steps with the port's tracing on and no profiler, then
the profiled steps with the port's tracing on. The window runs with
tracing off, as in every run of the benchmark. Prints one
JSON line: the run's result (its per-layer metrics read from this trace),
the stage account, and the per-layer metrics that the stages would give
(``METRICS``), read by ``read``.

``trace`` returns every key of ``profiling.trace``, computed by the same
arithmetic, with one change: the device-side copies of the program's
``record_function`` ranges are left out of the device's busy time, as the
benchmark's own ``bench.*`` ranges are. Its two added keys:

* ``stages``, the reduction of the profiled events (``reduce``): for each
  program span its calls, the device idle seconds put down to it (the
  innermost program span at an idle gap's midpoint, the rule
  ``profiling.trace`` uses for ``bench.*``), and the kernel launch calls
  (the ``cudaLaunchKernel*`` and ``cuLaunchKernel*`` API events)
  that start inside it, on any thread: the backward's kernels are launched
  from autograd's own thread, inside ``train.backward``;
* ``stage_host``, the ``HOST_STEPS`` steps' ``trace.snapshot()`` reduced
  (``host_summary``): each span's median inclusive and self host ms a step,
  and the mean ms of the step's call. These steps run before the profiler
  (``trace`` says why) on images past the profiled steps'.
"""

from __future__ import annotations

import collections
import json
import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from frcnn_bench import profiling  # noqa: E402

__all__ = ["HOST_STEPS", "METRICS", "split", "reduce", "reduce_events",
           "host_summary", "host_ms", "step_launches", "read", "trace",
           "main"]

HOST_STEPS = 16
LAUNCHES = ("cudaLaunchKernel", "cuLaunchKernel")
# the suffix of a per-layer metric, by the end-to-end metric it moves
_SUFFIX = {"detect_images_per_s": "detect",
           "detect_latency_p95_ms": "latency",
           "train_images_per_s": "train"}


def split(events, names):
    """The profiled events by kind. events: kineto events (``name()``,
    ``start_ns()``, ``duration_ns()``, ``device_type()``); names: the
    program's span names. Returns dev [(start, end)] of kernels, copies
    and memsets (no range annotation: not ``bench.*``, not a program span),
    kernels {name: s}, nms [(start, s)] of K1/K2, bench [(start, end,
    name)] of ``profiling.SPANS``, spans [(start, end, name)] of the
    program's spans, and launches [start] of kernel launch calls, all on
    the host unless named dev."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    dev, bench, spans, launches, nms = [], [], [], [], []
    kernels = collections.Counter()
    for e in events:
        name, start, dur = e.name(), e.start_ns(), e.duration_ns()
        if e.device_type() == cuda:
            if dur <= 0 or name.startswith("bench.") or name in names:
                continue
            dev.append((start, start + dur))
            kernels[name] += dur / 1e9
            if "nms_keep" in name:
                nms.append((start, dur / 1e9))
        elif name in profiling.SPANS:
            bench.append((start, start + dur, name))
        elif name in names:
            spans.append((start, start + dur, name))
        elif name.startswith(LAUNCHES):
            launches.append(start)
    dev.sort()
    bench.sort()
    spans.sort()
    launches.sort()
    return {"dev": dev, "kernels": dict(kernels), "nms": sorted(nms),
            "bench": bench, "spans": spans, "launches": launches}


def _innermost(intervals, t):
    """The name of the last-starting interval that holds t, or None."""
    where = [n for s, e, n in intervals if s <= t <= e]
    return where[-1] if where else None


def reduce(dev, bench, spans, launches):
    """The traced span's timeline and stage account, from split's lists.

    Returns (timeline, stages). timeline: busy ns, t0 and t1 (ns), the
    idle gaps, and idle {bench span: s} as profiling.trace gives it.
    stages: "spans" {program span: {"calls", "idle_s", "launches"}}, where
    the span "" holds the idle and launches under no program span, and
    "in_bench" {bench span: idle s put down to program spans}."""
    t0 = min([s for s, _ in dev[:1]] + [h[0] for h in bench])
    t1 = max([e for _, e in dev] + [h[1] for h in bench])
    busy, end, gaps = 0, t0, []
    for s, e in dev:
        if s > end:
            gaps.append((end, s))
        if e > end:
            busy += e - max(s, end)
            end = e
    if t1 > end:
        gaps.append((end, t1))
    idle = collections.Counter()
    stages = {n: {"calls": 0, "idle_s": 0.0, "launches": 0}
              for _, _, n in spans}
    stages[""] = {"calls": 0, "idle_s": 0.0, "launches": 0}
    in_bench = collections.Counter()
    for g0, g1 in gaps:
        mid = (g0 + g1) / 2
        where = _innermost(bench, mid) or "bench.between_steps"
        idle[where] += (g1 - g0) / 1e9
        program = _innermost(spans, mid)
        stages[program or ""]["idle_s"] += (g1 - g0) / 1e9
        if program is not None:
            in_bench[where] += (g1 - g0) / 1e9
    for s, e, n in spans:
        stages[n]["calls"] += 1
        stages[n]["launches"] += sum(1 for t in launches if s <= t <= e)
    stages[""]["launches"] = sum(
        1 for t in launches if not any(s <= t <= e for s, e, _ in spans))
    return ({"busy": busy, "t0": t0, "t1": t1, "gaps": gaps,
             "idle": dict(idle)},
            {"spans": stages, "in_bench": dict(in_bench)})


def reduce_events(events, names, steps):
    """profiling.trace's dict of the profiled events, with the program's
    span annotations left out of the device's time, and its "stages" key
    (reduce). {} where no device op ran."""
    parts = split(events, names)
    if not parts["dev"]:
        return {}
    timeline, stages = reduce(parts["dev"], parts["bench"], parts["spans"],
                              parts["launches"])
    fams = collections.Counter()
    for name, s in parts["kernels"].items():
        fams[profiling.family(name)] += s
    return {"busy_s": timeline["busy"] / 1e9,
            "window_s": (timeline["t1"] - timeline["t0"]) / 1e9,
            "kernels": parts["kernels"], "families": dict(fams),
            "nms": [d for _, d in parts["nms"]], "idle": timeline["idle"],
            "device_ops": len(parts["dev"]), "steps": steps,
            "stages": stages}


def host_summary(snap, call_s=None):
    """stage_host: from a trace.snapshot(), each span's median inclusive
    and self host ms a step and its calls a step; call_ms, the mean ms of
    the steps' calls (call_s, seconds each), where given."""
    spans = {}
    for name, s in snap["spans"].items():
        spans[name] = {"ms": statistics.median(s["ms"]),
                       "self_ms": statistics.median(s["self_ms"]),
                       "calls_per_step": s["calls"] / len(s["steps"])}
    out = {"spans": spans,
           "steps": max((len(s["steps"]) for s in snap["spans"].values()),
                        default=0)}
    if call_s:
        out["call_ms"] = 1e3 * statistics.fmean(call_s)
    return out


def host_ms(record, span):
    """Median inclusive host ms a step of span, in the stage_host steps;
    None where the run recorded no such span."""
    s = (record.get("stage_host") or {}).get("spans", {}).get(span)
    return None if s is None else s["ms"]


def step_launches(record, span):
    """Kernel launch calls a step inside span, in the profiled steps; None
    where the trace holds no such span."""
    tr = record.get("trace") or {}
    s = (tr.get("stages") or {}).get("spans", {}).get(span)
    return None if s is None else s["launches"] / tr["steps"]


# the per-layer metrics of the stages, by suffix: name -> (reader, span)
_DETECT = {"head_host_ms": (host_ms, "model.head"),
           "rpn_host_ms": (host_ms, "model.rpn"),
           "roi_heads_host_ms": (host_ms, "model.roi_heads"),
           "postprocess_host_ms": (host_ms, "detect.postprocess"),
           "step_launches": (step_launches, "detect.step")}
METRICS = {
    "detect": _DETECT, "latency": _DETECT,
    "train": {"forward_host_ms": (host_ms, "train.forward"),
              "backward_host_ms": (host_ms, "train.backward"),
              "update_host_ms": (host_ms, "train.update"),
              "step_launches": (step_launches, "train.step")},
}


def read(record, suffix):
    """{"<name>.<suffix>": value} of METRICS[suffix], the Nones left
    out."""
    out = {}
    for name, (reader, span) in METRICS[suffix].items():
        value = reader(record, span)
        if value is not None:
            out[f"{name}.{suffix}"] = value
    return out


def trace(run, steps, host_steps=HOST_STEPS, calls=None):
    """profiling.trace(run, steps) with the port's tracing on and the two
    added keys (module docstring); calls: a list that the step's caller
    appends each call's seconds to, for stage_host's call_ms.

    The host steps run first, as run(steps), ..., run(steps + host_steps
    - 1), so the profiled steps run(0), ... take the images they take in
    profiling.trace: once a profiler has run, the process launches slower
    (a step's call 10.6 -> 16.6 ms with tracing off, vgg16-voc-detect-b1;
    PERF.md §6), and host ms taken after it would be the profiler's."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from tf_faster_rcnn_torch.utils import trace as port
    torch.cuda.synchronize()
    first = len(calls) if calls is not None else 0
    port.reset()
    port.enable()
    try:
        for i in range(steps, steps + host_steps):
            run(i)
        torch.cuda.synchronize()
    finally:
        port.disable()
    host = host_summary(port.snapshot(),
                        calls[first:] if calls is not None else None)
    port.reset()
    port.enable()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for i in range(steps):
                run(i)
            torch.cuda.synchronize()
    finally:
        port.disable()
    names = set(port.snapshot()["spans"])
    tr = reduce_events(prof.profiler.kineto_results.events(), names, steps)
    if tr:
        tr["stage_host"] = host
    return tr


def _timed(make, calls):
    """make's function with each call's host seconds appended to calls."""
    def made(*args, **kwargs):
        fn = make(*args, **kwargs)

        def call(*a, **k):
            t0 = time.perf_counter()
            out = fn(*a, **k)
            calls.append(time.perf_counter() - t0)
            return out
        return call
    return made


def main(argv=None):
    """The stage account of one cell (module docstring). For this process,
    profiling.trace is trace, and the functions of make_detect_fn and
    make_train_step are wrapped to time each call of the step."""
    import argparse
    from frcnn_bench import run as bench_run
    from frcnn_bench import harness
    from tf_faster_rcnn_torch.engine import test_engine
    from tf_faster_rcnn_torch.engine import train as port_train
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=10.0)
    args = p.parse_args(argv)
    calls, kept = [], []
    test_engine.make_detect_fn = _timed(test_engine.make_detect_fn, calls)
    port_train.make_train_step = _timed(port_train.make_train_step, calls)

    def traced(run, steps):
        kept.append(trace(run, steps, calls=calls))
        return kept[-1]
    profiling.trace = traced
    result, _ = bench_run.measure(bench_run.parse(
        ["--workload", args.workload, "--seed", str(args.seed),
         "--seconds", str(args.seconds), "--trace", "1"]))
    tr = kept[-1] if kept else {}
    cell = harness.load_cell(args.workload)
    suffix = next(_SUFFIX[m] for m in cell.metrics if m in _SUFFIX)
    record = {"trace": tr, "stage_host": tr.get("stage_host")}
    out = {"workload": args.workload, "seed": args.seed,
           "correct": result["correct"], "device": result["device"],
           "metrics": result["metrics"], "breakdown": result.get("breakdown"),
           "stages": tr.get("stages"), "stage_host": tr.get("stage_host"),
           "stage_metrics": read(record, suffix)}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
