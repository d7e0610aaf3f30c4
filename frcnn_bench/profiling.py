"""A traced span of steps under ``torch.profiler``, reduced to what the
per-layer readers need: device busy and window seconds, kernel time by
name and by family, the NMS launches in order, and the device's idle time
by what the host was doing (the benchmark's own spans, marked with
``record_function``). Nothing is written to disk.

The kernel families are a copy of the repository's profiler tool's
(``tf_faster_rcnn_torch/tools/train_profile.py``, ``FAMILIES``)."""

from __future__ import annotations

import collections
import contextlib

__all__ = ["FAMILIES", "SPANS", "breakdown", "family", "span", "trace"]

FAMILIES = (("K1 (nms_keep_kernel)", ("nms_keep",)),
            ("convolution / GEMM", ("conv", "xmma", "gemm", "cudnn", "sm80_",
                                    "sm90_", "implicit", "wgrad", "dgrad",
                                    "nvjet")),
            ("gather / scatter / index", ("index", "gather", "scatter")),
            ("sort", ("sort", "radix")),
            ("reduction", ("reduce",)),
            ("elementwise", ("elementwise", "vectorized", "unrolled")))
# the benchmark's host spans, in the order a step runs them
SPANS = ("bench.prep", "bench.call", "bench.fetch")


def family(name: str) -> str:
    low = name.lower()
    for fam, keys in FAMILIES:
        if any(k in low for k in keys):
            return fam
    return "other"


@contextlib.contextmanager
def span(name: str, enabled: bool):
    """A host span that shows in the trace when enabled."""
    if not enabled:
        yield
        return
    import torch
    with torch.profiler.record_function(name):
        yield


def trace(run, steps: int) -> dict:
    """Profile run(i) for i in range(steps), then synchronise. Returns
    busy_s, window_s, kernels {name: s}, families {name: s}, nms [s, ...]
    in launch order, idle {host span: s}, device_ops, steps."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(steps):
            run(i)
        torch.cuda.synchronize()
    dev, host, nms = [], [], []
    kernels = collections.Counter()
    for e in prof.profiler.kineto_results.events():
        start, dur = e.start_ns(), e.duration_ns()
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            # the host spans' annotations show on the device's timeline too
            if dur <= 0 or e.name().startswith("bench."):
                continue
            dev.append((start, start + dur))
            kernels[e.name()] += dur / 1e9
            if "nms_keep" in e.name():
                nms.append((start, dur / 1e9))
        elif e.name() in SPANS:
            host.append((start, start + dur, e.name()))
    if not dev:
        return {}
    dev.sort()
    host.sort()
    t0 = min([dev[0][0]] + [h[0] for h in host])
    t1 = max([e for _, e in dev] + [h[1] for h in host])
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
    for g0, g1 in gaps:
        mid = (g0 + g1) / 2
        where = [n for s, e, n in host if s <= mid <= e]
        idle[where[-1] if where else "bench.between_steps"] += (g1 - g0) / 1e9
    fams = collections.Counter()
    for name, s in kernels.items():
        fams[family(name)] += s
    return {"busy_s": busy / 1e9, "window_s": (t1 - t0) / 1e9,
            "kernels": dict(kernels), "families": dict(fams),
            "nms": [d for _, d in sorted(nms)], "idle": dict(idle),
            "device_ops": len(dev), "steps": steps}


def breakdown(tr: dict) -> dict:
    """The result line's breakdown: the ten device ops that took most time
    and the device's idle seconds by host span, each [name, seconds]."""
    ops = sorted(tr["kernels"].items(), key=lambda kv: -kv[1])[:10]
    idle = sorted(tr["idle"].items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[n, s] for n, s in ops],
            "idle_gaps": [[n, s] for n, s in idle]}
