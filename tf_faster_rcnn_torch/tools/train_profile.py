#!/usr/bin/env python3
"""Where the device time of one train or detect step goes, on one NVIDIA
GPU.

    python3 tf_faster_rcnn_torch/tools/train_profile.py [--out PATH.json]
        [--dtype float32|bfloat16] [--steps N] [--dir DIR]
        [--detect [--net NET] [--batch B] [--canvas H,W | --cfg YML]]

Builds chip_smoke.py's train path (res101, B = 8 on the 608x1024 canvas,
12000 -> 2000 proposals, experiments/cfgs/res101.yml's TRAIN settings,
TPU.COMPUTE_DTYPE --dtype with TF32 off, seeded random weights), warms it
up, then measures:

1. phases, by CUDA events around the parts of ``make_train_step`` called in
   its order (``train_loss``; ``torch.autograd.grad``; the NaN guard and
   ``Optimizer.apply``), mean of 5 steps: forward + losses, backward,
   optimizer;
2. targets: ``anchor_target`` and ``proposal_target`` on the step's own
   inputs, by CUDA events, mean of 10 calls;
3. ``torch.profiler`` over --steps steps (3): the device's busy time and
   idle share in the window from the first kernel to the last, K1's kernel
   time, and the kernels by device time, in families. With --dir DIR the
   same window is written as a Chrome / Perfetto trace,
   DIR/<path>_<net>_<dtype>.json (open it in ui.perfetto.dev or
   chrome://tracing), and the trace's ten largest device ops, read back
   from the file, are printed.

With --detect it builds a detect path instead (make_detect_fn: the forward
and the whole postprocess, K1 and K2) and measures 3 only, with the host's
time to enqueue one step (the step's Python and launches, without waiting
for the device) beside it. The flags are those of the JAX package's
tools/profile_net.py (``detect_target``): --net (res101), --batch (8), and
either --canvas H,W (608,1024) with 6000 -> 300 proposals, or --cfg YML,
that YAML's first TEST canvas bucket and its proposal counts; --s2d is
refused, as spec_from_cfg refuses the stem. At the defaults this is
chip_smoke.py's main path (its scenes and image extents); profile_net's
--canvas form traces the forward alone, this tool the whole detect step.

Runs on the card only. Prints one JSON line per measurement, each with the
card's name and power limit; --out gets the whole result, the top kernels
included.
"""

import argparse
import collections
import dataclasses
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

NETS = ("vgg16", "res50", "res101", "res152", "mobile")
NUM_CLASSES = 21
# the Chrome trace's categories of device work (torch.profiler / kineto)
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
FAMILIES = (("K1 (nms_keep_kernel)", ("nms_keep",)),
            ("convolution / GEMM", ("conv", "xmma", "gemm", "cudnn", "sm80_",
                                    "sm90_", "implicit", "wgrad", "dgrad",
                                    "nvjet")),
            ("gather / scatter / index", ("index", "gather", "scatter")),
            ("sort", ("sort", "radix")),
            ("reduction", ("reduce",)),
            ("elementwise", ("elementwise", "vectorized", "unrolled")))


def family(name):
    low = name.lower()
    for fam, keys in FAMILIES:
        if any(k in low for k in keys):
            return fam
    return "other"


def detect_target(net="res101", dtype="float32", canvas="608,1024",
                  cfg_file=None, s2d=False):
    """(spec, (H, W)) of the detect path that --detect profiles, from
    tools/profile_net.py's flags: the spec of net in TEST mode at
    TPU.COMPUTE_DTYPE dtype and the canvas H,W with 6000 -> 300 proposals;
    or, with cfg_file, that YAML merged over it, its TEST proposal counts
    and its first TEST canvas bucket. s2d sets TPU.SPACE_TO_DEPTH, on which
    spec_from_cfg raises. Leaves the port's cfg as it set it."""
    from tf_faster_rcnn_torch.config import (canvas_buckets, cfg,
                                             cfg_from_file, reset_cfg)
    from tf_faster_rcnn_torch.models.network import spec_from_cfg
    reset_cfg()
    cfg.TPU.COMPUTE_DTYPE = dtype
    cfg.TPU.SPACE_TO_DEPTH = bool(s2d)
    if cfg_file:
        cfg_from_file(cfg_file)
        return (spec_from_cfg(net, NUM_CLASSES, "TEST"),
                tuple(canvas_buckets(cfg.TEST)[0]))
    spec = dataclasses.replace(spec_from_cfg(net, NUM_CLASSES, "TEST"),
                               rpn_pre_nms_top_n=6000, rpn_post_nms_top_n=300)
    h, w = (int(x) for x in canvas.split(","))
    return spec, (h, w)


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", default=None)
    parser.add_argument("--dtype", default="float32",
                        choices=("float32", "bfloat16"))
    parser.add_argument("--steps", type=int, default=3,
                        help="steps in the profiler's window")
    parser.add_argument("--dir", default=None,
                        help="write the window's Chrome / Perfetto trace here")
    parser.add_argument("--detect", action="store_true")
    parser.add_argument("--net", default=None, choices=NETS,
                        help="--detect: the backbone (res101)")
    parser.add_argument("--batch", type=int, default=None,
                        help="--detect: images a step (8)")
    parser.add_argument("--canvas", default=None,
                        help="--detect: H,W (608,1024), 6000 -> 300 "
                             "proposals")
    parser.add_argument("--cfg", default=None,
                        help="--detect: a YAML; its TEST canvas and "
                             "proposal counts")
    parser.add_argument("--s2d", action="store_true",
                        help="refused: the space-to-depth stem is not ported")
    args = parser.parse_args()
    detect_flags = (args.net, args.batch, args.canvas, args.cfg)
    if not args.detect and (any(f is not None for f in detect_flags)
                            or args.s2d):
        parser.error("--net, --batch, --canvas, --cfg and --s2d go with "
                     "--detect")
    if args.canvas and args.cfg:
        parser.error("--canvas and --cfg exclude each other")
    sys.path.insert(0, ROOT)
    import chip_smoke as smoke
    import torch

    card = smoke.phase_device()
    dev = torch.device("cuda", 0)
    if args.detect:
        net, batch = args.net or "res101", args.batch or smoke.BATCH
        spec, canvas = detect_target(net, args.dtype,
                                     args.canvas or "608,1024", args.cfg,
                                     args.s2d)
    else:
        net, batch, canvas = "res101", smoke.BATCH, smoke.CANVAS
    result = {"card": card, "net": net, "batch": batch, "canvas": canvas,
              "dtype": args.dtype, "path": "detect" if args.detect else "train"}
    trace = None
    if args.dir:
        os.makedirs(args.dir, exist_ok=True)
        trace = os.path.join(args.dir,
                             f"{result['path']}_{net}_{args.dtype}.json")

    def emit(key, value):
        result[key] = value
        print(json.dumps({key: value, "card": card, "dtype": args.dtype,
                          "path": result["path"]}))

    if args.detect:
        _, detect, inputs = smoke.build_detect_path(dev, spec, batch, canvas)
        emit("workload", {"net": net, "batch": batch, "canvas": canvas,
                          "proposals": [spec.rpn_pre_nms_top_n,
                                        spec.rpn_post_nms_top_n],
                          "cfg": args.cfg})
        with torch.inference_mode():
            def run():
                return detect(*inputs)
            for _ in range(smoke.WARMUP):
                run()
            torch.cuda.synchronize()
            enqueue = []
            for _ in range(5):
                t0 = time.perf_counter()
                run()
                enqueue.append((time.perf_counter() - t0) * 1e3)
                torch.cuda.synchronize()
            emit("host_enqueue_ms", sorted(enqueue)[2])
            emit("step_ms", smoke.timed(run))
            profile_steps(result, emit, run, args.steps, trace)
    else:
        profile_train(args, smoke, dev, result, emit, trace)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)


def profile_train(args, smoke, dev, result, emit, trace):
    """Sections 1-3 for the train step."""
    import torch
    from tf_faster_rcnn_torch.config import cfg
    from tf_faster_rcnn_torch.engine.train import all_finite, train_loss
    from tf_faster_rcnn_torch.models import network

    spec, state, step, batch = smoke.build_train_path(
        dev, extra_cfg=["TPU.COMPUTE_DTYPE", args.dtype])
    for _ in range(smoke.WARMUP):
        step(state, batch)
    torch.cuda.synchronize()

    # 1. phases of the step, in the step's own order
    model, wd = state.model, float(cfg.TRAIN.WEIGHT_DECAY)
    events = [[torch.cuda.Event(enable_timing=True) for _ in range(4)]
              for _ in range(5)]
    for ev in events:
        ev[0].record()
        total, _ = train_loss(model, batch, wd, bool(cfg.TRAIN.BIAS_DECAY),
                              None, state.generator)
        ev[1].record()
        params = state.params()
        grads = torch.autograd.grad(total, list(params.values()))
        ev[2].record()
        finite = all_finite(total, grads)
        state.tx.apply(params, dict(zip(params, grads)), state.trace,
                       state.count, finite)
        state.step.add_(1)
        ev[3].record()
    torch.cuda.synchronize()
    names = ("forward_and_losses", "backward", "optimizer")
    phases = {n: sum(ev[i].elapsed_time(ev[i + 1]) for ev in events)
              / len(events) for i, n in enumerate(names)}
    phases["step"] = sum(phases.values())
    emit("phases_ms", phases)

    # 2. the two samplers on the step's own inputs
    captured = {}
    saved = {n: getattr(network, n) for n in ("anchor_target",
                                              "proposal_target")}

    def capture(name):
        def call(*a, **k):
            captured[name] = (a, k)
            return saved[name](*a, **k)
        return call

    for name in saved:
        setattr(network, name, capture(name))
    try:
        step(state, batch)
    finally:
        for name, fn in saved.items():
            setattr(network, name, fn)
    targets = {}
    for name, fn in saved.items():
        a, k = captured[name]
        targets[name] = smoke.timed(lambda: fn(*a, **k))
    emit("targets_ms", targets)

    profile_steps(result, emit, lambda: step(state, batch), args.steps,
                  trace)


def trace_top_ops(path, steps, n=10):
    """The n device ops of a Chrome trace with the most device time, as
    [name, ms a step, calls a step]: the events of the trace's device
    categories (kernels, copies, sets), summed by name."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    total, calls = collections.Counter(), collections.Counter()
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS:
            total[e["name"]] += e.get("dur", 0) / 1e3 / steps   # us -> ms
            calls[e["name"]] += 1
    return [[name, ms, calls[name] / steps]
            for name, ms in total.most_common(n)]


def profile_steps(result, emit, run, steps, trace):
    """Section 3: the profiler's kernel table over `steps` calls of run();
    with trace, the same window written there as a Chrome trace, and its
    ten largest device ops."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            run()
        torch.cuda.synchronize()
    spans, kernels = [], collections.Counter()
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != torch.autograd.DeviceType.CUDA:
            continue
        start, dur = e.start_ns(), e.duration_ns()
        if dur <= 0:
            continue
        spans.append((start, start + dur))
        kernels[e.name()] += dur / 1e6 / steps      # ms per step
    if not spans:
        raise SystemExit("train_profile.py: the profiler recorded no device "
                         "time")
    spans.sort()
    busy, end = 0, spans[0][0]
    for s, e in spans:
        if e > end:
            busy += e - max(s, end)
            end = e
    window = max(e for _, e in spans) - spans[0][0]
    fams = collections.Counter()
    for name, ms in kernels.items():
        fams[family(name)] += ms
    emit("profile", {
        "steps": steps,
        "window_ms_per_step": window / 1e6 / steps,
        "busy_ms_per_step": busy / 1e6 / steps,
        "idle_share": 1.0 - busy / window,
        "device_ops_per_step": len(spans) / steps,
        "families_ms_per_step": dict(fams.most_common())})
    result["top_kernels_ms_per_step"] = kernels.most_common(40)
    for name, ms in kernels.most_common(15):
        print(f"  {ms:9.3f} ms  {family(name):26s} {name[:110]}")
    if trace:
        prof.export_chrome_trace(trace)
        print(f"wrote the {steps}-step trace to {trace} "
              f"({os.path.getsize(trace)} bytes)")
        emit("trace_top_ops", trace_top_ops(trace, steps))


if __name__ == "__main__":
    main()
