#!/usr/bin/env python3
"""Where the device time of one res101 train or detect step goes, on one
NVIDIA GPU.

    python3 tf_faster_rcnn_torch/tools/train_profile.py [--out PATH.json]
        [--dtype float32|bfloat16] [--detect]

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
3. ``torch.profiler`` over 3 steps: the device's busy time and idle share
   in the window from the first kernel to the last, K1's kernel time, and
   the kernels by device time, in families.

With --detect it builds chip_smoke.py's detect path instead (res101 TEST,
B = 8, 6000 -> 300, through make_detect_fn) and measures 3 only, with the
host's time to enqueue one step (the step's Python and launches, without
waiting for the device) beside it.

Prints one JSON line per measurement, each with the card's name and power
limit; --out gets the whole result, the top kernels included.
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


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", default=None)
    parser.add_argument("--dtype", default="float32",
                        choices=("float32", "bfloat16"))
    parser.add_argument("--detect", action="store_true")
    args = parser.parse_args()
    sys.path.insert(0, ROOT)
    import chip_smoke as smoke
    import torch

    card = smoke.phase_device()
    dev = torch.device("cuda", 0)
    result = {"card": card, "batch": smoke.BATCH, "canvas": smoke.CANVAS,
              "dtype": args.dtype, "path": "detect" if args.detect else "train"}

    def emit(key, value):
        result[key] = value
        print(json.dumps({key: value, "card": card, "dtype": args.dtype,
                          "path": result["path"]}))

    if args.detect:
        spec = dataclasses.replace(smoke.build_spec(), compute_dtype=args.dtype)
        _, detect, inputs = smoke.build_detect_path(dev, spec)
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
            profile_steps(result, emit, run)
    else:
        profile_train(args, smoke, dev, result, emit)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)


def profile_train(args, smoke, dev, result, emit):
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

    profile_steps(result, emit, lambda: step(state, batch))


def profile_steps(result, emit, run):
    """Section 3: the profiler's kernel table over 3 calls of run()."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
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
        kernels[e.name()] += dur / 1e6 / 3          # ms per step
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
        "window_ms_per_step": window / 1e6 / 3,
        "busy_ms_per_step": busy / 1e6 / 3,
        "idle_share": 1.0 - busy / window,
        "device_ops": len(spans),
        "families_ms_per_step": dict(fams.most_common())})
    result["top_kernels_ms_per_step"] = kernels.most_common(40)
    for name, ms in kernels.most_common(15):
        print(f"  {ms:9.3f} ms  {family(name):26s} {name[:110]}")


if __name__ == "__main__":
    main()
