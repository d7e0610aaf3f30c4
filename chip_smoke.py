#!/usr/bin/env python3
"""Smoke run of the PyTorch port (tf_faster_rcnn_torch) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the root of a checkout

Phases, in order; any failure raises and the exit code is nonzero:

1. device: a CUDA device must be present (no CPU fallback); prints
   nvidia-smi's name and power limit, and torch's device name;
2. build: nvcc builds the kernels from tf_faster_rcnn_torch/csrc/*.cu;
3. kernels: K1 (nms_keep_mask_batched) and K2 (batched_nms_keep) on the
   card against their plain PyTorch versions on the same inputs, with exact
   equality of the boolean masks;
4. main path: the ResNet-101 TEST detect step (batch 8, 608x1024 canvas,
   21 classes, 6000 -> 300 proposals, float32, seeded random weights) through
   make_detect_fn. Both kernels must have launched; the detections must be
   finite, [8, 100, 6], with a valid one per image. The same step with
   deterministic cuDNN, once through the kernels and once through the plain
   versions on the card, must give equal proposals and detections, and each
   kernel must equal its plain version on the inputs the main path gave it;
5. times, with CUDA events after warm-up: each kernel against its plain
   version on the main path's own inputs, the detect step and its stages.

The line before the last is one JSON object describing the kernels; the last
is {"ok": true, "device": {...}}. TF32 is off in every phase: a float32
convolution would otherwise run through cuDNN in TF32.
"""

import contextlib
import functools
import json
import os
import subprocess
import sys
import time

import numpy as np

BATCH = 8
CANVAS = (608, 1024)      # config.canvas_buckets(cfg.TEST)[0] at SCALES 600,
                          # MAX_SIZE 1000: the engine's landscape canvas
NUM_CLASSES = 21
SEED = 0
WARMUP = 3
ITERS = 10
SOURCE = "tf_faster_rcnn_torch/csrc/nms.cu"
REPLACES = {
    "nms_keep_mask_batched": "tf_faster_rcnn_tpu/ops/pallas_nms.py:55",
    "batched_nms_keep": "tf_faster_rcnn_tpu/ops/pallas_nms.py:149",
}


def synthetic_scenes(rng, batch, h, w, mean=128.0):
    """bench.py's inputs: a dark noise background with 2-6 bright solid
    rectangles per image, mean-subtracted as prep_im_for_blob feeds the
    network."""
    ims = rng.randint(0, 60, (batch, h, w, 3)).astype(np.float32)
    for b in range(batch):
        for _ in range(rng.randint(2, 7)):
            x1 = rng.randint(0, w - 40)
            y1 = rng.randint(0, h - 40)
            x2 = x1 + rng.randint(30, min(w - x1, w // 2))
            y2 = y1 + rng.randint(30, min(h - y1, h // 2))
            ims[b, y1:y2, x1:x2] = rng.randint(140, 255, 3)
    return ims - mean


def sorted_boxes(rng, n):
    """tests/test_pallas_nms.py's generator: boxes sorted by a random
    score."""
    c = rng.uniform(30, 350, (n, 2))
    wh = rng.uniform(10, 90, (n, 2))
    dets = np.concatenate([c - wh / 2, c + wh / 2, rng.rand(n, 1)],
                          axis=1).astype(np.float32)
    order = np.argsort(-dets[:, 4], kind="stable")
    return dets[order, :4]


def cuda_ms(fn, iters):
    """Mean device time of fn() over iters calls, by CUDA events."""
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def timed(fn, iters=ITERS, warmup=WARMUP):
    for _ in range(warmup):
        fn()
    return cuda_ms(fn, iters)


def phase_device():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py: torch.cuda.is_available() is False; "
                         "this smoke run needs an NVIDIA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device "
          f"{torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return card


def phase_build():
    from tf_faster_rcnn_torch.utils.build import build_info, get_lib
    t0 = time.perf_counter()
    get_lib()
    info = build_info()
    print(f"build: {time.perf_counter() - t0:.2f} s (nvcc ran: "
          f"{info['built']}, {info['path']})")
    for line in info["log"].splitlines():
        if "Used" in line or "spill" in line or "entry function" in line:
            print("  " + line.strip())


def kernel_pairs():
    """name -> (wrapper that launches the kernel, its plain version)."""
    from tf_faster_rcnn_torch.ops import nms_kernels as K
    return {"nms_keep_mask_batched": (K.nms_keep_mask_batched,
                                      K.nms_keep_mask_plain),
            "batched_nms_keep": (K.batched_nms_keep,
                                 K.batched_nms_keep_plain)}


def check_equal(err, name, got, want, case):
    """Masks exactly equal; err[name] keeps the largest |kernel - plain|."""
    import torch
    torch.cuda.synchronize()
    e = int((got.int() - want.int()).abs().max()) if got.numel() else 0
    err[name] = max(err[name], e)
    print(f"  {name} {case}: equal={e == 0} kept={int(got.sum())}")
    if e:
        raise AssertionError(f"{name} {case}: kernel != plain")


def phase_kernels(dev):
    """Every case: kernel and plain version on the same card inputs, masks
    exactly equal. Returns the largest |kernel - plain| per kernel."""
    import torch
    from tf_faster_rcnn_torch.ops import nms_kernels as K
    rng = np.random.RandomState(SEED)
    err = {name: 0 for name in kernel_pairs()}
    check = functools.partial(check_equal, err)

    for n in (64, 500, 2048, 6000, 12000):
        boxes = torch.from_numpy(
            np.stack([sorted_boxes(rng, n) for _ in range(2)])).to(dev)
        valid = torch.ones(2, n, dtype=torch.bool, device=dev)
        valid[1, n // 8:n // 4] = False               # an invalid stretch
        for plus_one, suppress_eq in ((False, False), (True, False),
                                      (True, True)):
            for max_keep in (None, 40):
                kw = dict(plus_one=plus_one, suppress_eq=suppress_eq,
                          max_keep=max_keep)
                got = K.nms_keep_mask_batched(boxes, valid, 0.5, **kw)
                want = K.nms_keep_mask_plain(boxes, valid, 0.5, **kw)
                check("nms_keep_mask_batched", got, want, f"N={n} {kw}")
    for g, n in ((13, 96), (160, 300), (640, 1000)):
        boxes = torch.from_numpy(
            np.stack([sorted_boxes(rng, n) for _ in range(g)])).to(dev)
        valid = torch.from_numpy(rng.rand(g, n) > 0.1).to(dev)
        for plus_one in (True, False):
            got = K.batched_nms_keep(boxes, valid, 0.3, plus_one=plus_one)
            want = K.batched_nms_keep_plain(boxes, valid, 0.3,
                                            plus_one=plus_one)
            check("batched_nms_keep", got, want,
                  f"G={g} N={n} plus_one={plus_one}")
    return err


@contextlib.contextmanager
def nms_route(plain=False, record=None):
    """Route the detect path's two NMS calls: through the plain versions
    (plain=True), and/or record each call's arguments in record[name]."""
    from tf_faster_rcnn_torch.engine import detect as detect_mod
    from tf_faster_rcnn_torch.ops import nms as nms_mod
    from tf_faster_rcnn_torch.ops import nms_kernels as K
    saved = (nms_mod.nms_keep_mask_batched, detect_mod.batched_nms_keep)

    def route(name, kernel, plain_fn):
        fn = plain_fn if plain else kernel

        def call(*args, **kwargs):
            if record is not None:
                record[name] = (args, kwargs)
            return fn(*args, **kwargs)
        return call

    nms_mod.nms_keep_mask_batched = route(
        "nms_keep_mask_batched", K.nms_keep_mask_batched,
        K.nms_keep_mask_plain)
    detect_mod.batched_nms_keep = route(
        "batched_nms_keep", K.batched_nms_keep, K.batched_nms_keep_plain)
    try:
        yield
    finally:
        nms_mod.nms_keep_mask_batched, detect_mod.batched_nms_keep = saved


def build_main_path(dev):
    import torch
    from tf_faster_rcnn_torch.engine.test_engine import make_detect_fn
    from tf_faster_rcnn_torch.models.init import init_model
    from tf_faster_rcnn_torch.models.network import FasterRCNN, ModelSpec
    spec = ModelSpec("res101", NUM_CLASSES, rpn_pre_nms_top_n=6000,
                     rpn_post_nms_top_n=300)
    model = FasterRCNN(spec).eval()
    init_model(model, torch.Generator().manual_seed(SEED))
    model.to(dev)
    rng = np.random.RandomState(SEED)
    h, w = CANVAS
    image = torch.from_numpy(synthetic_scenes(rng, BATCH, h, w)).to(dev)
    im_info = torch.tensor([[600.0, 1000.0, 1.6]] * BATCH, device=dev)
    orig_hw = torch.tensor([[375.0, 625.0]] * BATCH, device=dev)
    return spec, model, make_detect_fn(model, spec), (image, im_info, orig_hw)


def phase_main_path(spec, model, detect, inputs, errors):
    import torch
    from tf_faster_rcnn_torch.ops import nms_kernels as K
    K.reset_launch_counts()
    det, dv = detect(*inputs)
    torch.cuda.synchronize()
    launches = K.launch_counts()
    print(f"main path: {spec.backbone} B={BATCH} {CANVAS[0]}x{CANVAS[1]} "
          f"{spec.num_classes} classes {spec.rpn_pre_nms_top_n}->"
          f"{spec.rpn_post_nms_top_n}; launches {launches}")
    for name, count in launches.items():
        if count < 1:
            raise AssertionError(f"{name} never launched on the main path")
    if tuple(det.shape) != (BATCH, spec.max_per_image, 6):
        raise AssertionError(f"detections shape {tuple(det.shape)}")
    if not bool(torch.isfinite(det).all()):
        raise AssertionError("non-finite detections")
    per_image = dv.sum(dim=1).tolist()
    print(f"  valid detections per image: {per_image}")
    if min(per_image) < 1:
        raise AssertionError("an image has no valid detection")

    # the same step, deterministic cuDNN: kernels vs plain versions
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    results = []
    record = {}
    for plain in (False, True):
        with nms_route(plain=plain, record=record), torch.inference_mode():
            out = model(inputs[0], inputs[1])
            d, v = detect(*inputs)
        torch.cuda.synchronize()
        results.append((out, d, v))
        if not plain:
            captured = dict(record)
    (ko, kd, kv), (po, pd, pv) = results
    checks = {
        "rois": torch.equal(ko["rois"], po["rois"]),
        "roi_valid": torch.equal(ko["roi_valid"], po["roi_valid"]),
        "class ids": torch.equal(kd[..., 0], pd[..., 0]),
        "valid": torch.equal(kv, pv),
        "boxes": torch.equal(kd[..., 2:], pd[..., 2:]),
    }
    print(f"  kernel path vs plain path (deterministic cuDNN): {checks}")
    if not all(checks.values()):
        raise AssertionError(f"kernel and plain detect paths differ: {checks}")
    torch.backends.cudnn.deterministic = False

    # each kernel against its plain version on the main path's own inputs
    for name, (kernel, plain) in kernel_pairs().items():
        args, kwargs = captured[name]
        check_equal(errors, name, kernel(*args, **kwargs),
                    plain(*args, **kwargs),
                    f"main path {tuple(args[0].shape)} {kwargs}")
    return launches, captured


def phase_times(card, model, detect, inputs, captured):
    import torch
    from tf_faster_rcnn_torch.engine.detect import postprocess_detections
    times = {}
    for name, (kernel, plain) in kernel_pairs().items():
        args, kwargs = captured[name]
        shape = tuple(args[0].shape)
        # plain, kernel, kernel, plain: the pairs share one card and warm-up
        t_plain = timed(lambda: plain(*args, **kwargs), iters=3, warmup=1)
        t_kernel = timed(lambda: kernel(*args, **kwargs))
        t_kernel = min(t_kernel, timed(lambda: kernel(*args, **kwargs)))
        t_plain = min(t_plain, timed(lambda: plain(*args, **kwargs),
                                     iters=3, warmup=1))
        times[name] = (t_kernel, t_plain)
        print(f"time {name} {shape}: kernel {t_kernel:.4f} ms, plain "
              f"{t_plain:.4f} ms [{card}]")

    image, im_info, orig_hw = inputs
    with torch.inference_mode():
        step = timed(lambda: detect(*inputs))
        x = image.permute(0, 3, 1, 2)
        head = timed(lambda: model.head(x, im_info[:, :2]))
        forward = timed(lambda: model(image, im_info))
        out = model(image, im_info)
        net_conv = model.head(x, im_info[:, :2])
        roi_heads = timed(lambda: model._roi_heads(net_conv, out["rois"],
                                                    im_info))
        post = timed(lambda: postprocess_detections(
            out["rois"], out["roi_valid"], out["cls_prob"], out["bbox_pred"],
            im_info, orig_hw, num_classes=NUM_CLASSES))
    stages = {"head": head, "rpn_and_proposals": forward - head - roi_heads,
              "crop_tail_heads": roi_heads, "postprocess": post}
    print(f"time detect step: {step:.3f} ms, {BATCH * 1000.0 / step:.2f} "
          f"images/s (res101 f32, TF32 off, B={BATCH}) [{card}]")
    print("time stages ms: " + json.dumps(
        {k: round(v, 3) for k, v in stages.items()}) + f" [{card}]")
    return times


def main():
    root = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(root, "tf_faster_rcnn_torch")):
        raise SystemExit("chip_smoke.py: tf_faster_rcnn_torch/ is not beside "
                         "this script; run it from a checkout of the repo")
    sys.path.insert(0, root)
    import torch

    card = phase_device()
    dev = torch.device("cuda", 0)
    phase_build()
    errors = phase_kernels(dev)
    spec, model, detect, inputs = build_main_path(dev)
    launches, captured = phase_main_path(spec, model, detect, inputs, errors)
    times = phase_times(card, model, detect, inputs, captured)

    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": SOURCE,
         "replaces": REPLACES[name], "launches": launches[name],
         "max_abs_err": errors[name], "ms": times[name][0],
         "plain_ms": times[name][1]}
        for name in ("nms_keep_mask_batched", "batched_nms_keep")]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
