#!/usr/bin/env python3
"""Smoke run of the PyTorch port (tf_faster_rcnn_torch) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the root of a checkout

Phases, in order; any failure raises and the exit code is nonzero:

1. device: a CUDA device must be present (no CPU fallback); prints
   nvidia-smi's name and power limit, and torch's device name;
2. build: nvcc builds the kernels from tf_faster_rcnn_torch/csrc/*.cu;
3. kernels: K1 (nms_keep_mask_batched) and K2 (batched_nms_keep) on the
   card against their plain PyTorch versions on the same inputs, with exact
   equality of the boolean masks: random boxes, the cases of edge_cases()
   that a wrong quick reject or a broken chain would fail, K1 at the TRAIN
   shape [8, 12000] -> 2000 and K2 at the COCO shape [640, 1000];
4. main path: the ResNet-101 TEST detect step (batch 8, 608x1024 canvas,
   21 classes, 6000 -> 300 proposals, float32, seeded random weights) through
   make_detect_fn. Both kernels must have launched; the detections must be
   finite, [8, 100, 6], with a valid one per image. The same step with
   deterministic cuDNN, once through the kernels and once through the plain
   versions on the card, must give equal proposals and detections, and each
   kernel must equal its plain version on the inputs the main path gave it;
5. times, with CUDA events after warm-up: each kernel (device time, from a
   CUDA graph of 20 calls replayed, and per call from Python) against its
   plain version on the main path's own inputs, beside its bound; K1 at the
   TRAIN shape and K2 at the COCO shape; the detect step and its stages;
6. train path: the res101 train step at experiments/cfgs/res101.yml's
   TRAIN settings (B = 8 on the same canvas, 12000 -> 2000 proposals, 256
   anchors and 256 RoIs per image, gt = the scenes' rectangles padded to
   TPU.MAX_GT, float32, SGD with the NaN guard) through create_train_state
   and make_train_step. Three steps: finite losses, both cross-entropies
   above 0, no step skipped, K1 launched once per step at N = 12000 with
   max_keep 2000 (and K2 never), the stem and block1 bitwise unchanged,
   block2, block4, the RPN and the heads moved. One more step from the same
   state and noise through the kernel and through the plain K1, with
   deterministic cuDNN: equal proposals, sampled RoIs, RoI and anchor
   labels, the total loss to 1e-6 and every parameter to 1e-6 relative
   (1e-3 in bf16, where the crop's backward adds atomically in bf16);
   K1 equal to its plain version on the step's own inputs; one step with
   torch's sync debug mode on makes no host sync. Then the step's
   time (mean of 10 by CUDA events after warm-up), images/s, peak memory,
   and K1's graph-replay time, plain time and bound on the step's inputs;
7. bf16 detect: phase 4's step at TPU.COMPUTE_DTYPE bfloat16 (the bench's
   configuration, bench.py and tools/bench_train.py) on the same weights:
   both kernels launched, each equal to its plain version on this path's
   inputs, finite [8, 100, 6] detections; step time, images/s and peak
   memory; the drift from phase 4's float32 detections (the share matched
   by a bf16 detection of the same class at IoU >= 0.9), printed, not gated;
8. bf16 train: phase 6 at COMPUTE_DTYPE bfloat16 and PARAM_DTYPE float32,
   with all of phase 6's checks and times;
9. vgg16 and mobile (DEPTH_MULTIPLIER 1.0) at full width, float32 as their
   YAMLs leave it, on phase 4's canvas: one detect step (both kernels
   launched, each equal to its plain version on its inputs, finite
   detections) and two train steps at their YAMLs' TRAIN settings (K1 once
   a step, finite losses, the frozen prefix bitwise unchanged: vgg16
   conv1-conv2, mobile layers 0-4); their step times;
10. TEST.MODE 'top': one res101 detect step (B = 2, TEST.RPN_TOP_N 5000 of
   the 21888 anchors): K1 not launched, K2 launched and equal to its plain
   version, the proposals sorted by descending score;
11. eval: a temporary VOCdevkit2007 test split of 64 images at VOC's sizes
   (40 landscape 500x375, 24 portrait 375x500, so both canvases 608x1024
   and 1024x608 run), painted rectangles of the 20 classes with XML
   annotations, binary PPM under .jpg names. test_net in process at
   experiments/cfgs/res101.yml (float32) with TPU.IMS_PER_DEVICE 8, on
   phase 4's seeded weights: K1 and K2 launched once per batch, each equal
   to its plain version on every input the eval path gave it; the first
   batch's canvases, built on the card with no host sync, within 0.02 of
   CPU-built ones, and its detections equal to make_detect_fn's on them;
   detections.pkl of 21 x 64 float32 [N, 5] arrays, mAP in [0, 1]; the
   ground truth, fed through the same imdb, scoring mAP 1.0. A second run
   gives the same detections and is timed: images/s from decode to mAP,
   im_detect and misc per batch, and the split of a batch (decode, prep on
   the card, detect step). Then the CLIs in subprocesses: tools.test_net on
   the weights saved by save_params gives the same detections.pkl, and
   tools.reval --nms the mAP of the host re-NMS of it;
12. train loop: a VOCdevkit2007 trainval split of 32 images at VOC's sizes
   (24 landscape, 8 portrait, with their flipped entries; TRAIN.
   ASPECT_GROUPING on, so batches run on the landscape and the union
   canvases), phase 11's test split as the imdbval, and phase 4's seeded
   weights written as a res101 ImageNet slim var dict (.npz, no heads),
   laid out here without the port's weight bridges. train_net at
   experiments/cfgs/res101.yml (float32), B = 8, --weight that dict, as a
   user runs it (default algorithms, the prefetcher on), 11 steps,
   snapshots at steps 4, 8 and 11 with SNAPSHOT_KEPT 2, the eval at step
   8: every imported backbone tensor equal to phase 4's; K1 once a step at
   [8, 12000] -> 2000 (and once in the val summary), K2 only in the eval,
   each equal to its plain version on the loop's inputs; finite losses;
   the stem and block1 bitwise equal to the import after 11 steps, block2
   on moved; the snapshots of steps 8 and 11 kept, metrics.jsonl and both
   event dirs written, the mAP in [0, 1], the best params saved. Then the
   deterministic pair (torch's deterministic algorithms, TPU.PREFETCH 0, no
   eval): an unbroken run of 8 steps, and a second train_net from a copy
   of its step-4 snapshot pair to step 8: parameters and momentum within
   RESUME_TOL of the unbroken run's, the same step, generator and data
   cursors. Then tools.trainval_net in a subprocess (--iters 16, the
   prefetcher on, the caller's environment) exits 0 with its snapshot and
   event files. Times: the loop's ms per step (steps 3-8, host clock to a
   synchronize) beside the same step bare, in the user's run and in the
   deterministic one, and phase 6's; the snapshot's write, the eval's
   images/s, the device's idle share over steps 9-11 of the user's run
   (torch.profiler), and the data layer's decode and card prep per batch;
13. serve: phase 11's tree again; phase 4's seeded res101 weights saved
   as a .pt, and tools.export_model --verify in a subprocess (the caller's
   environment) exports the TEST program from that file (float32, TF32
   off, B = 8) for both buckets, 608x1024 and 1024x608, and holds each
   reloaded program to the live one at atol 0. A fresh process
   (serve_child) loads the bundle, with no module of the port's models,
   engine or config (nor JAX) in sys.modules, and runs it on phase 11's
   first batch of each orientation with deterministic cuDNN: its outputs
   equal the live make_detect_fn's bit for bit, K1 and K2 launch once per
   call, and each equals its plain version on the inputs the program gave
   it (recorded by a dispatch mode on the two operators, since the
   exported graph calls the ops and not the wrappers that nms_route
   patches). Then tools.serve in a subprocess over the 64 images: its JSON
   equals the live step's rows on the same canvases at the same threshold;
   and tools.demo --json over its 5 generated images exits 0 with its
   figures and JSON. Times: the export CLI as a whole and per bucket (from
   the files' times), the bundle's bytes, the load
   in the fresh process, the exported step beside the live step (CUDA
   events, mean of 10 after warm-up), serve images/s from the first decode
   to the JSON, demo ms per image, and the kernels on the serve path;
14. from scratch: for res101, vgg16 and mobile at full width,
   models/init.py::reference_init (the JAX package's initializers) on the
   card equal, bit for bit, to the same draw on the CPU, and the backbone
   output's std on a pixel-scale 96x128 input inside (0.05, 20), the JAX
   gate (tests/test_from_scratch_stability.py). Then the overfit drill,
   tools.overfit_check's main at its defaults (vgg16 from scratch, bf16
   compute, 1600 iterations at B = 1, 6 synthetic images, every present
   class's AP >= 0.99), in process with the NMS calls logged: PASS, K1 once
   a step at [1, 256] -> 48 (and once a val summary and an eval batch), K2
   once an eval batch at [20, 32], each kernel equal to its plain version
   on the first and the last step's inputs and on every eval call. Times:
   steps/s, and the wall time from the drill's start to the gate;
15. COCO rehearsal: python -m tf_faster_rcnn_torch.tools.coco_rehearsal in
   a subprocess at its defaults (res101 from scratch on a synthetic
   80-class COCO, 4000 images = 500 steps at B = 8, f32, through the
   drivers tools.train_faster_rcnn and tools.test_faster_rcnn), with the
   caller's environment and a working dir of this run's: exit 0, and
   AP@[0.5:0.95] >= 0.05 under both res101.yml and res101-lg.yml. Then its
   snapshot through test_net in process on the minival under
   res101-lg.yml: K1 at [8, 6000] -> 1000 and K2 at [640, 1000] once a
   batch, each equal to its plain version on every call. Times: ms a
   step (the loop's own mean), the drivers' wall times, the kernels on the
   lg eval path.

Each phase from 7 on prints its wall time. The kernel line gives, beside
each kernel's main-path fields (phase 4), its launches, graph-replay time,
plain time and bound on each other path's own inputs ("paths").

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
import warnings
from dataclasses import replace

import numpy as np

# the environment the caller gave, for the CLIs' subprocesses: main() adds
# CUBLAS_WORKSPACE_CONFIG to its own for phase 12's deterministic pair
CALLER_ENV = dict(os.environ)
BATCH = 8
CANVAS = (608, 1024)      # config.canvas_buckets(cfg.TEST)[0] at SCALES 600,
                          # MAX_SIZE 1000: the engine's landscape canvas
NUM_CLASSES = 21
SEED = 0
WARMUP = 3
ITERS = 10
SOURCE = "tf_faster_rcnn_torch/csrc/nms.cu"
# H100 SXM peaks (NVIDIA's data sheet): HBM3 bytes/s, float32 FLOP/s outside
# the tensor cores; and the float32 operations of one IoU test (min, max,
# sub, add, max for each of iw and ih; inter; uni's add and sub; uni > 0;
# the division; the threshold compare), the areas computed once per box.
# the train path: experiments/cfgs/res101.yml's TRAIN keys that differ from
# the defaults (tests/test_torch_detect.py holds the result to the YAML),
# the image extent inside the canvas and TPU.MAX_GT
TRAIN_CFG = ["TRAIN.BATCH_SIZE", "256", "TRAIN.BG_THRESH_LO", "0.0",
             "TRAIN.DOUBLE_BIAS", "False"]
# the same for experiments/cfgs/vgg16.yml and mobile.yml (held to the YAMLs
# by tests/test_torch_backbones.py), and the bench's compute dtype
BACKBONE_TRAIN_CFG = {
    "res101": TRAIN_CFG,
    "vgg16": ["TRAIN.BATCH_SIZE", "256", "TRAIN.BG_THRESH_LO", "0.0"],
    "mobile": TRAIN_CFG}
BF16 = ["TPU.COMPUTE_DTYPE", "bfloat16"]
BACKBONE_TRAIN_STEPS = 2
TOP_BATCH = 2
IM_HW = (600.0, 1000.0)
MAX_GT = 100
TRAIN_STEPS = 3
HBM_BYTES_S = 3.35e12
F32_FLOP_S = 67e12
FLOP_PER_TEST = 16
# phase 11: a VOCdevkit2007 test split at VOC's own sizes, (h, w)
EVAL_LANDSCAPE, EVAL_PORTRAIT = 40, 24
EVAL_HW = ((375, 500), (500, 375))
EVAL_OBJECTS = 3
EVAL_CFG_FILE = "experiments/cfgs/res101.yml"
EVAL_SET = ["TPU.IMS_PER_DEVICE", str(BATCH)]
EVAL_WEIGHTS = "res101_seed0.pt"
PREP_TOL = 0.02
# phase 12: the train loop at EVAL_CFG_FILE, B = 8, on a trainval split at
# VOC's sizes (landscape, portrait; x2 with the flipped entries) numbered
# apart from the test split, which is the loop's imdbval. The run a user
# makes (default algorithms, the prefetcher on) takes LOOP_STEPS: snapshots
# at steps 4, 8 and 11 (two kept), the eval at step 8, steps 3-8 timed and
# PROFILE_STEPS traced; the deterministic pair takes LOOP_ITERS images, 8
# steps, and resumes from step 4
LOOP_COUNTS = (24, 8)
LOOP_FIRST = 1000
LOOP_ITERS = 64
LOOP_STEPS = 11
PROFILE_STEPS = (9, 11)
LOOP_SET = ["TPU.IMS_PER_DEVICE", str(BATCH), "TRAIN.SNAPSHOT_ITERS", "32",
            "TRAIN.SNAPSHOT_KEPT", "2", "TPU.EVAL_ITERS", "64",
            "TRAIN.ASPECT_GROUPING", "True", "TRAIN.DISPLAY", "4"]
LOOP_PREFIX = "res101_faster_rcnn"
# the resumed run against the unbroken one, per tensor, relative to its
# largest magnitude. Both run with torch's deterministic algorithms (the
# crop's backward otherwise adds atomically, in an order that changes each
# run; phase 6 holds one such step to 1e-6, but over four steps a last-bit
# change flips a proposal or a sampled RoI); the tolerance leaves room for
# an op that torch runs nondeterministically all the same (printed)
RESUME_TOL = 1e-5
CLI_ITERS = 16
# phase 13: what loading a bundle must not import (nor JAX, flax or the JAX
# package)
SERVE_FORBIDDEN = ("tf_faster_rcnn_torch.models",
                   "tf_faster_rcnn_torch.engine",
                   "tf_faster_rcnn_torch.config")
# phase 14: reference_init at full width, and the JAX gate on the init's
# backbone-output std on a pixel-scale input; the overfit drill's TRAIN
# and TEST post-NMS counts (tools/overfit_check.py::configure_tiny)
INIT_NETS = ("res101", "vgg16", "mobile")
INIT_HW = (96, 128)
INIT_STD = (0.05, 20.0)
OVERFIT_KEEP = (48, 32)
# phase 15: the rehearsal's second eval config
REHEARSAL_LG_CFG = "experiments/cfgs/res101-lg.yml"
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


def scene_rectangles(rng, batch, h, w):
    """The rectangles synthetic_scenes paints, per image, as inclusive
    (x1, y1, x2, y2) pixel boxes: the same draws from a RandomState in the
    state synthetic_scenes is given."""
    rng.randint(0, 60, (batch, h, w, 3))
    rects = []
    for _ in range(batch):
        image = []
        for _ in range(rng.randint(2, 7)):
            x1 = rng.randint(0, w - 40)
            y1 = rng.randint(0, h - 40)
            x2 = x1 + rng.randint(30, min(w - x1, w // 2))
            y2 = y1 + rng.randint(30, min(h - y1, h // 2))
            rng.randint(140, 255, 3)
            image.append((x1, y1, x2 - 1, y2 - 1))
        rects.append(image)
    return rects


def sorted_boxes(rng, n):
    """tests/test_pallas_nms.py's generator: boxes sorted by a random
    score."""
    c = rng.uniform(30, 350, (n, 2))
    wh = rng.uniform(10, 90, (n, 2))
    dets = np.concatenate([c - wh / 2, c + wh / 2, rng.rand(n, 1)],
                          axis=1).astype(np.float32)
    order = np.argsort(-dets[:, 4], kind="stable")
    return dets[order, :4]


def edge_cases(rng):
    """Inputs on which a wrong quick reject, a wrong IoU convention or a
    broken chain across row blocks would give another mask: a list of
    (name, boxes [G, N, 4] f32, valid [G, N] bool, thresh, plus_one,
    suppress_eq), every instance in score order.

    * edges: boxes on a 10-pixel lattice, so that many share an edge or a
      corner exactly (iw == 0 without +1, iw == 1 with +1);
    * degenerate: zero-area, inverted and sub-pixel boxes (uni <= 0 with
      +1), among normal ones;
    * chain: a row in which each box overlaps only the next one, so each
      box's fate hangs on all before it (a chain of depth N);
    * each with thresh 0.0 and suppress_eq, where every box suppresses."""
    def edges(g, n):
        xy = rng.randint(0, 8, (g, n, 2)) * 10.0
        wh = rng.randint(1, 3, (g, n, 2)) * 10.0
        return np.concatenate([xy, xy + wh], -1).astype(np.float32)

    def degenerate(g, n):
        xy = rng.uniform(0, 50, (g, n, 2))
        wh = rng.choice([-2.0, -1.0, -0.5, 0.0, 0.5, 1.0, 7.0, 20.0],
                        (g, n, 2))
        wh = np.where(rng.rand(g, n, 2) < 0.5, wh, rng.uniform(0, 30, (g, n, 2)))
        return np.concatenate([xy, xy + wh], -1).astype(np.float32)

    def chain(g, n):
        x = np.arange(n, dtype=np.float32)[None, :, None] * 6.0
        row = np.concatenate([x, 0 * x, x + 10, 0 * x + 10], -1)
        return np.repeat(row, g, axis=0).astype(np.float32)

    cases = []
    for name, make, g, n in (("edges", edges, 2, 500),
                             ("degenerate", degenerate, 2, 500),
                             ("chain", chain, 2, 1000),
                             ("chain", chain, 1, 6000)):
        boxes = make(g, n)
        valid = rng.rand(g, n) > 0.05
        if name == "chain":
            valid[:] = True
        for plus_one, suppress_eq, thresh in ((False, False, 0.2),
                                              (True, False, 0.01),
                                              (True, True, 0.0),
                                              (False, False, 0.0)):
            cases.append((f"{name} N={n}", boxes, valid, thresh, plus_one,
                          suppress_eq))
    return cases


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


def graph_ms(fn, calls=20, replays=5):
    """Device time of one fn() call: `calls` calls captured in one CUDA
    graph, replayed after a warm-up, so the Python wrapper's own time drops
    out."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    return cuda_ms(graph.replay, replays) / calls


def needed_tests(keep, boxes, valid, thresh, *, plus_one=False,
                 suppress_eq=False, max_keep=None):
    """The IoU tests greedy NMS needs on this data, given its answer keep:
    a kept box is tested against every kept box before it, a suppressed box
    against the kept boxes before it up to its first suppressor, and no box
    past E (the index of the max_keep-th keep; every box without a cap) is
    tested. Counted on the card, in chunks of instances."""
    import torch
    from tf_faster_rcnn_torch.ops.boxes import bbox_overlaps
    g, n = keep.shape
    dev = keep.device
    pos = torch.arange(n, device=dev)
    extent = (k1_extent(keep, max_keep) if max_keep is not None
              else [n - 1] * g)
    upto = pos[None, :] <= torch.tensor(extent, device=dev)[:, None]
    kept = keep.long()
    tests = int(((torch.cumsum(kept, dim=1) - kept) * (keep & upto)).sum())
    count = kept.sum(dim=1)
    width = int(count.max())
    if width == 0:
        return tests
    # the kept boxes of each instance, in order, in the first `width` slots
    order = torch.sort((~keep).to(torch.uint8), dim=1, stable=True).indices
    order = order[:, :width]
    slots = torch.arange(width, device=dev)
    thresh = torch.tensor(thresh, dtype=torch.float32, device=dev)
    suppressed = valid & ~keep & upto
    step = max(1, 2**26 // (n * width))
    for s in range(0, g, step):
        e = min(s + step, g)
        kbox = torch.gather(boxes[s:e], 1,
                            order[s:e, :, None].expand(-1, -1, 4))
        iou = bbox_overlaps(kbox, boxes[s:e], plus_one)          # [c, K, N]
        over = ((iou >= thresh) if suppress_eq else (iou > thresh))
        over &= (slots[None, :] < count[s:e, None])[:, :, None]
        over &= order[s:e, :, None] < pos[None, None, :]
        first = torch.argmax(over.to(torch.uint8), dim=1)           # [c, N]
        hit = over.any(dim=1)
        if not bool(hit[suppressed[s:e]].all()):
            raise AssertionError("a suppressed box has no kept suppressor")
        tests += int(((first + 1) * suppressed[s:e]).sum())
    return tests


def bound(keep, boxes, valid, thresh, *, plus_one=False, suppress_eq=False,
          max_keep=None):
    """(bound_ms, bound_by, tests) for one NMS call on these inputs: the
    larger of its bytes (boxes and valid read once, keep written once) over
    the HBM rate and its needed IoU tests (needed_tests) over the float32
    rate."""
    tests = needed_tests(keep, boxes, valid, thresh, plus_one=plus_one,
                         suppress_eq=suppress_eq, max_keep=max_keep)
    nbytes = boxes.numel() * 4 + valid.numel() + keep.numel()
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = tests * FLOP_PER_TEST / F32_FLOP_S * 1e3
    if t_bytes >= t_ops:
        return t_bytes, "bytes", tests
    return t_ops, "operations", tests


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

    for name, boxes, valid, thresh, plus_one, suppress_eq in edge_cases(rng):
        boxes = torch.from_numpy(boxes).to(dev)
        valid = torch.from_numpy(valid).to(dev)
        kw = dict(plus_one=plus_one, suppress_eq=suppress_eq)
        case = f"{name} thresh={thresh} {kw}"
        for max_keep in (None, 40):
            check("nms_keep_mask_batched",
                  K.nms_keep_mask_batched(boxes, valid, thresh,
                                          max_keep=max_keep, **kw),
                  K.nms_keep_mask_plain(boxes, valid, thresh,
                                        max_keep=max_keep, **kw),
                  f"{case} max_keep={max_keep}")
        if boxes.shape[1] <= 1000:
            check("batched_nms_keep", K.batched_nms_keep(boxes, valid, thresh, **kw),
                  K.batched_nms_keep_plain(boxes, valid, thresh, **kw), case)

    boxes, valid = train_shape_inputs(dev)
    got = K.nms_keep_mask_batched(boxes, valid, 0.7, max_keep=2000)
    check("nms_keep_mask_batched", got,
          K.nms_keep_mask_plain(boxes, valid, 0.7, max_keep=2000),
          "TRAIN shape [8, 12000] max_keep=2000")
    print(f"  K1 E per image at the TRAIN shape: {k1_extent(got, 2000)}")
    return err


def train_shape_inputs(dev):
    """K1's TRAIN-mode shape (RPN 12000 -> 2000, ROADMAP slice 2), B = 8,
    on random score-sorted boxes."""
    import torch
    rng = np.random.RandomState(SEED + 1)
    boxes = np.stack([sorted_boxes(rng, 12000) for _ in range(BATCH)])
    return (torch.from_numpy(boxes).to(dev),
            torch.from_numpy(rng.rand(BATCH, 12000) > 0.05).to(dev))


def coco_shape_inputs(dev):
    """K2's shape at the COCO lg config: 8 images x 80 classes = 640
    instances of 1000 boxes, on random score-sorted boxes."""
    import torch
    rng = np.random.RandomState(SEED + 2)
    boxes = np.stack([sorted_boxes(rng, 1000) for _ in range(640)])
    return (torch.from_numpy(boxes).to(dev),
            torch.from_numpy(rng.rand(640, 1000) > 0.1).to(dev))


@contextlib.contextmanager
def nms_route(plain=False, record=None, log=None):
    """Route the detect path's two NMS calls: through the plain versions
    (plain=True), and/or record each call's arguments in record[name], and/or
    append every call's (name, args, kwargs) to log."""
    from tf_faster_rcnn_torch.engine import detect as detect_mod
    from tf_faster_rcnn_torch.ops import nms as nms_mod
    from tf_faster_rcnn_torch.ops import nms_kernels as K
    saved = (nms_mod.nms_keep_mask_batched, detect_mod.batched_nms_keep)

    def route(name, kernel, plain_fn):
        fn = plain_fn if plain else kernel

        def call(*args, **kwargs):
            if record is not None:
                record[name] = (args, kwargs)
            if log is not None:
                log.append((name, args, kwargs))
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


def build_spec():
    """The main path's spec: res101 TEST at the cfg defaults."""
    from tf_faster_rcnn_torch.models.network import ModelSpec
    return ModelSpec("res101", NUM_CLASSES, rpn_pre_nms_top_n=6000,
                     rpn_post_nms_top_n=300)


def build_main_path(dev):
    import torch
    from tf_faster_rcnn_torch.engine.test_engine import make_detect_fn
    from tf_faster_rcnn_torch.models.init import init_model
    from tf_faster_rcnn_torch.models.network import FasterRCNN
    spec = build_spec()
    model = FasterRCNN(spec).eval()       # built on the card by default
    init_model(model, torch.Generator().manual_seed(SEED))
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
        got = kernel(*args, **kwargs)
        check_equal(errors, name, got, plain(*args, **kwargs),
                    f"main path {tuple(args[0].shape)} {kwargs}")
        if name == "nms_keep_mask_batched":
            print(f"  K1 E per image: {k1_extent(got, kwargs['max_keep'])} "
                  f"of N={got.shape[1]}")
    return launches, captured, (det, dv)


def k1_extent(keep, max_keep):
    """E per image: the index of the max_keep-th kept box (N if fewer are
    kept). K1's answer depends on no box past E."""
    import torch
    n = keep.shape[1]
    count = torch.cumsum(keep.int(), dim=1)
    reached = count[:, -1] >= max_keep
    first = torch.argmax((count >= max_keep).int(), dim=1)
    return torch.where(reached, first, torch.full_like(first, n)).tolist()


def kernel_row(card, label, name, args, kwargs, launches):
    """One kernel on one path's captured inputs: graph-replay time (the
    better of two), one plain call after one warm-up, and the bound; printed
    and returned as the kernel line's "paths" entry."""
    kernel, plain = kernel_pairs()[name]
    t = min(graph_ms(lambda: kernel(*args, **kwargs)) for _ in range(2))
    t_plain = timed(lambda: plain(*args, **kwargs), iters=1, warmup=1)
    keep = kernel(*args, **kwargs)
    b_ms, b_by, tests = bound(keep, *args, **kwargs)
    extent = ""
    if kwargs.get("max_keep") is not None:
        extent = f", E per image {k1_extent(keep, kwargs['max_keep'])}"
    print(f"time {name} on the {label} path {tuple(args[0].shape)} {kwargs}: "
          f"kernel {t:.4f} ms (graph replay), plain {t_plain:.4f} ms, bound "
          f"{b_ms:.6f} ms by {b_by} ({tests} IoU tests), share "
          f"{b_ms / t:.4f}, launches {launches}{extent} [{card}]")
    return {"launches": launches, "ms": t, "plain_ms": t_plain,
            "bound_ms": b_ms, "bound_by": b_by}


def phase_times(card, model, detect, inputs, captured):
    import torch
    from tf_faster_rcnn_torch.engine.detect import postprocess_detections
    times = {}
    for name, (kernel, plain) in kernel_pairs().items():
        args, kwargs = captured[name]
        shape = tuple(args[0].shape)
        # plain, kernel, kernel, plain: the pairs share one card and warm-up
        t_plain = timed(lambda: plain(*args, **kwargs), iters=3, warmup=1)
        t_call = timed(lambda: kernel(*args, **kwargs))
        t_kernel = graph_ms(lambda: kernel(*args, **kwargs))
        t_kernel = min(t_kernel, graph_ms(lambda: kernel(*args, **kwargs)))
        t_call = min(t_call, timed(lambda: kernel(*args, **kwargs)))
        t_plain = min(t_plain, timed(lambda: plain(*args, **kwargs),
                                     iters=3, warmup=1))
        b_ms, b_by, tests = bound(kernel(*args, **kwargs), *args, **kwargs)
        times[name] = (t_kernel, t_plain, b_ms, b_by)
        print(f"time {name} {shape}: kernel {t_kernel:.4f} ms (graph "
              f"replay; {t_call:.4f} ms per call from Python), plain "
              f"{t_plain:.4f} ms, bound {b_ms:.6f} ms by {b_by} ({tests} "
              f"IoU tests), share {b_ms / t_kernel:.4f} [{card}]")

    from tf_faster_rcnn_torch.ops import nms_kernels as K
    dev = inputs[0].device
    for label, fn, (boxes, valid), thresh, kw in (
            ("K1 TRAIN shape", K.nms_keep_mask_batched,
             train_shape_inputs(dev), 0.7, dict(max_keep=2000)),
            ("K2 COCO shape", K.batched_nms_keep, coco_shape_inputs(dev),
             0.3, dict(plus_one=True))):
        t = graph_ms(lambda: fn(boxes, valid, thresh, **kw), calls=5)
        b_ms, b_by, tests = bound(fn(boxes, valid, thresh, **kw), boxes,
                                  valid, thresh, **kw)
        print(f"time {label} {tuple(boxes.shape)} {kw}: kernel {t:.4f} ms "
              f"(graph replay), bound {b_ms:.6f} ms by {b_by} ({tests} IoU "
              f"tests), share {b_ms / t:.4f} [{card}]")

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


def train_batch(dev, seed=SEED):
    """The train path's batch: bench.py's scenes, and as gt the rectangles
    they paint (clipped to the image extent), with classes from the seed in
    1..20, padded to MAX_GT with a validity mask."""
    import torch
    h, w = CANVAS
    image = synthetic_scenes(np.random.RandomState(seed), BATCH, h, w)
    rects = scene_rectangles(np.random.RandomState(seed), BATCH, h, w)
    classes = np.random.RandomState(seed + 3)
    gt = np.zeros((BATCH, MAX_GT, 5), np.float32)
    gt_valid = np.zeros((BATCH, MAX_GT), bool)
    for b, image_rects in enumerate(rects):
        for i, (x1, y1, x2, y2) in enumerate(image_rects):
            gt[b, i] = (x1, y1, min(x2, IM_HW[1] - 1), min(y2, IM_HW[0] - 1),
                        classes.randint(1, NUM_CLASSES))
            gt_valid[b, i] = True
    im_info = [[IM_HW[0], IM_HW[1], 1.6]] * BATCH
    return {"image": torch.from_numpy(image).to(dev),
            "im_info": torch.tensor(im_info, device=dev),
            "gt_boxes": torch.from_numpy(gt).to(dev),
            "gt_valid": torch.from_numpy(gt_valid).to(dev)}


def build_train_path(dev, backbone="res101", extra_cfg=()):
    """The backbone's train step at its YAML's TRAIN settings and
    extra_cfg, from the entry points a user calls: spec_from_cfg,
    FasterRCNN, create_train_state, make_train_step."""
    import torch
    from tf_faster_rcnn_torch.config import cfg, cfg_from_list, reset_cfg
    from tf_faster_rcnn_torch.engine.train import (create_train_state,
                                                   make_train_step)
    from tf_faster_rcnn_torch.models.init import init_model
    from tf_faster_rcnn_torch.models.network import FasterRCNN, spec_from_cfg
    reset_cfg()
    cfg_from_list(BACKBONE_TRAIN_CFG[backbone] + list(extra_cfg))
    spec = spec_from_cfg(backbone, NUM_CLASSES, "TRAIN")
    model = FasterRCNN(spec)
    init_model(model, torch.Generator().manual_seed(SEED))
    state = create_train_state(
        spec, model, torch.Generator(device=dev).manual_seed(SEED),
        batch_size=BATCH)
    step = make_train_step(
        model, spec, weight_decay=float(cfg.TRAIN.WEIGHT_DECAY),
        bias_decay=bool(cfg.TRAIN.BIAS_DECAY),
        mobile_weight_decay=float(cfg.MOBILENET.WEIGHT_DECAY),
        regu_depth=bool(cfg.MOBILENET.REGU_DEPTH), lr_fn=state.tx.lr_fn,
        nan_guard=bool(cfg.TPU.NAN_GUARD))
    reset_cfg()
    return spec, state, step, train_batch(dev)


@contextlib.contextmanager
def record_outputs(record):
    """Record in record[name] the last output of the train path's proposal
    selection (sorted_nms) and of its two samplers."""
    from tf_faster_rcnn_torch.models import network
    names = ("sorted_nms", "anchor_target", "proposal_target")
    saved = {name: getattr(network, name) for name in names}

    def wrap(name, fn):
        def call(*args, **kwargs):
            record[name] = fn(*args, **kwargs)
            return record[name]
        return call

    for name in names:
        setattr(network, name, wrap(name, saved[name]))
    try:
        yield
    finally:
        for name in names:
            setattr(network, name, saved[name])


def _param_groups(model):
    """The parameters that must stay bitwise frozen (the backbone's frozen
    prefix: res101's stem and block1, vgg16's conv1-conv2, mobile's first
    FIXED_LAYERS layers), and the groups that must move, by name."""
    named = list(model.named_parameters())
    frozen = [n for n, p in named if not p.requires_grad]
    moved = {group: [n for n, p in named if n.startswith(prefix)
                     and p.requires_grad]
             for group, prefix in (("head", "head."), ("tail", "tail."),
                                   ("rpn", "rpn_"), ("cls_score", "cls_score"),
                                   ("bbox_pred", "bbox_pred"))}
    return frozen, moved


def phase_train_path(card, spec, state, step, batch, errors,
                     steps=TRAIN_STEPS, compare=True):
    """Drive the train step (section 6 of the docstring; without compare,
    the steps and their checks only, and K1 against its plain version on
    the last step's inputs); returns the K1 launches of its run and K1's
    captured inputs."""
    import torch
    from tf_faster_rcnn_torch.models.network import draw_noise
    from tf_faster_rcnn_torch.ops import nms_kernels as K
    model = state.model
    frozen, moved = _param_groups(model)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    record, metrics = {}, []
    K.reset_launch_counts()
    per_step = []
    for _ in range(steps):
        with nms_route(record=record):
            state, m = step(state, batch)
        args, kwargs = record["nms_keep_mask_batched"]
        per_step.append((K.launch_counts()["nms_keep_mask_batched"],
                         tuple(args[0].shape), kwargs["max_keep"]))
        metrics.append(m)
    torch.cuda.synchronize()
    launches = K.launch_counts()
    print(f"train path: {spec.backbone} {spec.compute_dtype} B={BATCH} "
          f"{CANVAS[0]}x{CANVAS[1]} "
          f"{spec.num_classes} classes {spec.rpn_pre_nms_top_n}->"
          f"{spec.rpn_post_nms_top_n}, {spec.rpn_batchsize} anchors and "
          f"{spec.roi_batch_size} RoIs per image; launches {launches}; K1 "
          f"per step (count, shape, max_keep): {per_step}")
    n_anchors = (CANVAS[0] // spec.feat_stride) * (
        CANVAS[1] // spec.feat_stride) * spec.num_anchors
    want = [(i + 1, (BATCH, min(spec.rpn_pre_nms_top_n, n_anchors), 4),
             spec.rpn_post_nms_top_n) for i in range(steps)]
    if per_step != want or launches["batched_nms_keep"] != 0:
        raise AssertionError(f"K1 launches per step {per_step} != {want}, "
                             f"or K2 launched on the train path")
    for i, m in enumerate(metrics):
        row = {k: round(float(v), 6) for k, v in m.items()}
        print(f"  step {i + 1}: {row}")
        if not all(np.isfinite(list(row.values()))):
            raise AssertionError(f"step {i + 1}: a metric is not finite")
        if row["step_skipped"] != 0.0:
            raise AssertionError(f"step {i + 1} was skipped by the NaN guard")
        if not (row["rpn_cross_entropy"] > 0 and row["cross_entropy"] > 0):
            raise AssertionError(f"step {i + 1}: a cross-entropy is 0")
    params = dict(model.named_parameters())
    changed = [n for n in frozen if not torch.equal(params[n], before[n])]
    still = [n for group in moved.values() for n in group
             if torch.equal(params[n], before[n])]
    print(f"  frozen prefix: {len(frozen)} tensors, bitwise "
          f"unchanged: {not changed}; moved: " + ", ".join(
              f"{g} {len(ns)}" for g, ns in moved.items())
          + f", all moved: {not still}")
    if changed or still or not frozen:
        raise AssertionError(f"frozen tensors changed {changed[:3]}, or "
                             f"trainable ones did not move {still[:3]}")
    if not compare:
        args, kwargs = record["nms_keep_mask_batched"]
        check_equal(errors, "nms_keep_mask_batched",
                    K.nms_keep_mask_batched(*args, **kwargs),
                    K.nms_keep_mask_plain(*args, **kwargs),
                    f"train path {tuple(args[0].shape)} {kwargs}")
        return launches, (args, kwargs)

    # one step from the same state and noise, through K1 and the plain K1
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    snapshot = state.state_dict()
    fh, fw = CANVAS[0] // spec.feat_stride, CANVAS[1] // spec.feat_stride
    noise = draw_noise(state.generator, BATCH, fh * fw * spec.num_anchors,
                       spec.rpn_post_nms_top_n, batch["image"].device)
    results = []
    for plain in (False, True):
        state.load_state_dict(snapshot)
        outs, k1 = {}, {}
        with nms_route(plain=plain, record=k1), record_outputs(outs):
            _, m = step(state, batch, noise=noise)
        torch.cuda.synchronize()
        results.append((outs, float(m["total_loss"]), {
            n: p.detach().clone() for n, p in model.named_parameters()}))
        if not plain:
            captured = k1["nms_keep_mask_batched"]
    (ko, kloss, kparams), (po, ploss, pparams) = results
    checks = {
        "proposals": all(torch.equal(a, b) for a, b in
                         zip(ko["sorted_nms"], po["sorted_nms"])),
        "sampled rois": torch.equal(ko["proposal_target"].rois,
                                    po["proposal_target"].rois),
        "roi labels": torch.equal(ko["proposal_target"].labels,
                                  po["proposal_target"].labels),
        "roi valid": torch.equal(ko["proposal_target"].valid,
                                 po["proposal_target"].valid),
        "anchor labels": torch.equal(ko["anchor_target"].labels,
                                     po["anchor_target"].labels),
    }
    loss_err = abs(kloss - ploss) / abs(ploss)
    # bf16: the crop's backward scatters with atomic adds in bf16, each
    # rounding at 2^-8 in an order that varies from run to run
    param_tol = 1e-6 if spec.compute_dtype == "float32" else 1e-3
    param_err = max(float((kparams[n] - pparams[n]).abs().max())
                    / max(float(pparams[n].abs().max()), 1e-30)
                    for n in kparams)
    print(f"  kernel path vs plain path (deterministic cuDNN): {checks}; "
          f"total loss {kloss:.7f} vs {ploss:.7f} (rel {loss_err:.2e}, "
          f"tol 1e-6); parameters max rel {param_err:.2e} (tol "
          f"{param_tol:g})")
    if not all(checks.values()) or loss_err > 1e-6 or param_err > param_tol:
        raise AssertionError("kernel and plain train paths differ")
    torch.backends.cudnn.deterministic = False
    args, kwargs = captured
    got = K.nms_keep_mask_batched(*args, **kwargs)
    check_equal(errors, "nms_keep_mask_batched", got,
                K.nms_keep_mask_plain(*args, **kwargs),
                f"train path {tuple(args[0].shape)} {kwargs}")
    print(f"  K1 E per image on the train path: "
          f"{k1_extent(got, kwargs['max_keep'])} of N={got.shape[1]}")

    # the step makes no host sync
    control = host_syncs(lambda: float(batch["im_info"][0, 0]))
    found = host_syncs(lambda: step(state, batch))
    print(f"  host syncs in one train step: {len(found)} (the detector "
          f"found {len(control)} in one .item())")
    if found or not control:
        raise AssertionError(f"the train step synchronizes ({found[:1]}), "
                             "or the detector finds no sync")
    return launches, captured


def host_syncs(fn):
    """The host syncs fn() makes: torch warns at each synchronizing call it
    knows of (a prototype: not every one, by its own notice)."""
    import torch
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return [str(w.message) for w in caught
            if "called a synchronizing" in str(w.message)]


def phase_train_times(card, state, step, batch, captured, label="train",
                      iters=ITERS, launches=1):
    """The train step's time and peak memory, and K1's on its inputs;
    returns (K1's row for the kernel line, the step's ms)."""
    import torch
    spec = state.model.spec
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms = timed(lambda: step(state, batch), iters=iters)
    peak = torch.cuda.max_memory_allocated()
    print(f"time {label} step: {ms:.3f} ms, {BATCH * 1000.0 / ms:.2f} "
          f"images/s ({spec.backbone} {spec.compute_dtype}, TF32 off, "
          f"B={BATCH}, mean of {iters}), peak memory "
          f"{peak / 2**30:.3f} GiB [{card}]")
    args, kwargs = captured
    return kernel_row(card, label, "nms_keep_mask_batched", args, kwargs,
                      launches), ms


def build_detect_path(dev, spec, batch=BATCH):
    """A detect step of spec through make_detect_fn, with phase 4's seeded
    weights and scenes (the first `batch` of them)."""
    import torch
    from tf_faster_rcnn_torch.engine.test_engine import make_detect_fn
    from tf_faster_rcnn_torch.models.init import init_model
    from tf_faster_rcnn_torch.models.network import FasterRCNN
    model = FasterRCNN(spec).eval()
    init_model(model, torch.Generator().manual_seed(SEED))
    h, w = CANVAS
    image = synthetic_scenes(np.random.RandomState(SEED), BATCH, h, w)
    image = torch.from_numpy(image[:batch]).to(dev)
    im_info = torch.tensor([[600.0, 1000.0, 1.6]] * batch, device=dev)
    orig_hw = torch.tensor([[375.0, 625.0]] * batch, device=dev)
    return model, make_detect_fn(model, spec), (image, im_info, orig_hw)


def matched_share(det, dv, ref, ref_valid, iou=0.9):
    """(matched, total): the valid detections of ref matched by a valid
    detection in det of the same class and image at IoU >= iou."""
    from tf_faster_rcnn_torch.ops.boxes import bbox_overlaps
    over = bbox_overlaps(ref[..., 2:], det[..., 2:], False)    # [B, D, D]
    same = ref[..., 0][:, :, None] == det[..., 0][:, None, :]
    hit = ((over >= iou) & same & dv[:, None, :]).any(dim=2) & ref_valid
    return int(hit.sum()), int(ref_valid.sum())


def phase_detect_path(card, dev, label, spec, errors, batch=BATCH,
                      reference=None):
    """One detect step of spec (sections 7, 9 and 10): launch counts from
    zero, the checks, each launched kernel against its plain version on
    this path's inputs, the step's time and peak memory, the kernels' rows;
    with reference (phase 4's float32 detections), the drift from them."""
    import torch
    from tf_faster_rcnn_torch.ops import nms_kernels as K
    from tf_faster_rcnn_torch.ops.anchors import anchor_grid_on
    t0 = time.perf_counter()
    model, detect, inputs = build_detect_path(dev, spec, batch)
    record = {}
    K.reset_launch_counts()
    with nms_route(record=record):
        det, dv = detect(*inputs)
    torch.cuda.synchronize()
    launches = K.launch_counts()
    top = spec.test_mode == "top"
    print(f"{label} path: {spec.backbone} {spec.compute_dtype} B={batch} "
          f"{CANVAS[0]}x{CANVAS[1]} {spec.num_classes} classes, proposals "
          + (f"top {spec.rpn_top_n}" if top else
             f"{spec.rpn_pre_nms_top_n}->{spec.rpn_post_nms_top_n}")
          + f"; launches {launches}")
    want_k1 = 0 if top else 1
    if launches != {"nms_keep_mask_batched": want_k1, "batched_nms_keep": 1}:
        raise AssertionError(f"{label}: launches {launches}, want K1 "
                             f"{want_k1} and K2 1")
    if tuple(det.shape) != (batch, spec.max_per_image, 6) \
            or not bool(torch.isfinite(det).all()):
        raise AssertionError(f"{label}: detections {tuple(det.shape)} or "
                             "not finite")
    per_image = dv.sum(dim=1).tolist()
    print(f"  valid detections per image: {per_image}")
    if min(per_image) < 1:
        raise AssertionError(f"{label}: an image has no valid detection")
    if top:
        with torch.inference_mode():
            out = model(inputs[0], inputs[1])
        scores, valid = out["roi_scores"], out["roi_valid"]
        ordered = bool((scores.diff(dim=1) <= 0).all())
        print(f"  'top' proposals: {tuple(out['rois'].shape)}, all valid "
              f"{bool(valid.all())}, sorted descending {ordered}")
        if not (ordered and bool(valid.all())):
            raise AssertionError(f"{label}: proposals not sorted or invalid")
    if reference is not None:
        hit, total = matched_share(det, dv, *reference)
        print(f"  drift from float32: {hit} of {total} float32 detections "
              f"({hit / max(total, 1):.4f}) matched by a {spec.compute_dtype} "
              f"one of the same class at IoU >= 0.9 (printed, not gated)")
    for name, (args, kwargs) in record.items():
        kernel, plain = kernel_pairs()[name]
        check_equal(errors, name, kernel(*args, **kwargs),
                    plain(*args, **kwargs),
                    f"{label} path {tuple(args[0].shape)} {kwargs}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms = timed(lambda: detect(*inputs))
    peak = torch.cuda.max_memory_allocated()
    print(f"time {label} step: {ms:.3f} ms, {batch * 1000.0 / ms:.2f} "
          f"images/s ({spec.backbone} {spec.compute_dtype}, TF32 off, "
          f"B={batch}, mean of {ITERS}), peak memory {peak / 2**30:.3f} GiB "
          f"[{card}]")
    # the anchor grid each forward builds, alone: its host enqueue beside
    # the step's (a host-bound step pays it in full) and its device time
    fh, fw = (c // spec.feat_stride for c in CANVAS)
    grid = functools.partial(anchor_grid_on, fh, fw, dev, spec.feat_stride,
                             spec.anchor_scales, spec.anchor_ratios)
    grid_ms = graph_ms(grid)
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(ITERS):
        grid()
    host_ms = (time.perf_counter() - t) * 1e3 / ITERS
    torch.cuda.synchronize()
    print(f"time {label} anchor grid ({fh}x{fw}x{spec.num_anchors}, built by "
          f"each forward): {host_ms:.3f} ms of host enqueue (mean of "
          f"{ITERS}), {grid_ms:.4f} ms on the card (graph replay) [{card}]")
    rows = {name: kernel_row(card, label, name, args, kwargs, launches[name])
            for name, (args, kwargs) in record.items()}
    print(f"phase {label}: {time.perf_counter() - t0:.1f} s")
    return rows


def phase_train_variant(card, dev, label, errors, backbone="res101",
                        extra_cfg=(), steps=BACKBONE_TRAIN_STEPS,
                        compare=False, iters=3):
    """A train path other than phase 6's (sections 8 and 9); returns K1's
    row."""
    import torch
    t0 = time.perf_counter()
    spec, state, step, batch = build_train_path(dev, backbone, extra_cfg)
    launches, k1 = phase_train_path(card, spec, state, step, batch, errors,
                                    steps=steps, compare=compare)
    row, _ = phase_train_times(card, state, step, batch, k1, label, iters,
                               launches["nms_keep_mask_batched"] // steps)
    del state, step, batch
    torch.cuda.empty_cache()
    print(f"phase {label}: {time.perf_counter() - t0:.1f} s")
    return row

def write_eval_tree(root, seed=SEED, split="test",
                    counts=(EVAL_LANDSCAPE, EVAL_PORTRAIT), first=0):
    """A VOCdevkit2007 split under root: counts[0] landscape and counts[1]
    portrait images of dark noise, each with EVAL_OBJECTS painted
    rectangles whose classes cycle through the 20 VOC classes, as binary
    PPM under .jpg names numbered from first, with XML annotations
    (1-based corners)."""
    from tf_faster_rcnn_torch.data.blob import write_ppm
    from tf_faster_rcnn_torch.datasets.pascal_voc import VOC_CLASSES
    rng = np.random.RandomState(seed)
    voc = os.path.join(root, "VOCdevkit2007", "VOC2007")
    for sub in ("JPEGImages", "Annotations", os.path.join("ImageSets",
                                                          "Main")):
        os.makedirs(os.path.join(voc, sub), exist_ok=True)
    names, n_obj = [], 0
    for i in range(sum(counts)):
        h, w = EVAL_HW[int(i >= counts[0])]
        im = rng.randint(0, 60, (h, w, 3)).astype(np.uint8)
        xml = ""
        for _ in range(EVAL_OBJECTS):
            bw, bh = rng.randint(40, w // 2), rng.randint(40, h // 2)
            x1, y1 = rng.randint(0, w - bw), rng.randint(0, h - bh)
            im[y1:y1 + bh, x1:x1 + bw] = rng.randint(140, 255, 3)
            xml += (f"<object><name>{VOC_CLASSES[1 + n_obj % 20]}</name>"
                    "<difficult>0</difficult><bndbox>"
                    f"<xmin>{x1 + 1}</xmin><ymin>{y1 + 1}</ymin>"
                    f"<xmax>{x1 + bw}</xmax><ymax>{y1 + bh}</ymax>"
                    "</bndbox></object>")
            n_obj += 1
        name = f"{first + i:06d}"
        names.append(name)
        write_ppm(os.path.join(voc, "JPEGImages", name + ".jpg"), im)
        with open(os.path.join(voc, "Annotations", name + ".xml"), "w") as f:
            f.write(f"<annotation><size><width>{w}</width><height>{h}"
                    f"</height><depth>3</depth></size>{xml}</annotation>")
    with open(os.path.join(voc, "ImageSets", "Main", split + ".txt"),
              "w") as f:
        f.write("\n".join(names) + "\n")


def host_ms(fn, iters=5):
    """Mean host time of fn() to a synchronize, after one warm-up, ms."""
    import torch
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t) / iters * 1e3


def quiet(fn):
    """(fn(), the lines fn printed)."""
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn()
    return out, buf.getvalue().splitlines()


def load_pickle(path):
    import pickle
    with open(path, "rb") as f:
        return pickle.load(f)


def equal_all_boxes(a, b):
    """Two detections.pkl trees: the same shape and equal arrays."""
    return len(a) == len(b) and all(
        len(ra) == len(rb) and all(np.array_equal(np.asarray(x), np.asarray(y))
                                   for x, y in zip(ra, rb))
        for ra, rb in zip(a, b))


def phase_eval(card, dev, errors):
    """Phase 11 (docstring): test_net and reval over a VOC tree on the
    card, in process and through the CLIs; returns the kernels' rows."""
    import tempfile
    import torch
    from tf_faster_rcnn_torch.config import (cfg, cfg_from_file,
                                             cfg_from_list, reset_cfg)
    t0 = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory(prefix="chip_smoke_eval_") as tmp:
        write_eval_tree(tmp)
        settings = EVAL_SET + ["DATA_DIR", tmp, "ROOT_DIR", tmp]
        reset_cfg()
        cfg_from_file(os.path.join(root, EVAL_CFG_FILE))
        cfg_from_list(settings)
        try:
            rows, model, all_boxes = eval_in_process(card, dev, errors, tmp)
            weights = os.path.join(tmp, EVAL_WEIGHTS)
            from tf_faster_rcnn_torch.utils.checkpoint import save_params
            save_params(weights, model)
            del model
            torch.cuda.empty_cache()
            eval_cli(root, tmp, weights, settings, all_boxes,
                     float(cfg.TEST.NMS))
        finally:
            reset_cfg()
    print(f"phase eval f32: {time.perf_counter() - t0:.1f} s")
    return rows


def eval_in_process(card, dev, errors, tmp):
    """test_net at the cfg in force (experiments/cfgs/res101.yml, B = 8) on
    phase 4's seeded weights: launches, kernels against their plain
    versions on the path's own inputs, the first batch's card canvases
    against CPU-built ones and its detections against make_detect_fn's,
    detections.pkl, mAP, ground truth scoring 1.0; then a second, timed
    run. Returns (the kernels' rows, the model, the run's all_boxes)."""
    import torch
    from tf_faster_rcnn_torch.config import bucket_index, canvas_buckets, cfg
    from tf_faster_rcnn_torch.data.blob import image_size, read_image_bgr
    from tf_faster_rcnn_torch.datasets.factory import get_imdb
    from tf_faster_rcnn_torch.engine import test_engine as E
    from tf_faster_rcnn_torch.models.init import init_model
    from tf_faster_rcnn_torch.models.network import FasterRCNN, spec_from_cfg
    from tf_faster_rcnn_torch.ops import nms_kernels as K
    spec = spec_from_cfg("res101", NUM_CLASSES, "TEST")
    if spec.compute_dtype != "float32" or int(cfg.TPU.IMS_PER_DEVICE) != BATCH:
        raise AssertionError(f"eval cfg: {spec.compute_dtype}, batch "
                             f"{cfg.TPU.IMS_PER_DEVICE}")
    model = FasterRCNN(spec).eval()
    init_model(model, torch.Generator().manual_seed(SEED))
    imdb = get_imdb("voc_2007_test")
    detect = E.make_detect_fn(model, spec)
    first = {}

    def recording(image, im_info, orig_hw):
        out = detect(image, im_info, orig_hw)
        if not first:
            first["in"] = tuple(x.clone() for x in (image, im_info, orig_hw))
            first["out"] = tuple(x.clone() for x in out)
        return out

    out_dir = os.path.join(tmp, "in_process")
    calls = []
    K.reset_launch_counts()
    with nms_route(log=calls):
        mean_ap, lines = quiet(lambda: E.test_net(
            model, spec, imdb, "in_process", output_dir=out_dir,
            detect_fn=recording))
    torch.cuda.synchronize()
    launches = K.launch_counts()
    buckets = canvas_buckets(cfg.TEST)
    sizes = [image_size(imdb.image_path_at(i)) for i in range(imdb.num_images)]
    groups = [[i for i, hw in enumerate(sizes)
               if bucket_index(*hw, buckets) == k]
              for k in range(len(buckets))]
    n_batches = sum(-(-len(g) // BATCH) for g in groups)
    print(f"eval path: res101 float32 B={BATCH} canvases {buckets}, "
          f"{imdb.num_images} images ({[len(g) for g in groups]} by bucket, "
          f"{n_batches} batches); launches {launches}; "
          + [ln for ln in lines if ln.startswith("[voc] mAP")][-1])
    want = {"nms_keep_mask_batched": n_batches, "batched_nms_keep": n_batches}
    if launches != want or len(buckets) != 2:
        raise AssertionError(f"eval: launches {launches}, want {want}; "
                             f"buckets {buckets}")
    for name, args, kwargs in calls:
        kernel, plain = kernel_pairs()[name]
        check_equal(errors, name, kernel(*args, **kwargs),
                    plain(*args, **kwargs),
                    f"eval path {tuple(args[0].shape)} {kwargs}")

    # the first batch: canvases built on the card against CPU-built ones,
    # with no host sync; detections against make_detect_fn's
    ims = [read_image_bgr(imdb.image_path_at(i)) for i in groups[0][:BATCH]]
    cpu = E._prep_batch(ims, buckets[0], "cpu")
    card_in = first["in"]
    prep_err = float((card_in[0].cpu() - cpu[0]).abs().max())
    exact = all(torch.equal(card_in[j].cpu(), cpu[j]) for j in (1, 2))
    control = host_syncs(lambda: float(card_in[1][0, 0]))
    found = host_syncs(lambda: E._prep_batch(ims, buckets[0], dev))
    d, v = detect(*card_in)
    same = torch.equal(d, first["out"][0]) and torch.equal(v, first["out"][1])
    print(f"  first batch: card canvases vs CPU-built max |diff| "
          f"{prep_err:.3g} (tol {PREP_TOL}), im_info and orig_hw equal {exact}; host syncs "
          f"in its prep {len(found)} (the detector found {len(control)} in "
          f"one .item()); detections equal to make_detect_fn's {same}")
    if prep_err > PREP_TOL or not exact or found or not control or not same:
        raise AssertionError("eval: first batch's canvases or detections")

    all_boxes = load_pickle(os.path.join(out_dir, "detections.pkl"))
    shape_ok = len(all_boxes) == NUM_CLASSES and all(
        len(row) == imdb.num_images for row in all_boxes) and all(
        b.dtype == np.float32 and b.shape[1:] == (5,)
        for row in all_boxes[1:] for b in row)
    n_dets = sum(len(b) for row in all_boxes[1:] for b in row)
    gt_boxes = [[np.zeros((0, 5), np.float32)] * imdb.num_images
                for _ in range(NUM_CLASSES)]
    for i, entry in enumerate(imdb.roidb):
        for c in range(1, NUM_CLASSES):
            boxes = entry["boxes"][entry["gt_classes"] == c]
            gt_boxes[c][i] = np.hstack([boxes, np.ones((len(boxes), 1))])
    gt_map, _ = quiet(lambda: imdb.evaluate_detections(
        gt_boxes, os.path.join(tmp, "gt")))
    print(f"  detections.pkl {len(all_boxes)} x {len(all_boxes[0])}, "
          f"float32 [N, 5]: {shape_ok}, {n_dets} detections; mAP {mean_ap:.6f}"
          f"; ground truth as detections: mAP {gt_map:.6f}")
    if not shape_ok or not 0.0 <= mean_ap <= 1.0 or gt_map != 1.0:
        raise AssertionError("eval: detections.pkl, mAP or ground truth mAP")

    # the timed run: the default detect_fn, decode to mAP
    timers = {}
    torch.cuda.synchronize()
    t = time.perf_counter()
    timed_map, _ = quiet(lambda: E.test_net(
        model, spec, imdb, "timed", output_dir=os.path.join(tmp, "timed"),
        timers=timers))
    seconds = time.perf_counter() - t
    again = equal_all_boxes(load_pickle(os.path.join(
        tmp, "timed", "detections.pkl")), all_boxes)
    n = imdb.num_images
    print(f"time eval: {seconds:.3f} s for {n} images = {n / seconds:.2f} "
          f"images/s end to end (decode to mAP; res101 f32, TF32 off, "
          f"B={BATCH}); per batch: im_detect "
          f"{timers['im_detect'].average_time * 1e3:.3f} ms, misc "
          f"{timers['misc'].average_time * 1e3:.3f} ms over "
          f"{timers['im_detect'].calls} batches [{card}]")
    print(f"  timed run: mAP {timed_map:.6f}, detections equal to the first "
          f"run's {again}")
    if not again or timed_map != mean_ap:
        raise AssertionError("eval: a second run gave other detections")
    paths = [imdb.image_path_at(i) for i in groups[0][:BATCH]]
    decode = host_ms(lambda: [read_image_bgr(p) for p in paths])
    prep = host_ms(lambda: E._prep_batch(ims, buckets[0], dev))
    step = timed(lambda: detect(*card_in))
    print(f"time eval split of a batch: decode {decode:.3f} ms (in the "
          f"worker threads), prep on the card {prep:.3f} ms (host clock to "
          f"a synchronize), detect step {step:.3f} ms (CUDA events); "
          f"im_detect {timers['im_detect'].average_time * 1e3:.3f} ms "
          f"[{card}]")
    rows = {}
    for name in kernel_pairs():
        args, kwargs = next((a, k) for nm, a, k in calls if nm == name)
        rows[name] = kernel_row(card, "eval f32", name, args, kwargs,
                                launches[name])
    return rows, model, all_boxes


def eval_cli(root, tmp, weights, settings, all_boxes, nms_thresh):
    """The CLIs on the saved weights, in subprocesses: test_net's
    detections.pkl equal to the in-process one, and reval --nms scoring
    what the host re-NMS of those detections scores."""
    from tf_faster_rcnn_torch.datasets.factory import get_imdb
    from tf_faster_rcnn_torch.engine.test_engine import apply_nms
    env = dict(CALLER_ENV, PYTHONPATH=root)

    def run(*args):
        t = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", *args], cwd=root,
                              env=env, capture_output=True, text=True,
                              timeout=600)
        if proc.returncode:
            raise AssertionError(f"{args[0]} exited {proc.returncode}:\n"
                                 f"{proc.stdout[-2000:]}{proc.stderr[-3000:]}")
        return proc.stdout.splitlines(), time.perf_counter() - t

    lines, seconds = run(
        "tf_faster_rcnn_torch.tools.test_net", "--cfg", EVAL_CFG_FILE,
        "--net", "res101", "--imdb", "voc_2007_test", "--model", weights,
        "--set", *settings)
    cli_dir = os.path.join(tmp, "output", "res101", "voc_2007_test",
                           EVAL_WEIGHTS)
    same = equal_all_boxes(load_pickle(os.path.join(cli_dir,
                                                    "detections.pkl")),
                           all_boxes)
    print(f"eval CLI: tools.test_net in {seconds:.1f} s (process start and "
          f"build included): {[ln for ln in lines if 'mAP' in ln][-1]}; "
          f"detections.pkl equal to the in-process run's {same}")
    lines, seconds = run("tf_faster_rcnn_torch.tools.reval", cli_dir,
                         "--imdb", "voc_2007_test", "--nms", "--set",
                         "DATA_DIR", tmp)
    got = [ln for ln in lines if ln.startswith("[voc] mAP")][-1]
    want, _ = quiet(lambda: get_imdb("voc_2007_test").evaluate_detections(
        apply_nms(all_boxes, nms_thresh), os.path.join(tmp, "nms")))
    print(f"eval CLI: tools.reval --nms in {seconds:.1f} s: {got}; the host "
          f"re-NMS in process: {want:.4f}")
    if not same or got != f"[voc] mAP = {want:.4f}":
        raise AssertionError("eval CLI: detections.pkl or reval --nms mAP")


def slim_var_dict(model, scope="resnet_v1_101"):
    """The backbone of a ResNet detector as an ImageNet slim var dict
    (``resnet_v1_101/...`` names, no detection heads), in the layouts TF
    writes: HWIO kernels, the stem's input channels in RGB order (the import
    flips them to BGR), BatchNorm as gamma/beta/moving_mean/
    moving_variance. Written from the state_dict here, apart from the
    port's weight bridges (utils/weights.py), so that the import is held to
    layouts of its own. Modeled on tests/test_slim_import.py::
    _fill_var_dict_from_tree."""
    import torch
    bn_names = {"scale": "gamma", "bias": "beta", "mean": "moving_mean",
                "var": "moving_variance"}
    var = {}
    for key, t in model.state_dict().items():
        path = key.split(".")
        if path[0] not in ("head", "tail"):
            continue                         # the detection heads
        x = t.detach().to("cpu", torch.float32).numpy()
        path, leaf = path[1:-1], path[-1]
        if path[0] in ("conv1", "conv1_bn"):   # head.conv1, head.conv1_bn
            base = f"{scope}/conv1"
        else:                      # {block}.{unit}.{conv}.conv|bn
            block, unit, conv = path[:3]
            base = f"{scope}/{block}/{unit}/bottleneck_v1/{conv}"
        if leaf == "weight":
            x = x.transpose(2, 3, 1, 0)                   # OIHW -> HWIO
            if path == ["conv1"]:
                x = x[:, :, ::-1, :]                      # BGR -> RGB
            var[f"{base}/weights"] = np.ascontiguousarray(x)
        else:
            var[f"{base}/BatchNorm/{bn_names[leaf]}"] = x
    return var


@contextlib.contextmanager
def loop_probe(record, profile_steps=None):
    """Instrument the train loop from outside: record[...] gets the
    backbone as loaded (before create_train_state casts or trains it),
    each step's host end time after a synchronize, its canvas and its K1/K2
    launches, the last (step, state, batch), and the wall time of each
    snapshot, eval and summary with the step count when it ran. With
    profile_steps (first, last), torch.profiler runs from the call of step
    first to the end of step last."""
    import torch
    from tf_faster_rcnn_torch.engine import train_loop as L
    from tf_faster_rcnn_torch.ops import nms_kernels as K
    sw = L.SolverWrapper
    saved = (L.create_train_state, L.make_train_step, sw.snapshot,
             sw._eval_map, sw._summary)
    ends = record.setdefault("ends", [])
    done = record.setdefault("steps", [])

    def create(spec, model, generator, batch_size=1):
        record["loaded"] = {k: v.detach().clone()
                            for k, v in model.state_dict().items()
                            if k.startswith(("head.", "tail."))}
        return saved[0](spec, model, generator, batch_size)

    def make_step(model, spec, **kwargs):
        step = saved[1](model, spec, **kwargs)

        def probed(state, batch):
            if "first" not in record:        # one host read, at the start
                record["first"] = int(state.step) + 1
            n = record["first"] + len(done)
            if profile_steps and n == profile_steps[0]:
                torch.cuda.synchronize()
                record["profiler"] = torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA])
                record["profiler"].start()
            before = K.launch_counts()
            out = step(state, batch)
            torch.cuda.synchronize()
            ends.append(time.perf_counter())
            after = K.launch_counts()
            done.append((n, tuple(batch["image"].shape[1:3]),
                         {k: after[k] - before[k] for k in after}))
            record["last"] = (step, state, batch)
            if profile_steps and n == profile_steps[1]:
                record["profiler"].stop()
            return out
        return probed

    def timed(index, key):
        def call(self, *args, **kwargs):
            t = time.perf_counter()
            out = saved[index](self, *args, **kwargs)
            torch.cuda.synchronize()
            record.setdefault(key, []).append(
                (len(ends), time.perf_counter() - t, out))
            return out
        return call

    L.create_train_state, L.make_train_step = create, make_step
    sw.snapshot, sw._eval_map, sw._summary = (
        timed(2, "snapshots"), timed(3, "evals"), timed(4, "summaries"))
    try:
        yield
    finally:
        (L.create_train_state, L.make_train_step, sw.snapshot, sw._eval_map,
         sw._summary) = saved


def device_idle(prof):
    """(busy ms, window ms, idle share) of the card in a profiler window:
    the union of its kernels' intervals against the span from the first
    kernel's start to the last one's end."""
    import torch
    spans = sorted((e.start_ns(), e.start_ns() + e.duration_ns())
                   for e in prof.profiler.kineto_results.events()
                   if e.device_type() == torch.autograd.DeviceType.CUDA
                   and e.duration_ns() > 0)
    if not spans:
        raise AssertionError("the profiler recorded no device time")
    busy, end = 0, spans[0][0]
    for s, e in spans:
        if e > end:
            busy += e - max(s, end)
            end = e
    window = spans[-1][1] - spans[0][0]
    return busy / 1e6, window / 1e6, 1.0 - busy / window


def phase_train_loop(card, dev, errors, bare_step_ms):
    """Phase 12 (docstring): train_net, a resume, the CLI; returns the
    kernels' rows on the loop's path."""
    import tempfile
    import torch
    from tf_faster_rcnn_torch.config import cfg, cfg_from_file, cfg_from_list
    from tf_faster_rcnn_torch.config import reset_cfg
    t0 = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory(prefix="chip_smoke_loop_") as tmp:
        write_eval_tree(tmp)
        write_eval_tree(tmp, seed=SEED + 1, split="trainval",
                        counts=LOOP_COUNTS, first=LOOP_FIRST)
        weights = os.path.join(tmp, "res101_imagenet.npz")
        reference = write_imagenet_npz(weights)
        settings = LOOP_SET + ["DATA_DIR", tmp, "ROOT_DIR", tmp]
        reset_cfg()
        cfg_from_file(os.path.join(root, EVAL_CFG_FILE))
        cfg_from_list(settings)
        try:
            rows = loop_in_process(card, dev, errors, tmp, weights,
                                   reference, bare_step_ms)
        finally:
            torch.use_deterministic_algorithms(False)
            reset_cfg()
        loop_cli(root, tmp, weights, settings)
    print(f"phase train loop: {time.perf_counter() - t0:.1f} s")
    return rows


def write_imagenet_npz(path):
    """Phase 4's seeded res101 weights (models/init.py at SEED), their
    backbone written to path as a slim var dict .npz; returns the model's
    state_dict, the reference the import is held to."""
    import torch
    from tf_faster_rcnn_torch.models.init import init_model
    from tf_faster_rcnn_torch.models.network import FasterRCNN
    model = FasterRCNN(build_spec(), device="cpu")
    init_model(model, torch.Generator().manual_seed(SEED))
    np.savez(path, **slim_var_dict(model))
    return model.state_dict()


def _loop_data(cfg):
    from tf_faster_rcnn_torch.tools.trainval_net import load_training_roidbs
    imdb, roidb = load_training_roidbs("voc_2007_trainval")
    saved, cfg.TRAIN.USE_FLIPPED = cfg.TRAIN.USE_FLIPPED, False
    try:
        valimdb, valroidb = load_training_roidbs("voc_2007_test")
    finally:
        cfg.TRAIN.USE_FLIPPED = saved
    return imdb, roidb, valimdb, valroidb


def loop_in_process(card, dev, errors, tmp, weights, reference,
                    bare_step_ms):
    """The run a user makes (LOOP_STEPS steps under default algorithms with
    the prefetcher on: checks and times), then the deterministic pair (an
    unbroken run of 8 steps and a resume from its step-4 snapshot: equal
    parameters and cursors) and the data layer's times. Returns the
    kernels' rows."""
    import shutil
    import torch
    from tf_faster_rcnn_torch.config import cfg
    from tf_faster_rcnn_torch.data.loader import RoIDataLayer
    from tf_faster_rcnn_torch.engine.train_loop import train_net
    from tf_faster_rcnn_torch.ops import nms_kernels as K
    from tf_faster_rcnn_torch.utils import checkpoint as ckpt
    (imdb, roidb, valimdb, valroidb), _ = quiet(lambda: _loop_data(cfg))
    nondeterministic = set()

    def run(out, record, max_iters, profile_steps=None, calls=None):
        with loop_probe(record, profile_steps), nms_route(log=calls), \
                warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            state, lines = quiet(lambda: train_net(
                "res101", imdb, roidb, valroidb, os.path.join(tmp, out),
                os.path.join(tmp, out + "_tb"), pretrained_model=weights,
                max_iters=max_iters, valimdb=valimdb, device=dev))
        torch.cuda.synchronize()
        nondeterministic.update(str(w.message).split(".")[0] for w in caught
                                if "deterministic" in str(w.message))
        return state, lines

    def loop_ms(record, first, last):
        """Host ms a step over steps first..last, the snapshots written
        between them left out."""
        ends = record["ends"]
        snaps = sum(s for n, s, _ in record["snapshots"]
                    if first - 1 <= n < last)
        return (ends[last - 1] - ends[first - 2] - snaps) / (
            last - first + 1) * 1e3

    # the run a user makes: default algorithms, TPU.PREFETCH at its default
    steps = LOOP_STEPS
    rec, calls = {}, []
    K.reset_launch_counts()
    state, lines = run("unbroken", rec, steps * BATCH,
                       profile_steps=PROFILE_STEPS, calls=calls)
    launches = K.launch_counts()
    out_dir = os.path.join(tmp, "unbroken")
    tb_dir = out_dir + "_tb"
    per_step = [(n, hw, c["nms_keep_mask_batched"], c["batched_nms_keep"])
                for n, hw, c in rec["steps"]]
    print(f"train loop: res101 float32 B={BATCH} at {EVAL_CFG_FILE}, "
          f"{len(roidb)} trainval entries (flipped included), {steps} steps, "
          f"default algorithms, TPU.PREFETCH {cfg.TPU.PREFETCH}; launches "
          f"{launches}; per step (step, canvas, K1, K2): {per_step}"
          f"; summaries at {[n for n, _, _ in rec['summaries']]}")
    for line in lines:
        if line.startswith(("Loaded pretrained", "iter:", "iter ",
                            "Wrote snapshot", "Batched recipe")):
            print("  " + line)

    # the import: every backbone tensor equal to phase 4's
    off = [k for k, v in rec["loaded"].items()
           if not torch.equal(v.cpu(), reference[k])]
    print(f"  --weight: {len(rec['loaded'])} backbone tensors, equal to "
          f"phase 4's seeded weights: {not off}")
    if off or len(rec["loaded"]) != sum(
            k.startswith(("head.", "tail.")) for k in reference):
        raise AssertionError(f"imported backbone differs: {off[:3]}")

    # K1 once a step at the train shape (N = 12000, max_keep 2000 at the
    # YAML's settings), K2 only in the eval
    n_val = len(rec["summaries"])
    pre, post = (int(cfg.TRAIN.RPN_PRE_NMS_TOP_N),
                 int(cfg.TRAIN.RPN_POST_NMS_TOP_N))
    train_k1 = [(a, k) for nm, a, k in calls if nm == "nms_keep_mask_batched"
                and k.get("max_keep") == post]
    eval_k1 = [(a, k) for nm, a, k in calls if nm == "nms_keep_mask_batched"
               and k.get("max_keep") != post]
    eval_k2 = [(a, k) for nm, a, k in calls if nm == "batched_nms_keep"]
    shapes_ok = all(tuple(a[0].shape) == (BATCH, pre, 4) for a, _ in train_k1)
    want = {"nms_keep_mask_batched": steps + n_val + len(eval_k1),
            "batched_nms_keep": len(eval_k2)}
    print(f"  K1 at the train shape [{BATCH}, {pre}] -> {post}: "
          f"{len(train_k1)} calls ({steps} steps, {n_val} val summary), all "
          f"at that shape {shapes_ok}; in the eval K1 {len(eval_k1)}, K2 "
          f"{len(eval_k2)} calls")
    if ([c[2:] for c in per_step] != [(1, 0)] * steps or not shapes_ok
            or len(train_k1) != steps + n_val or not eval_k2
            or len(eval_k1) != len(eval_k2) or launches != want):
        raise AssertionError(f"loop launches {launches} (want {want}), per "
                             f"step {per_step}")
    for label, (args, kwargs) in (("step 1", train_k1[0]),
                                  ("val summary", train_k1[1]),
                                  (f"step {steps}", train_k1[-1])):
        check_equal(errors, "nms_keep_mask_batched",
                    K.nms_keep_mask_batched(*args, **kwargs),
                    K.nms_keep_mask_plain(*args, **kwargs),
                    f"train loop {label} {tuple(args[0].shape)} {kwargs}")
    for name, (args, kwargs) in (("nms_keep_mask_batched", eval_k1[0]),
                                 ("batched_nms_keep", eval_k2[0])):
        kernel, plain = kernel_pairs()[name]
        check_equal(errors, name, kernel(*args, **kwargs),
                    plain(*args, **kwargs),
                    f"train loop eval {tuple(args[0].shape)} {kwargs}")

    # losses, the freeze, snapshots, summaries, the eval
    rows = [json.loads(ln) for ln in open(os.path.join(tb_dir,
                                                       "metrics.jsonl"))]
    losses = [r for r in rows if r["prefix"] in ("train", "val")]
    finite = all(np.isfinite(v) for r in losses for k, v in r.items()
                 if k not in ("prefix",))
    model = state.model
    params = dict(model.named_parameters())
    frozen = [n for n, p in params.items() if not p.requires_grad]
    stem_block1 = [n for n in frozen if n.startswith(("head.conv1",
                                                      "head.block1"))]
    changed = [n for n in frozen if not torch.equal(params[n],
                                                    rec["loaded"][n])]
    later = [n for n, p in params.items() if p.requires_grad]
    still = [n for n in later if n.startswith(("head.", "tail."))
             and torch.equal(params[n], rec["loaded"][n])]
    kept = sorted(f for f in os.listdir(out_dir)
                  if "_iter_" in f and f.endswith(".pt"))
    written = [n for n, _, _ in rec["snapshots"]]
    maps = [r["val_mAP"] for r in rows if "val_mAP" in r]
    events = [os.path.isdir(d) and any(f.startswith("events.out.tfevents.")
                                       for f in os.listdir(d))
              for d in (tb_dir, tb_dir + "_val")]
    best = os.path.join(out_dir, f"{LOOP_PREFIX}_best.pt")
    print(f"  losses finite in {len(losses)} summaries: {finite}; frozen "
          f"{len(frozen)} tensors (stem and block1 {len(stem_block1)}) "
          f"bitwise equal to the import: {not changed}; {len(later)} "
          f"trainable moved: {not still}; snapshots written at {written}, "
          f"kept {kept} (SNAPSHOT_KEPT {cfg.TRAIN.SNAPSHOT_KEPT}); event dirs "
          f"{events}; mAP {maps} at step {[n for n, _, _ in rec['evals']]}; "
          f"{os.path.basename(best)} {os.path.exists(best)}")
    if (not finite or changed or still or not stem_block1
            or written != [4, 8, steps]
            or kept != [f"{LOOP_PREFIX}_iter_{n}.pt" for n in (steps, 8)]
            or not all(events) or len(maps) != 1 or not 0 <= maps[0] <= 1
            or not os.path.exists(best)):
        raise AssertionError("train loop: losses, freeze, snapshots, events, "
                             "mAP or best params")

    # times of the user's run: steps 3-8 timed, PROFILE_STEPS traced
    default_ms = loop_ms(rec, 3, 8)
    canvases = sorted({hw for n, hw, _ in rec["steps"] if n > 2})
    eval_s = rec["evals"][0][1]
    busy, window, idle = device_idle(rec["profiler"])
    step_fn, st, batch = rec["last"]
    bare = host_ms(lambda: step_fn(st, batch), iters=3)
    print(f"time train loop: {default_ms:.3f} ms per step = "
          f"{BATCH * 1000.0 / default_ms:.2f} images/s (steps 3-8, host "
          f"clock to a synchronize, the step-4 snapshot left out; default "
          f"algorithms, TPU.PREFETCH {cfg.TPU.PREFETCH}, canvases "
          f"{canvases}); the bare step on the loop's last batch "
          f"{tuple(batch['image'].shape[1:3])}: {bare:.3f} ms, so the loop "
          f"adds {default_ms - bare:.3f} ms a step; phase 6's bare step "
          f"{bare_step_ms:.3f} ms (608x1024) [{card}]")
    print(f"time train loop device: busy {busy:.3f} ms of a {window:.3f} ms "
          f"window over steps {PROFILE_STEPS[0]}-{PROFILE_STEPS[1]}, idle "
          f"share {idle:.4f} (default algorithms, the prefetcher on, "
          f"torch.profiler on) [{card}]")
    print(f"time train loop snapshot: "
          + ", ".join(f"step {n}: {s * 1e3:.1f} ms" for n, s, _ in
                      rec["snapshots"])
          + f"; eval of {valimdb.num_images} images at step "
          f"{rec['evals'][0][0]}: {eval_s:.3f} s = "
          f"{valimdb.num_images / eval_s:.2f} images/s (the TEST model's "
          f"build included), mAP {rec['evals'][0][2]:.6f} [{card}]")
    rows_out = {"train loop": {"nms_keep_mask_batched": kernel_row(
        card, "train loop", "nms_keep_mask_batched", *train_k1[-1],
        steps + n_val)},
        "train loop eval": {
            name: kernel_row(card, "train loop eval", name, *inputs[0],
                             len(inputs))
            for name, inputs in (("nms_keep_mask_batched", eval_k1),
                                 ("batched_nms_keep", eval_k2))}}
    del state, model, params, rec, calls, train_k1, eval_k1, eval_k2
    del step_fn, st, batch
    torch.cuda.empty_cache()

    # the deterministic pair: the crop's backward scatters with atomic adds,
    # whose order changes each run, and with random weights a change in the
    # last bit of a sum flips a proposal or a sampled RoI within a few steps
    # (with deterministic cuDNN alone a resume diverged to 1.4e-2). The
    # prefetcher's resume replays the batch in flight (its get_state
    # contract), so the pair runs without it, and without the eval
    torch.use_deterministic_algorithms(True, warn_only=True)
    cfg.TPU.PREFETCH = 0
    cfg.TPU.EVAL_ITERS = 0
    pair = -(-LOOP_ITERS // BATCH)
    rec = {}
    state, _ = run("pair", rec, LOOP_ITERS)
    pair_dir = os.path.join(tmp, "pair")
    det_ms = loop_ms(rec, 3, pair)
    final = {k: v.cpu() for k, v in state.state_dict()["params"].items()}
    final_trace = {k: v.cpu() for k, v in state.trace.items()}
    final_gen = state.generator.get_state()
    del state, rec
    torch.cuda.empty_cache()
    resumed = os.path.join(tmp, "resumed")
    os.makedirs(resumed)
    for ext in ("pt", "pkl"):
        shutil.copy(os.path.join(pair_dir, f"{LOOP_PREFIX}_iter_"
                                           f"{pair // 2}.{ext}"), resumed)
    rec = {}
    state, lines = run("resumed", rec, LOOP_ITERS)
    restored = [ln for ln in lines if ln.startswith("Restored from iter")]
    err = max(float((state.model.state_dict()[k].cpu() - v).abs().max())
              / max(float(v.abs().max()), 1e-30) for k, v in final.items())
    trace_err = max(float((state.trace[k].cpu() - v).abs().max())
                    / max(float(v.abs().max()), 1e-30)
                    for k, v in final_trace.items())
    metas = [ckpt.restore_meta(os.path.join(d, f"{LOOP_PREFIX}_iter_"
                                               f"{pair}.pkl"))
             for d in (pair_dir, resumed)]
    a, b = (m["data_state"]["train"] for m in metas)
    cursors = (int(a["cur"]) == int(b["cur"])
               and np.array_equal(a["perm"], b["perm"])
               and all(np.array_equal(x, y) for x, y in zip(a["rng_state"],
                                                            b["rng_state"])))
    same_gen = torch.equal(state.generator.get_state(), final_gen)
    print(f"  deterministic pair (torch.use_deterministic_algorithms, "
          f"TPU.PREFETCH 0, no eval): ops without a deterministic "
          f"implementation on the loop's path: "
          f"{sorted(nondeterministic) or 'none'}")
    print(f"  resumed run: {restored}, steps "
          f"{[n for n, _, _ in rec['steps']]}; parameters max rel "
          f"{err:.3g}, momentum max rel {trace_err:.3g} "
          f"(tol {RESUME_TOL:g}); step {int(state.step)}, count "
          f"{int(state.count)}; generator equal {same_gen}; data cursors "
          f"equal {cursors}")
    if (restored != [f"Restored from iter {pair // 2}"] or err > RESUME_TOL
            or trace_err > RESUME_TOL or int(state.step) != pair
            or not same_gen or not cursors):
        raise AssertionError("the resumed run differs from the unbroken one")
    step_fn, st, batch = rec["last"]
    det_bare = host_ms(lambda: step_fn(st, batch), iters=3)
    torch.use_deterministic_algorithms(False)
    print(f"time train loop deterministic: {det_ms:.3f} ms per step = "
          f"{BATCH * 1000.0 / det_ms:.2f} images/s (the pair's unbroken run, "
          f"steps 3-{pair}, TPU.PREFETCH 0); the bare step on the resumed "
          f"run's last batch {tuple(batch['image'].shape[1:3])}: "
          f"{det_bare:.3f} ms, so the loop adds {det_ms - det_bare:.3f} ms "
          f"a step [{card}]")
    del state, st, step_fn, batch, rec
    torch.cuda.empty_cache()

    layer = RoIDataLayer(roidb, batch_size=BATCH, device=dev)
    decode = host_ms(layer.next_host_batch, iters=3)
    host = layer.next_host_batch()
    prep = host_ms(lambda: layer.to_device(host), iters=3)
    print(f"time train data layer: decode {decode:.3f} ms a batch of "
          f"{BATCH} (host), prep on the card {prep:.3f} ms (host clock to a "
          f"synchronize), canvas {host.canvas} [{card}]")
    return rows_out


def loop_cli(root, tmp, weights, settings):
    """tools.trainval_net in a subprocess: exit 0, a snapshot and both event
    dirs."""
    env = dict(CALLER_ENV, PYTHONPATH=root)
    t = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "tf_faster_rcnn_torch.tools.trainval_net",
         "--net", "res101", "--cfg", EVAL_CFG_FILE, "--weight", weights,
         "--imdb", "voc_2007_trainval", "--imdbval", "voc_2007_test",
         "--iters", str(CLI_ITERS), "--set", *settings],
        cwd=root, env=env, capture_output=True, text=True, timeout=600)
    seconds = time.perf_counter() - t
    if proc.returncode:
        raise AssertionError(f"trainval_net exited {proc.returncode}:\n"
                             f"{proc.stdout[-2000:]}{proc.stderr[-3000:]}")
    sub = os.path.join("res101", "voc_2007_trainval", "default")
    out_dir = os.path.join(tmp, "output", sub)
    tb_dir = os.path.join(tmp, "tensorboard", sub)
    steps = CLI_ITERS // BATCH
    snap = os.path.join(out_dir, f"{LOOP_PREFIX}_iter_{steps}.pt")
    events = [any(f.startswith("events.out.tfevents.")
                  for f in os.listdir(d))
              for d in (tb_dir, tb_dir + "_val")]
    shown = [ln for ln in proc.stdout.splitlines() if ln.startswith("iter:")]
    print(f"train loop CLI: tools.trainval_net --iters {CLI_ITERS} in "
          f"{seconds:.1f} s (process start, weights and roidb included): "
          f"{shown}; snapshot {os.path.exists(snap)}; event dirs {events}")
    if not os.path.exists(snap) or not all(events):
        raise AssertionError("trainval_net CLI: snapshot or event files")


def op_recorder(log):
    """A dispatch mode that appends (wrapper name, op args) to log for each
    call of K1's and K2's operators: an exported program calls the ops, not
    the Python wrappers that nms_route patches."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    names = {torch.ops.frcnn.nms_keep_mask.default: "nms_keep_mask_batched",
             torch.ops.frcnn.batched_nms_keep.default: "batched_nms_keep"}

    class Recorder(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func in names:
                log.append((names[func], args))
            return func(*args, **(kwargs or {}))
    return Recorder()


def wrapper_call(name, op_args):
    """The (args, kwargs) of a wrapper call equal to an operator call."""
    boxes, valid, thresh, plus_one, suppress_eq = op_args[:5]
    kwargs = dict(plus_one=plus_one, suppress_eq=suppress_eq)
    if name == "nms_keep_mask_batched":
        max_keep = op_args[5]
        kwargs["max_keep"] = None if max_keep > valid.shape[1] else max_keep
    return (boxes, valid, thresh), kwargs


def modules_of(prefixes):
    """The modules of JAX, flax, the JAX package or under prefixes that
    this process has imported."""
    return sorted(m for m in sys.modules if m.split(".")[0] in (
        "jax", "jaxlib", "flax", "tf_faster_rcnn_tpu") or m.startswith(
        prefixes))


def serve_child(bundle, inputs_path, out_path, card):
    """Phase 13's fresh process: load the bundle with no model code, run it
    on the saved canvases with deterministic cuDNN (K1 and K2 once per
    call, each equal to its plain version on the inputs the program gave
    it), save its outputs, time the exported step and the kernels; prints
    one line 'SERVE_CHILD {json}'."""
    import torch
    t = time.perf_counter()
    from tf_faster_rcnn_torch.utils.serving import load_detect
    t_import = time.perf_counter() - t
    t = time.perf_counter()
    manifest, fns = load_detect(bundle)
    t_load = time.perf_counter() - t
    loaded = modules_of(SERVE_FORBIDDEN)
    if loaded:
        raise AssertionError(f"loading the bundle imported {loaded}")
    from tf_faster_rcnn_torch.ops import nms_kernels as K
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    inputs = torch.load(inputs_path)
    errors = {name: 0 for name in kernel_pairs()}
    outputs, calls, per_call = {}, [], []
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    for key, args in inputs.items():
        args = tuple(a.cuda() for a in args)
        K.reset_launch_counts()
        with op_recorder(calls):
            out = fns[tuple(key)](*args)
        torch.cuda.synchronize()
        per_call.append(K.launch_counts())
        outputs[key] = tuple(o.cpu() for o in out)
    torch.backends.cudnn.deterministic = False
    torch.save(outputs, out_path)
    if any(c != {"nms_keep_mask_batched": 1, "batched_nms_keep": 1}
           for c in per_call):
        raise AssertionError(f"exported program launches per call {per_call}")
    for name, op_args in calls:
        kernel, plain = kernel_pairs()[name]
        args, kwargs = wrapper_call(name, op_args)
        check_equal(errors, name, kernel(*args, **kwargs),
                    plain(*args, **kwargs),
                    f"serve path {tuple(args[0].shape)} {kwargs}")
    step_ms = {}
    for key, args in inputs.items():
        args = tuple(a.cuda() for a in args)
        fn = fns[tuple(key)]
        step_ms[f"{key[0]}x{key[1]}"] = timed(lambda: fn(*args))
    rows = {}
    for name in kernel_pairs():
        op_args = next(a for n, a in calls if n == name)
        args, kwargs = wrapper_call(name, op_args)
        rows[name] = kernel_row(card, "serve f32", name, args, kwargs,
                                sum(c[name] for c in per_call))
    loaded = modules_of(SERVE_FORBIDDEN)
    if loaded:
        raise AssertionError(f"running the bundle imported {loaded}")
    print("SERVE_CHILD " + json.dumps({
        "import_s": t_import, "load_s": t_load, "per_call": per_call,
        "n_calls": len(calls), "errors": errors, "step_ms": step_ms,
        "rows": rows, "device": manifest["device"],
        "nms_kernels": manifest["nms_kernels"]}))


def phase_serve(card, dev, errors):
    """Phase 13 (docstring): the res101 bundle exported, reloaded in a fresh
    process and compared with the live step; tools.serve over phase 11's
    images, tools.demo over its own; returns the kernels' rows."""
    import tempfile
    from tf_faster_rcnn_torch.config import (cfg_from_file, cfg_from_list,
                                             reset_cfg)
    t0 = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory(prefix="chip_smoke_serve_") as tmp:
        write_eval_tree(tmp)
        reset_cfg()
        cfg_from_file(os.path.join(root, EVAL_CFG_FILE))
        cfg_from_list(EVAL_SET + ["DATA_DIR", tmp, "ROOT_DIR", tmp])
        try:
            rows = serve_in_process(card, dev, errors, root, tmp)
        finally:
            reset_cfg()
    print(f"phase serve f32: {time.perf_counter() - t0:.1f} s")
    return rows


def serve_batches(paths, buckets, prep):
    """paths grouped by orientation bucket from their headers, in batches
    of BATCH with each bucket's tail repeating its last image, as
    tools.serve runs them: [(bucket, paths, prep(images, bucket))]."""
    from tf_faster_rcnn_torch.data.blob import image_size, read_image_bgr
    groups = {}
    for p in paths:
        h, w = image_size(p)
        groups.setdefault(buckets[0] if w >= h else buckets[1], []).append(p)
    out = []
    for bucket, group in groups.items():
        for i in range(0, len(group), BATCH):
            chunk = group[i:i + BATCH]
            ims = [read_image_bgr(p) for p in chunk]
            ims += ims[-1:] * (BATCH - len(chunk))
            out.append((bucket, chunk, prep(ims, bucket)))
    return out


def serve_in_process(card, dev, errors, root, tmp):
    import torch
    from tf_faster_rcnn_torch.config import canvas_buckets, cfg
    from tf_faster_rcnn_torch.datasets.factory import get_imdb
    from tf_faster_rcnn_torch.engine import test_engine as E
    from tf_faster_rcnn_torch.models.init import init_model
    from tf_faster_rcnn_torch.models.network import FasterRCNN, spec_from_cfg
    from tf_faster_rcnn_torch.utils.checkpoint import save_params
    from tf_faster_rcnn_torch.utils.serving import PARAMS
    spec = spec_from_cfg("res101", NUM_CLASSES, "TEST")
    model = FasterRCNN(spec).eval()
    init_model(model, torch.Generator().manual_seed(SEED))
    buckets = canvas_buckets(cfg.TEST)
    if spec.compute_dtype != "float32" or len(buckets) != 2:
        raise AssertionError(f"serve cfg: {spec.compute_dtype}, {buckets}")

    def run(*args, env=os.environ):
        t = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", *args], cwd=tmp,
                              env=dict(env, PYTHONPATH=root),
                              capture_output=True, text=True, timeout=600)
        if proc.returncode:
            raise AssertionError(f"{args[0]} exited {proc.returncode}:\n"
                                 f"{proc.stdout[-2000:]}{proc.stderr[-3000:]}")
        return proc.stdout.splitlines(), time.perf_counter() - t

    # export through the CLI a user runs, on the saved weights, with its
    # --verify (exported == live at atol 0, default cuDNN); each bucket's
    # trace and write from the files' times (params.pt is written first)
    weights = os.path.join(tmp, EVAL_WEIGHTS)
    save_params(weights, model)
    bundle = os.path.join(tmp, "bundle")
    lines, seconds = run(
        "tf_faster_rcnn_torch.tools.export_model", "--cfg",
        os.path.join(root, EVAL_CFG_FILE), "--net", "res101", "--model",
        weights, "--out", bundle, "--batch", str(BATCH), "--verify", "--set",
        *EVAL_SET, env=CALLER_ENV)
    with open(os.path.join(bundle, "manifest.json")) as f:
        manifest = json.load(f)
    nbytes = {f: os.path.getsize(os.path.join(bundle, f))
              for f in sorted(os.listdir(bundle))}
    files = [PARAMS] + [e["file"] for e in manifest["artifacts"]]
    mtimes = [os.path.getmtime(os.path.join(bundle, f)) for f in files]
    per_bucket = {f"{c[0]}x{c[1]}": round(mtimes[i + 1] - mtimes[i], 3)
                  for i, c in enumerate(buckets)}
    verified = [ln for ln in lines if ln.startswith("verified ")]
    print(f"serve export: tools.export_model --verify, res101 f32 B={BATCH} "
          f"buckets {buckets}, in {seconds:.2f} s (process start, weights "
          f"load, export and verify); per bucket (trace + write) "
          + json.dumps(per_bucket) + f"; bundle {sum(nbytes.values())} "
          f"bytes {nbytes}; device {manifest['device']}, nms_kernels "
          f"{manifest['nms_kernels']}; {verified} [{card}]")
    if [tuple(e["canvas"]) for e in manifest["artifacts"]] != list(buckets) \
            or len(verified) != len(buckets):
        raise AssertionError(f"export_model: {lines[-5:]}")

    # phase 11's first batch of each orientation, live, deterministic cuDNN
    imdb = get_imdb("voc_2007_test")
    paths = [imdb.image_path_at(i) for i in range(imdb.num_images)]
    batches = serve_batches(paths, buckets,
                            lambda ims, bucket: E._prep_batch(ims, bucket,
                                                              dev))
    detect = E.make_detect_fn(model, spec)
    first = {}
    for bucket, _, inputs in batches:
        first.setdefault(bucket, inputs)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    live = {b: tuple(o.cpu() for o in detect(*x)) for b, x in first.items()}
    torch.backends.cudnn.deterministic = False
    inputs_path = os.path.join(tmp, "serve_inputs.pt")
    torch.save({b: tuple(a.cpu() for a in x) for b, x in first.items()},
               inputs_path)
    live_ms = {f"{b[0]}x{b[1]}": timed(lambda: detect(*x))
               for b, x in first.items()}

    # the fresh process
    env = dict(os.environ, PYTHONPATH=root)
    out_path = os.path.join(tmp, "serve_out.pt")
    code = ("import sys; sys.path.insert(0, sys.argv[1]); import chip_smoke; "
            "chip_smoke.serve_child(*sys.argv[2:])")
    t = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", code, root, bundle,
                           inputs_path, out_path, card], cwd=tmp, env=env,
                          capture_output=True, text=True, timeout=900)
    child_s = time.perf_counter() - t
    if proc.returncode:
        raise AssertionError(f"serve child exited {proc.returncode}:\n"
                             f"{proc.stdout[-3000:]}{proc.stderr[-3000:]}")
    for line in proc.stdout.splitlines():
        if not line.startswith("SERVE_CHILD "):
            print(line)
    child = json.loads(next(ln for ln in proc.stdout.splitlines()
                            if ln.startswith("SERVE_CHILD "))[12:])
    for name, err in child["errors"].items():
        errors[name] = max(errors[name], err)
    exported = torch.load(out_path)
    same = {f"{b[0]}x{b[1]}": all(torch.equal(g, w) for g, w in zip(
        exported[b], live[b], strict=True)) for b in live}
    diff = {f"{b[0]}x{b[1]}": float((exported[b][0] - live[b][0]).abs().max())
            for b in live}
    print(f"serve reload in a fresh process ({child_s:.1f} s in all): "
          f"import {child['import_s']:.3f} s, load_detect "
          f"{child['load_s']:.3f} s, no JAX or port models/engine/config "
          f"imported; launches per call {child['per_call']}; exported == "
          f"live (deterministic cuDNN) {same}, max |det diff| {diff}")
    if not all(same.values()):
        raise AssertionError(f"exported and live detections differ: {diff}")
    for key in live_ms:
        print(f"time serve step {key}: exported {child['step_ms'][key]:.3f} "
              f"ms (fresh process), live {live_ms[key]:.3f} ms "
              f"(make_detect_fn), CUDA events, mean of {ITERS} after "
              f"{WARMUP} warm-up (res101 f32, TF32 off, B={BATCH}) [{card}]")

    # tools.serve over the 64 images, against the live step's rows; with
    # this process's cuBLAS workspace, which the live step ran with
    thresh = 0.0
    serve_json = os.path.join(tmp, "serve.json")
    lines, seconds = run("tf_faster_rcnn_torch.tools.serve", "--bundle",
                         bundle, "--thresh", str(thresh), "--json",
                         serve_json, *paths)
    want = {}
    for _, chunk, inputs in batches:
        det, dv = detect(*inputs)
        det, dv = det.cpu(), dv.cpu()
        for j, p in enumerate(chunk):
            want[p] = det[j][dv[j] & (det[j, :, 1] >= thresh)].tolist()
    with open(serve_json) as f:
        got = json.load(f)
    served = [ln for ln in lines if ln.startswith("served ")][-1]
    n_rows = sum(map(len, got.values()))
    print(f"serve CLI: tools.serve in {seconds:.1f} s (process start and "
          f"load included), {len(paths)} images, {n_rows} rows >= {thresh}; "
          f"JSON equal to the live step's rows {got == want}; {served} "
          f"[{card}]")
    if got != want or n_rows == 0:
        raise AssertionError("serve CLI: JSON differs from the live step")

    # tools.demo over its 5 generated images, on seeded weights
    del model, detect
    torch.cuda.empty_cache()
    demo_dir, demo_out = os.path.join(tmp, "demo"), os.path.join(tmp, "out")
    demo_json = os.path.join(tmp, "demo.json")
    lines, seconds = run("tf_faster_rcnn_torch.tools.demo", "--demo-dir",
                         demo_dir, "--out-dir", demo_out, "--json", demo_json,
                         env=CALLER_ENV)
    with open(demo_json) as f:
        dets = json.load(f)
    figures = sorted(os.listdir(demo_out))
    took = [float(ln.split()[2][:-1]) * 1e3 for ln in lines
            if ln.startswith("Detection took")]
    print(f"demo CLI: tools.demo in {seconds:.1f} s (process start, model "
          f"build and image generation included): {len(dets)} images, "
          f"figures {figures}; im_detect ms per image {took} (the first "
          f"warms up), mean of the rest {np.mean(took[1:]):.3f} ms [{card}]")
    if len(dets) != 5 or len(figures) != 5 or len(took) != 5:
        raise AssertionError("demo CLI: figures or JSON missing")
    return child["rows"]


def call_counts(calls):
    """name -> the number of calls of each kernel in an nms_route log."""
    return {name: sum(n == name for n, _, _ in calls)
            for name in kernel_pairs()}


def phase_from_scratch(card, dev, errors):
    """Phase 14 (docstring): reference_init on the card against the CPU
    draw and the init's feature scale; the overfit drill; returns the
    kernels' rows on the drill's paths."""
    t0 = time.perf_counter()
    init_draws(dev)
    rows = overfit_drill(card, errors)
    print(f"phase from scratch: {time.perf_counter() - t0:.1f} s")
    return rows


def init_draws(dev):
    """For each of INIT_NETS at full width: reference_init on the card
    equal, bit for bit, to the same draw on the CPU; the backbone output's
    std on a pixel-scale INIT_HW input inside INIT_STD (the JAX gate,
    tests/test_from_scratch_stability.py)."""
    import torch
    from tf_faster_rcnn_torch.config import cfg
    from tf_faster_rcnn_torch.models.init import reference_init
    from tf_faster_rcnn_torch.models.network import FasterRCNN, ModelSpec
    h, w = INIT_HW
    im = (np.random.RandomState(SEED).rand(1, h, w, 3).astype(np.float32)
          * 255.0 - cfg.PIXEL_MEANS.reshape(1, 1, 1, 3).astype(np.float32))
    x = torch.from_numpy(im).permute(0, 3, 1, 2).to(dev)
    extent = torch.tensor([[h, w]], dtype=torch.float32, device=dev)
    for net in INIT_NETS:
        spec = ModelSpec(net, NUM_CLASSES)
        on_card = FasterRCNN(spec).eval()
        reference_init(on_card, torch.Generator().manual_seed(SEED))
        on_cpu = FasterRCNN(spec, device="cpu")
        reference_init(on_cpu, torch.Generator().manual_seed(SEED))
        want = on_cpu.state_dict()
        got = on_card.state_dict()
        equal = all(torch.equal(t.cpu(), want[k]) for k, t in got.items())
        with torch.no_grad():
            std = float(on_card.head(x, extent).std())
        print(f"reference_init {net}: {len(got)} tensors, "
              f"{sum(t.numel() for t in got.values())} values, the card's "
              f"draw equal to the CPU's bit for bit: {equal}; backbone "
              f"output std {std:.4f} on a pixel-scale {h}x{w} input (gate "
              f"{INIT_STD})")
        if not equal or not INIT_STD[0] < std < INIT_STD[1]:
            raise AssertionError(f"reference_init {net}: draw or scale")
        del on_card, on_cpu, want, got
    torch.cuda.empty_cache()


def overfit_drill(card, errors):
    """tools.overfit_check's main at its defaults (vgg16 from scratch, 1600
    iterations, 6 images, gate 0.99), in process with the NMS calls logged:
    PASS, the launches, and each kernel equal to its plain version on the
    first and the last step's inputs and on every eval call."""
    import tempfile
    import torch
    from tf_faster_rcnn_torch.config import reset_cfg
    from tf_faster_rcnn_torch.engine import train_loop as L
    from tf_faster_rcnn_torch.ops import nms_kernels as K
    from tf_faster_rcnn_torch.tools import overfit_check
    calls, summaries = [], []
    saved = L.SolverWrapper._summary

    def summary(self, *args, **kwargs):   # its val forward runs K1 too
        start = len(calls)
        out = saved(self, *args, **kwargs)
        summaries.append((start, len(calls)))
        return out

    reset_cfg()
    L.SolverWrapper._summary = summary
    try:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_overfit_") as tmp:
            K.reset_launch_counts()
            t = time.perf_counter()
            with nms_route(log=calls):
                record = overfit_check.main(["--workdir", tmp])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
            launches = K.launch_counts()
    finally:
        L.SolverWrapper._summary = saved
        reset_cfg()
    k1 = "nms_keep_mask_batched"
    steps = [(a, k) for i, (n, a, k) in enumerate(calls)
             if n == k1 and k["max_keep"] == OVERFIT_KEEP[0]
             and not any(s <= i < e for s, e in summaries)]
    evals = [(n, a, k) for n, a, k in calls
             if n != k1 or k["max_keep"] == OVERFIT_KEEP[1]]
    print(f"overfit drill: {record['net']} from scratch, {record['iters']} "
          f"iterations (B=1, bf16 compute), APs {record['aps']}, PASS "
          f"{record['ok']} (gate {record['gate']}); {len(steps)} train steps"
          f" through K1 {tuple(steps[0][0][0].shape)} -> "
          f"{steps[0][1]['max_keep']}, {len(summaries)} val summaries, "
          f"{len(evals)} eval calls; launches {launches}")
    if (not record["ok"] or len(steps) != record["iters"]
            or launches != call_counts(calls) or min(launches.values()) == 0):
        raise AssertionError("overfit drill: FAIL, or the kernels did not "
                             "run as the drill's path runs them")
    for label, (name, args, kwargs) in (
            [("first step", (k1,) + steps[0]), ("last step", (k1,) + steps[-1])]
            + [("eval", c) for c in evals]):
        kernel, plain = kernel_pairs()[name]
        check_equal(errors, name, kernel(*args, **kwargs),
                    plain(*args, **kwargs),
                    f"overfit {label} {tuple(args[0].shape)} {kwargs}")
    print(f"time overfit drill: {record['iters']} steps in "
          f"{record['train_s']:.1f} s = "
          f"{record['iters'] / record['train_s']:.2f} steps/s (train_net, "
          f"its summaries included); eval {record['eval_s']:.1f} s; "
          f"{wall:.1f} s from the drill's start to the gate [{card}]")
    first_eval = {n: (a, k) for n, a, k in reversed(evals)}
    in_eval = call_counts(evals)
    return {"overfit train": {k1: kernel_row(
                card, "overfit train", k1, *steps[-1],
                launches[k1] - in_eval[k1])},
            "overfit eval": {name: kernel_row(
                card, "overfit eval", name, *first_eval[name], in_eval[name])
                for name in kernel_pairs()}}


def phase_rehearsal(card, dev, errors):
    """Phase 15 (docstring): tools.coco_rehearsal in a subprocess at its
    defaults, then its snapshot through test_net in process under the lg
    cfg; returns the kernels' rows on that eval's path."""
    import tempfile
    import torch
    from tf_faster_rcnn_torch.config import (cfg_from_file, cfg_from_list,
                                             reset_cfg)
    from tf_faster_rcnn_torch.datasets.factory import get_imdb
    from tf_faster_rcnn_torch.engine.test_engine import test_net
    from tf_faster_rcnn_torch.models.network import FasterRCNN, spec_from_cfg
    from tf_faster_rcnn_torch.ops import nms_kernels as K
    from tf_faster_rcnn_torch.tools.recipes import recipe
    from tf_faster_rcnn_torch.tools.test_faster_rcnn import newest_snapshot
    from tf_faster_rcnn_torch.tools.test_net import load_model_params
    t0 = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_rehearsal_") as tmp:
        wd = os.path.join(tmp, "wd")
        log = os.path.join(tmp, "rehearsal.log")
        with open(log, "w") as f:
            proc = subprocess.run(
                [sys.executable, "-m",
                 "tf_faster_rcnn_torch.tools.coco_rehearsal",
                 "--workdir", wd], cwd=root, env=CALLER_ENV, stdout=f,
                stderr=subprocess.STDOUT)
        with open(log) as f:
            lines = f.read().splitlines()
        for ln in lines:
            if ln.startswith("[rehearsal]") or ln.startswith("speed:"):
                print("  " + ln)
        if proc.returncode:
            print("\n".join(lines[-80:]))
            raise AssertionError(f"coco_rehearsal exited {proc.returncode}")
        with open(os.path.join(wd, "rehearsal.json")) as f:
            rec = json.load(f)
        print(f"time rehearsal: res101 from scratch, {rec['steps']} steps "
              f"(B=8, f32) at {rec['train_ms_per_step']} ms a step (the "
              f"loop's mean); AP@[0.5:0.95] res101.yml {rec['ap_600']:.4f}, "
              f"res101-lg.yml {rec['ap_lg']:.4f} (gate {rec['gate']}); the "
              f"train driver {rec['train_driver_s']:.1f} s (its chained eval "
              f"included), the lg test driver {rec['lg_driver_s']:.1f} s "
              f"[{card}]")
        if not rec["ok"] or min(rec["ap_600"], rec["ap_lg"]) < rec["gate"]:
            raise AssertionError("coco_rehearsal: below its gate")

        r = recipe("coco")
        reset_cfg()
        cfg_from_file(os.path.join(root, REHEARSAL_LG_CFG))
        cfg_from_list(["ANCHOR_SCALES", r.scales, "ANCHOR_RATIOS", r.ratios,
                       "DATA_DIR", wd, "ROOT_DIR", wd,
                       "TPU.IMS_PER_DEVICE", str(BATCH)])
        calls = []
        try:
            snap = newest_snapshot(os.path.join(
                wd, "output", "res101", r.train_imdb, "rehearsal"), "res101")
            imdb = get_imdb(r.test_imdb)
            spec = spec_from_cfg("res101", imdb.num_classes, "TEST")
            pre, post = spec.rpn_pre_nms_top_n, spec.rpn_post_nms_top_n
            model = FasterRCNN(spec).eval()
            load_model_params(model, snap, "res101")
            K.reset_launch_counts()
            with nms_route(log=calls):
                ap, _ = quiet(lambda: test_net(
                    model, spec, imdb, "chip_smoke",
                    output_dir=os.path.join(tmp, "lg")))
            torch.cuda.synchronize()
            launches = K.launch_counts()
        finally:
            reset_cfg()
    shapes = {(n, tuple(a[0].shape), k.get("max_keep")) for n, a, k in calls}
    print(f"rehearsal lg eval in process: {os.path.basename(snap)}, "
          f"{imdb.num_images} minival images, AP@[0.5:0.95] {ap:.4f} (the "
          f"driver's {rec['ap_lg']:.4f}); launches {launches}; calls "
          f"{sorted(shapes, key=str)}")
    want = {("nms_keep_mask_batched", (BATCH, pre, 4), post),
            ("batched_nms_keep", (BATCH * (imdb.num_classes - 1), post, 4),
             None)}
    if (not want <= shapes or launches != call_counts(calls)
            or not 0.0 <= ap <= 1.0):
        raise AssertionError("rehearsal lg eval: shapes, launches or AP")
    for name, args, kwargs in calls:
        kernel, plain = kernel_pairs()[name]
        check_equal(errors, name, kernel(*args, **kwargs),
                    plain(*args, **kwargs),
                    f"rehearsal lg eval {tuple(args[0].shape)} {kwargs}")
    rows = {}
    for name in kernel_pairs():
        args, kwargs = next((a, k) for n, a, k in calls if n == name)
        rows[name] = kernel_row(card, "rehearsal lg eval", name, args,
                                kwargs, launches[name])
    print(f"phase rehearsal: {time.perf_counter() - t0:.1f} s")
    return {"rehearsal lg eval": rows}


def main():
    root = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(root, "tf_faster_rcnn_torch")):
        raise SystemExit("chip_smoke.py: tf_faster_rcnn_torch/ is not beside "
                         "this script; run it from a checkout of the repo")
    sys.path.insert(0, root)
    # torch's deterministic algorithms (phase 12's resume pair) need a fixed
    # cuBLAS workspace, whose size cuBLAS reads at its first use: set before
    # any CUDA work, so that every phase runs with the same workspace
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch

    start = time.perf_counter()
    card = phase_device()
    dev = torch.device("cuda", 0)
    phase_build()
    errors = phase_kernels(dev)
    print(f"phases 1-3: {time.perf_counter() - start:.1f} s")
    spec, model, detect, inputs = build_main_path(dev)
    launches, captured, f32_det = phase_main_path(spec, model, detect, inputs,
                                                  errors)
    times = phase_times(card, model, detect, inputs, captured)
    print(f"phases 1-5: {time.perf_counter() - start:.1f} s")
    del model, detect, inputs, captured
    spec, state, step, batch = build_train_path(dev)
    _, train_k1 = phase_train_path(card, spec, state, step, batch, errors)
    train_row, train_ms = phase_train_times(card, state, step, batch,
                                            train_k1)
    paths = {"train f32": {"nms_keep_mask_batched": train_row}}
    print(f"phases 1-6: {time.perf_counter() - start:.1f} s")
    del state, step, batch
    torch.cuda.empty_cache()

    spec_main = build_spec()
    paths["detect bf16"] = phase_detect_path(
        card, dev, "detect bf16", replace(spec_main, compute_dtype="bfloat16"),
        errors, reference=f32_det)
    paths["train bf16"] = {"nms_keep_mask_batched": phase_train_variant(
        card, dev, "train bf16", errors, extra_cfg=BF16, steps=TRAIN_STEPS,
        compare=True, iters=ITERS)}
    for backbone in ("vgg16", "mobile"):
        spec = replace(spec_main, backbone=backbone)
        paths[f"detect {backbone}"] = phase_detect_path(
            card, dev, f"detect {backbone}", spec, errors)
        paths[f"train {backbone}"] = {
            "nms_keep_mask_batched": phase_train_variant(
                card, dev, f"train {backbone}", errors, backbone)}
    paths["detect top"] = phase_detect_path(
        card, dev, "detect top", replace(spec_main, test_mode="top"), errors,
        batch=TOP_BATCH)
    paths["eval f32"] = phase_eval(card, dev, errors)
    paths.update(phase_train_loop(card, dev, errors, train_ms))
    paths["serve f32"] = phase_serve(card, dev, errors)
    paths.update(phase_from_scratch(card, dev, errors))
    paths.update(phase_rehearsal(card, dev, errors))
    print(f"phases 1-15: {time.perf_counter() - start:.1f} s")

    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": SOURCE,
         "replaces": REPLACES[name], "launches": launches[name],
         "max_abs_err": errors[name], "ms": times[name][0],
         "plain_ms": times[name][1], "bound_ms": times[name][2],
         "bound_by": times[name][3], "library_ms": None,
         "paths": {path: rows[name] for path, rows in paths.items()
                   if name in rows}}
        for name in ("nms_keep_mask_batched", "batched_nms_keep")]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
