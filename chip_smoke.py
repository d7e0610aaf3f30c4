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
3b. epilogue (K3, frcnn::conv_epilogue, csrc/epilogue.cu): the kernel
   against its plain composition (ops/epilogue.py), y and every gradient
   (x, the residual, a bias) bit for bit: each mode (FrozenBN folded in the
   kernel, prefolded bf16 buffers, a bias, the mask alone; with or without
   a dense or a stride-2 residual, ReLU and mask) in bf16, float32 and
   float64 at [3, 64, 19, 27], and two float64 cases in NCHW (cuDNN's
   float64 layout, which conv_epilogue copies to channels-last); then the
   cells' largest epilogues (res101's
   stem [8, 64, 304, 512], block1's conv3 with its residual [8, 256, 152,
   256] and its stride-2 shortcut at [8, 256, 76, 128], the tail's conv3
   [2400, 2048, 7, 7], vgg16's conv1_1 [8, 64, 608, 1024] with its bias and
   mask; the stem in float32 too), each direction timed (CUDA events)
   beside its byte bound at 3.35e12 B/s and the plain forward; then
   res101's and vgg16's heads in bf16 on the 608x1024 canvas with
   per-image extents, and res101's tail on 2,400 crops, against the
   modules' former composition (each conv with its bias, FrozenBN, ReLU,
   residual add and mask as PyTorch ops) under deterministic cuDNN: the
   output and the heads' parameter gradients bit for bit, and one
   epilogue launch a fused epilogue (96 in res101's head, 17 in vgg16's,
   10 in the tail);
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
   time (mean of ITERS = 5 by CUDA events after warm-up), images/s, peak
   memory,
   and K1's graph-replay time, plain time and bound on the step's inputs;
7. bf16 detect: phase 4's step at TPU.COMPUTE_DTYPE bfloat16 (the bench's
   configuration, bench.py and tools/bench_train.py) on the same weights:
   both kernels launched (and, in phases 7, 9 and 10, the conv epilogue
   once a fused epilogue: epilogues_a_step), each equal to its plain
   version on this path's
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
10b. R-101-FPN: one detect step of the benchmark's r101-fpn-coco-detect-b8
   cell as it runs it (its configuration file applied to the port's cfg,
   its seeded weights, its first batch of 8 images on the 800x1344
   canvas, bf16), the counters zeroed just before the step (the second
   on the canvas, which captures the trunk's CUDA graph and so runs every
   call of the trunk once, as an eager step does): K1 once at
   [40, 1000] (8 images x 5 levels, 1000 candidates each) with max_keep
   1000, K2 once at [640, 1000], the conv epilogue 118 times
   (epilogues_a_step), fpn.nms_instances 40; K1 and K2 each equal to its
   plain version on the step's own inputs, and K3 bit for bit against its
   plain composition on the step's own operands of every lateral (bias,
   the nearest-x2 coarser level as its residual, mask) and of rpn_conv on
   each of P2-P6 (bias, ReLU, mask); the step's host syncs under torch's
   sync debug mode no more than the three of the single-map step (F1);
   the trunk replayed from its graph bit for bit equal to the trunk run
   eagerly, and the replayed step's detections to an eager step's;
   step time and peak memory; K1's and K2's rows (graph replay, plain,
   bound) and K3's forward at the P2 lateral and rpn_conv (CUDA events,
   byte bound, plain), printed as a kernel line of their own and added to
   the last one;
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
   events, mean of 5 after warm-up), serve images/s from the first decode
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
   a subprocess at its defaults but --iters REHEARSAL_ITERS (res101 from
   scratch on a synthetic 80-class COCO, 3000 images = 375 steps at B =
   8, f32, against the tool's 4000, to keep the smoke inside its limit;
   through the
   drivers tools.train_faster_rcnn and tools.test_faster_rcnn), with the
   caller's environment and a working dir of this run's: exit 0, and
   AP@[0.5:0.95] >= 0.05 under both res101.yml and res101-lg.yml. Then its
   snapshot through test_net in process on the minival under
   res101-lg.yml: K1 at [8, 6000] -> 1000 and K2 at [640, 1000] once a
   batch, each equal to its plain version on every call. Times: ms a
   step (the loop's own mean), the drivers' wall times, the kernels on the
   lg eval path;
16. data parallel (parallel/, the 'data' axis): (a) phase 6's train step
   (its builder, a fresh seeded state, its batch, one noise draw) through
   make_train_step(mesh=) over an NCCL group of one rank (a TCP store on
   localhost), against the plain step under torch's deterministic
   algorithms: the losses and every parameter within 1e-6 relative; both
   steps' times, whose difference is the reduce through NCCL. (b) two
   processes (dp_worker) sharing cuda:0 over gloo (NCCL refuses two ranks
   on one device), the global batch of 8 split 4 + 4, each rank on its
   rows of the same global noise: one step against (a)'s plain step under
   deterministic algorithms, the losses within 1e-5 relative, the momentum
   after the step (the gradients) within 1e-4 of its largest and equal on
   both ranks, the sampled RoI and anchor labels equal (a flip is counted
   and fails); K1 once a rank a step at [4, 12000] -> 2000, equal to its
   plain version on each rank's inputs; two more steps timed, with the
   gradient reduce timed apart, and the train loop's host agreements on
   the gloo host group (the preemption flags' all_gather, a barrier) timed
   alone. (c) in the same processes, test_net over
   phase 11's tree striped over the two ranks: at phase 11's
   IMS_PER_DEVICE 8 the merged detections.pkl equal to phase 11's and the
   same mAP; at IMS_PER_DEVICE 4 equal to one process's at 4 (run here),
   the same mAP, the difference from phase 11's (another batch, other
   cuDNN algorithms) printed; every image detected, the mAP on rank 0
   only, K1 and K2 equal to their plain versions on each rank's calls;
   images/s of the two ranks together, and each rank's seconds in host
   agreements (the run token's broadcast, the barriers). The ranks import no module of JAX
   or the JAX package. (d) tools.trainval_net --devices (one more than the
   GPUs) exits nonzero naming the GPU count;
17. model axis (parallel/mesh.py's ('data', 'model') mesh,
   parallel/tensor_parallel.py, parallel/spatial.py), in phase 16's two
   processes laid out as a 1 x 2 mesh (make_hybrid_mesh), both ranks on
   every image of B = 8, each on half the 608 canvas rows: (a) res101
   train, the RoI head tensor parallel (block4's conv1 by output and conv2
   by input channels) and the head spatially partitioned, with 16a's
   noise, against phase 6's plain step from the same seeded state, both
   computing in float64 under deterministic algorithms (in float32 the
   random-weight step is discontinuous within an ulp, and the split
   canvas's convolutions and the split layers' sums round otherwise):
   the losses within 1e-5 relative and equal on both ranks, the
   layout-free momentum within 1e-4 of its largest, the anchor and RoI
   labels equal; (b) the same for vgg16 (the Megatron fc6/fc7 pair + SP)
   against phase 9's step with its own noise and dropout masks, drawn
   here; (c)
   test_net over phase 11's tree at TPU.MODEL_DEVICES 2 (both ranks run
   every batch): every image detected, at least 0.99 of phase 11's
   detections matched at IoU 0.9 (matched_share), the mAP on rank 0 only
   and its difference from phase 11's printed; (d) the res101 snapshot
   written at 1 x 2 (gathered over 'model', by rank 0 alone) restored in
   this process equals the gathered state bit for bit, and each rank's
   slices are its part of it. K1 (and K2 in (c)) once per step or batch
   on each rank, equal to their plain versions on each rank's calls.
   Times, in float32: each rank's step ms, its peak memory, and one step
   more with each collective synchronized: the halo exchanges, the
   feature gather, the TP reduces and the gradient reduces, each in ms
   and as a share;
18. NMS API: class_aware_nms ([20, 300] -> 100) and multiclass_nms
   ([20, 300]) on image 0's per-class boxes of phase 4's detect step
   (engine/detect.py::class_boxes): one K1 launch each, each output equal
   to the same call through the plain versions, K1 equal to its plain
   version on its inputs, and a row on the kernel line;
19. the measurement tools (tf_faster_rcnn_torch/tools/bench.py,
   bench_train.py, bench_sweep.py), in process at the full bench workload
   with fewer iterations (TOOL_*): bench.measure, which runs its detect step
   (res101 bf16, B = 8, 6000 -> 300) and then bench_train.measure's train
   step (6000 -> 2000), with K1 and K2 launched exactly once for each step
   the tools ran (K1 at max_keep 300 on each detect step and 2000 on each
   train step, K2 on each detect step), the keys of the JAX bench.py's
   line, and the bench's first detections finite, [8, 100, 6], and equal
   bit for bit to make_detect_fn's on the same model and inputs;
   bench_sweep.measure at B = 32 (K2 at [640, 300]), once a step; and
   bench_sweep.py --batches 8 in a subprocess, its last line with the JAX
   sweep's keys. K1 on the bench's train inputs and K2 on the sweep's,
   each equal to its plain version, are two rows of the kernel line.

Each phase from 7 on prints its wall time. The kernel line gives, beside
each kernel's main-path fields (phase 4), its launches, graph-replay time,
plain time and bound on each other path's own inputs ("paths"; for the
two-rank paths of phases 16 and 17, rank 0's inputs and launches, with
each rank's launches in "rank_launches").

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
ITERS = 5
SOURCE = "tf_faster_rcnn_torch/csrc/nms.cu"
FPN_CELL = "r101-fpn-coco-detect-b8"
FPN_SEED = 4177000013     # the weights and images of phase 10b's step
DETECT_SYNCS = 3          # the single-map detect step's host syncs (F1)
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
# phase 15: the rehearsal's second eval config, and its images (375 steps
# at B = 8 where the tool's default is 500: the smoke's time limit)
REHEARSAL_ITERS = 3000
REHEARSAL_LG_CFG = "experiments/cfgs/res101-lg.yml"
DP_RANKS = 2
DP_LOSSES = ("rpn_cross_entropy", "rpn_loss_box", "cross_entropy", "loss_box",
             "total_loss")
DP_NCCL_TOL = 1e-6
DP_LOSS_TOL = 1e-5
DP_GRAD_TOL = 1e-4
DP_ITERS = 5
DP_STEPS = 2
DP_EVAL_BATCH = 4
DP_TIMEOUT_S = 600
# phase 17: the model axis, a 1 x 2 mesh of the two ranks of phase 16
MA_BACKBONES = ("res101", "vgg16")
MA_STEPS = 2
MA_SHARE = 0.99
MA_PREFIX = "ma"
# phase 19: the measurement tools at the bench workload, with fewer
# iterations than theirs (detect 3 + 20 x 4, train 2 + 10 x 3), the sweep's
# largest batch (K2 at [32 x 20, 300]) and one CLI run of the sweep
TOOL_WARMUP, TOOL_ITERS, TOOL_WINDOWS, TOOL_TRAIN_ITERS = 1, 2, 2, 2
SWEEP_BATCH = 32
SWEEP_CLI = ["--batches", str(BATCH), "--iters", "2"]
SWEEP_KEYS = {"net", "batch", "s2d", "cfg", "images_per_sec"}
BENCH_KEYS = {"metric", "value", "unit", "vs_baseline",
              "train_images_per_sec", "train_ms_per_step"}
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


# K3, the conv epilogue (ops/epilogue.py): the cells' largest epilogues, each
# (label, shape, dtype, mode); mode: "bn" | "bias" | "mask", "+res" a dense
# residual, "+sres" one strided by 2 (a stride-2 identity shortcut),
# "+relu", "+mask"
EPILOGUE_CASES = (
    ("res101 stem", (8, 64, 304, 512), "bfloat16", "bn+relu+mask"),
    ("res101 block1 conv3", (8, 256, 152, 256), "bfloat16", "bn+res+relu"),
    ("res101 block1 unit_3 conv3", (8, 256, 76, 128), "bfloat16",
     "bn+sres+relu"),
    ("res101 tail conv3", (2400, 2048, 7, 7), "bfloat16", "bn+res+relu"),
    ("vgg16 conv1_1", (8, 64, 608, 1024), "bfloat16", "bias+relu+mask"),
    ("res101 stem f32", (8, 64, 304, 512), "float32", "bn+relu+mask"),
)
# every mode at a small shape, in each dtype the kernel takes
EPILOGUE_SMALL = (3, 64, 19, 27)
EPILOGUE_MODES = tuple(
    f"{affine}{res}{relu}{mask}"
    for affine in ("bn", "prefold", "bias", "mask")
    for res in ("", "+res", "+sres") for relu in ("", "+relu")
    for mask in ("", "+mask")
    if not (affine == "mask" and (res or relu or not mask)))
EPILOGUE_ITERS = 20
EPILOGUE_CROPS = 2400     # the res101 detect step's RoIs: 8 images x 300


def epilogues_a_step(backbone):
    """frcnn::conv_epilogue launches in one forward: a ResNet's stem, pool
    mask, three a unit and a shortcut a block, the head's final mask, the
    RPN conv and block4 on the crops; R-101-FPN's stem, pool mask, three a
    unit and a shortcut a block (block4 on the image, no final mask), four
    laterals, four output convs and the RPN conv on five levels; vgg16's
    13 convs, 4 pool masks and the RPN conv; MobileNet's RPN conv alone
    (its layers keep the plain ops)."""
    from tf_faster_rcnn_torch.models import fpn
    from tf_faster_rcnn_torch.models.resnet_v1 import BLOCK_UNITS
    if backbone == "res101_fpn":
        units = BLOCK_UNITS[101]
        return (2 + 3 * sum(units) + len(units) + 2 * len(fpn.ROI_LEVELS)
                + len(fpn.RPN_LEVELS))
    if backbone.startswith("res"):
        units = BLOCK_UNITS[int(backbone[3:])]
        return 2 + 3 * sum(units[:3]) + 3 + 1 + 1 + 3 * units[3] + 1
    return {"vgg16": 13 + 4 + 1, "mobile": 1}[backbone]


def epilogue_inputs(dev, shape, dtype, mode, seed, layout="channels_last"):
    """One case's operands on the card, in layout (channels-last, or NCHW
    as cuDNN returns float64 convs): x, the constants (FrozenBN's float32
    buffers, prefolded bf16 buffers, or a bias), the residual (its leaf
    too, for a strided one), valid_hw with margins in both H and W, and the
    output's gradient."""
    import torch
    from tf_faster_rcnn_torch.ops.epilogue import float32_eps, frozen_bn_fold
    cl = getattr(torch, layout + ("" if layout == "channels_last"
                                  else "_format"))
    gen = torch.Generator(device=dev).manual_seed(seed)
    b, c, h, w = shape
    dt = getattr(torch, dtype)

    def draw(*size, scale=1.0):
        return (torch.randn(size, device=dev, generator=gen) * scale).to(dt)

    x = draw(*shape).contiguous(memory_format=cl).requires_grad_()
    kw, leaves = {}, {"x": x}
    if mode.startswith(("bn", "prefold")):
        mean = torch.randn(c, device=dev, generator=gen) * 0.1
        var = torch.rand(c, device=dev, generator=gen) + 0.5
        gamma = torch.randn(c, device=dev, generator=gen)
        beta = torch.randn(c, device=dev, generator=gen) * 0.1
        if mode.startswith("bn"):
            kw = dict(scale=gamma, shift=beta, mean=mean, var=var,
                      eps=float32_eps(1e-5))
        else:
            inv, sh = frozen_bn_fold(*(t.to(torch.bfloat16) for t in
                                       (mean, var, gamma, beta)), 1e-5)
            kw = dict(scale=inv.to(dt), shift=sh.to(dt))
    elif mode.startswith("bias"):
        kw = dict(shift=draw(c, scale=0.1).requires_grad_())
        leaves["shift"] = kw["shift"]
    if "+res" in mode:
        kw["residual"] = draw(*shape).contiguous(
            memory_format=cl).requires_grad_()
        leaves["residual"] = kw["residual"]
    elif "+sres" in mode:
        base = draw(b, c, 2 * h, 2 * w).contiguous(
            memory_format=cl).requires_grad_()
        kw["residual"] = base[:, :, ::2, ::2]
        leaves["residual"] = base
    kw["relu"] = "+relu" in mode
    if mode.endswith("mask"):
        rows = torch.randint(h // 2, h + 1, (b,), device=dev, generator=gen)
        cols = torch.randint(w // 2, w + 1, (b,), device=dev, generator=gen)
        rows[0], cols[0] = h, w                       # one image whole
        # a view with a row stride of 3, as the detect step's im_info[:, :2]
        kw["valid_hw"] = torch.stack([rows, cols, rows], 1).float()[:, :2]
    grad = draw(*shape).contiguous(memory_format=cl)
    return kw, leaves, grad


def same_bits(a, b):
    """Equal bit for bit, NaN payloads aside; both None counts as equal."""
    import torch
    if a is None or b is None:
        return a is None and b is None
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    ints = {2: torch.int16, 4: torch.int32, 8: torch.int64}[a.element_size()]
    return bool(((a.view(ints) == b.view(ints))
                 | (a.isnan() & b.isnan())).all())


def epilogue_case(dev, label, shape, dtype, mode, seed, times=False,
                  layout="channels_last"):
    """The kernel against the plain composition on one case: y and every
    gradient bit for bit; with times, each direction's device time (CUDA
    events, mean of EPILOGUE_ITERS after a warm-up) beside its byte bound
    and the plain composition's time. Returns the row."""
    import torch
    from tf_faster_rcnn_torch.ops.epilogue import (conv_epilogue,
                                                   conv_epilogue_plain)
    kw, leaves, grad = epilogue_inputs(dev, shape, dtype, mode, seed, layout)
    args = [leaves["x"], kw.get("scale"), kw.get("shift"), kw.get("mean"),
            kw.get("var"), kw.get("eps", 0.0), kw.get("residual"),
            kw.get("valid_hw"), kw["relu"]]
    names = list(leaves)
    outs = []
    for fn in (lambda: conv_epilogue(leaves["x"], **kw),
               lambda: conv_epilogue_plain(*args)):
        y = fn()
        outs.append((y.detach(), torch.autograd.grad(
            y, [leaves[n] for n in names], grad)))
    torch.cuda.synchronize()
    (y, grads), (y0, grads0) = outs
    equal = {"y": same_bits(y, y0)}
    equal.update({f"grad_{n}": same_bits(g, g0)
                  for n, g, g0 in zip(names, grads, grads0)})
    row = {"case": label, "shape": list(shape), "dtype": dtype, "mode": mode,
           "equal": equal}
    if not all(equal.values()):
        diff = float((y.double() - y0.double()).abs().max())
        raise AssertionError(f"epilogue {label} {shape} {dtype} {mode}: "
                             f"kernel != plain {equal}, |y - y0| {diff}")
    if times:
        row.update(epilogue_times(kw, leaves["x"], grad, y, args))
    return row


def epilogue_times(kw, x, grad, y, args, backward=True):
    """Forward and (with backward) backward device ms, byte bounds and
    shares at 3.35e12 B/s, and the plain composition's forward ms."""
    import torch
    from tf_faster_rcnn_torch.ops.epilogue import conv_epilogue_plain
    ep = torch.ops.frcnn
    x = x.detach()
    fargs = [x] + args[1:]
    size = x.numel() * x.element_size()
    relu = kw["relu"]
    res = kw.get("residual") is not None
    consts = sum(t.numel() * t.element_size() for t in args[1:5]
                 if t is not None)
    fwd_bytes = size * (2 + res) + consts
    scale, mean, var = args[1], args[3], args[4]
    want_gs = res and scale is not None
    bwd_bytes = size * (2 + relu + want_gs) + consts
    with torch.no_grad():
        fwd = timed(lambda: ep.conv_epilogue.default(*fargs),
                    iters=EPILOGUE_ITERS)
        rows = [("fwd", fwd, fwd_bytes)]
        if backward:
            rows.append(("bwd", timed(
                lambda: ep.conv_epilogue_backward.default(
                    grad, y if relu else None, scale, mean, var, args[5],
                    args[7], want_gs), iters=EPILOGUE_ITERS), bwd_bytes))
        plain = timed(lambda: conv_epilogue_plain(*fargs), iters=5)
    out = {}
    for key, ms, nbytes in rows:
        bound_ms = nbytes / HBM_BYTES_S * 1e3
        out.update({f"{key}_ms": ms, f"{key}_bytes": nbytes,
                    f"{key}_bound_ms": bound_ms,
                    f"{key}_share": bound_ms / ms})
    out["plain_fwd_ms"] = plain
    return out


def former_head(head, x, valid_hw):
    """A backbone head as the port ran it before its epilogues were one
    operator: each conv with its bias, then FrozenBatchNorm.forward, the
    ReLU, the residual add and mask_valid as PyTorch ops of their own."""
    import torch.nn.functional as F
    from tf_faster_rcnn_torch.models import vgg16
    from tf_faster_rcnn_torch.models.layers import mask_valid, shrink_valid

    def mask(t, vhw):
        return t if vhw is None else mask_valid(t, vhw)

    if isinstance(head, vgg16.VGG16Head):
        for i, (reps, _, name) in enumerate(vgg16._CFG):
            for r in range(reps):
                x = mask(F.relu(getattr(head, f"{name}_{r + 1}")(x)),
                         valid_hw)
            if i < len(vgg16._CFG) - 1:
                x = F.max_pool2d(x, 2, 2, ceil_mode=True)
                if valid_hw is not None:
                    valid_hw = shrink_valid(valid_hw, 2)
                x = mask(x, valid_hw)
            if name == "conv2":
                x = x.detach()
        return x
    if valid_hw is not None:
        valid_hw = shrink_valid(valid_hw, 2)
    x = mask(F.relu(head.conv1_bn(head.conv1(x))), valid_hw)
    x = F.max_pool2d(F.pad(x, (1, 1, 1, 1)), 3, 2)
    if valid_hw is not None:
        valid_hw = shrink_valid(valid_hw, 2)
    x = mask(x, valid_hw).detach()
    for b, s in enumerate(head.block_strides):
        x = former_block(getattr(head, f"block{b + 1}"), x, valid_hw)
        if valid_hw is not None:
            valid_hw = shrink_valid(valid_hw, s)
        if b + 1 <= head.fixed_blocks:
            x = x.detach()
    return mask(x, valid_hw)


def former_block(block, x, valid_hw=None):
    """A ResNet block of Bottlenecks as the port ran it before (former_head)."""
    import torch.nn.functional as F
    from tf_faster_rcnn_torch.models.layers import mask_valid, shrink_valid

    def conv_bn(u, t):
        t = u.bn(u.conv(t))
        return F.relu(t) if u.relu else t

    for u, s in enumerate(block.strides):
        unit = getattr(block, f"unit_{u + 1}")
        if unit.shortcut is not None:
            shortcut = conv_bn(unit.shortcut, x)
        elif unit.stride == 1:
            shortcut = x
        else:
            shortcut = x[:, :, ::unit.stride, ::unit.stride]
        r = conv_bn(unit.conv1, x)
        if valid_hw is not None:
            r = mask_valid(r, valid_hw)
        x = F.relu(shortcut + conv_bn(unit.conv3, conv_bn(unit.conv2, r)))
        if valid_hw is not None:
            valid_hw = shrink_valid(valid_hw, s)
    return x


def epilogue_modules(card, dev):
    """The backbones through the kernel against former_head, in bf16 on
    the bench's canvas with per-image extents: res101's head (and its
    trainable parameters' gradients) and its tail on 2,400 crops, vgg16's
    head (and gradients), all bit for bit under deterministic cuDNN; the
    launches counted against one a fused epilogue."""
    import torch
    from tf_faster_rcnn_torch.models import resnet_v1, vgg16
    from tf_faster_rcnn_torch.models.init import init_model
    from tf_faster_rcnn_torch.ops import epilogue
    from tf_faster_rcnn_torch.utils import trace
    cl = torch.channels_last
    gen = torch.Generator(device=dev).manual_seed(SEED)
    image = torch.randn((BATCH,) + CANVAS + (3,), device=dev,
                        generator=gen).permute(0, 3, 1, 2)
    # the detect step's view im_info[:, :2] (rows 3 apart)
    valid_hw = torch.tensor([IM_HW + (1.0,)] + [
        [600.0 - 40 * i, 1000.0 - 90 * i, 1.0] for i in range(1, BATCH)],
        device=dev)[:, :2]
    heads = {"res101": resnet_v1.ResNetV1Head(101, 1, torch.bfloat16),
             "vgg16": vgg16.VGG16Head(torch.bfloat16)}
    # epilogues a forward: res101's stem, pool mask, three per unit, the
    # shortcuts and the final mask; vgg16's 13 convs and 4 pool masks
    want = {"res101": 2 + 3 * 30 + 3 + 1, "vgg16": 13 + 4}
    rows = {}
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for name, head in heads.items():
            head = head.to(dev)
            init_model(head, torch.Generator().manual_seed(SEED))
            params = [p for p in head.parameters() if p.requires_grad]
            got = []
            for fn in (head, lambda x, v: former_head(head, x, v)):
                trace.zero(epilogue.LAUNCHES)
                y = fn(image.to(torch.bfloat16), valid_hw)
                launches = trace.counts().get(epilogue.LAUNCHES, 0)
                g = torch.randn(y.shape, device=dev,
                                generator=torch.Generator(device=dev)
                                .manual_seed(SEED + 1)).to(y.dtype)
                got.append((y.detach(), torch.autograd.grad(
                    y, params, g.contiguous(memory_format=cl),
                    allow_unused=True), launches))
            torch.cuda.synchronize()
            (y, grads, n), (y0, grads0, n0) = got
            equal = same_bits(y, y0) and all(
                same_bits(a, b) for a, b in zip(grads, grads0))
            used = sum(g is not None for g in grads)
            rows[name] = {"equal": equal, "launches": n,
                          "former_launches": n0, "gradients": used}
            print(f"epilogue {name} head bf16 {tuple(image.shape)}: output "
                  f"and {used} gradients bit-equal to the former "
                  f"composition {equal}; epilogue launches {n} (want "
                  f"{want[name]}), former {n0} [{card}]")
            if not equal or n != want[name] or n0 != 0:
                raise AssertionError(f"epilogue: the {name} head")
            del got, y, grads, y0, grads0
        tail = resnet_v1.ResNetV1Tail(101, torch.bfloat16).to(dev)
        init_model(tail, torch.Generator().manual_seed(SEED))
        crops = torch.randn((EPILOGUE_CROPS, 7, 7, 1024), device=dev,
                            generator=gen).to(torch.bfloat16)
        with torch.no_grad():
            trace.zero(epilogue.LAUNCHES)
            y = tail(crops)
            n = trace.counts().get(epilogue.LAUNCHES, 0)
            y0 = former_block(tail.block4,
                              crops.permute(0, 3, 1, 2)).mean(dim=(2, 3))
        torch.cuda.synchronize()
        equal = same_bits(y, y0)
        rows["res101 tail"] = {"equal": equal, "launches": n}
        print(f"epilogue res101 tail bf16 {tuple(crops.shape)}: bit-equal "
              f"{equal}, launches {n} (want 10) [{card}]")
        if not equal or n != 10:
            raise AssertionError("epilogue: the res101 tail")
    finally:
        torch.backends.cudnn.deterministic = deterministic
    torch.cuda.empty_cache()
    return rows


def phase_epilogue(card, dev):
    """Phase 3b (docstring): K3 against the plain composition, every mode
    in every dtype at a small shape and the cells' largest epilogues at
    theirs, forward and backward bit for bit and timed; then the backbones
    against their former composition. Returns the kernel line's entry."""
    import torch
    t0 = time.perf_counter()
    n = 0
    for dtype in ("bfloat16", "float32", "float64"):
        for i, mode in enumerate(EPILOGUE_MODES):
            epilogue_case(dev, "small", EPILOGUE_SMALL, dtype, mode, SEED + i)
            n += 1
    # float64 in NCHW, as cuDNN returns float64 convs: conv_epilogue copies
    # x, the residual and the gradient to the kernel's layout
    for mode in ("bn+res+relu+mask", "bias+sres+relu"):
        epilogue_case(dev, "nchw", EPILOGUE_SMALL, "float64", mode, SEED,
                      layout="contiguous")
        n += 1
    print(f"epilogue: {n} small cases ({len(EPILOGUE_MODES)} modes x 3 "
          f"dtypes at {list(EPILOGUE_SMALL)}, 2 in float64 NCHW) bit-equal, "
          "forward and backward")
    rows = []
    for i, (label, shape, dtype, mode) in enumerate(EPILOGUE_CASES):
        row = epilogue_case(dev, label, shape, dtype, mode, SEED + i,
                            times=True)
        rows.append(row)
        print(f"time epilogue {label} {shape} {dtype} {mode}: forward "
              f"{row['fwd_ms']:.4f} ms (bound {row['fwd_bound_ms']:.4f}, "
              f"share {row['fwd_share']:.3f}), backward "
              f"{row['bwd_ms']:.4f} ms (bound {row['bwd_bound_ms']:.4f}, "
              f"share {row['bwd_share']:.3f}), plain forward "
              f"{row['plain_fwd_ms']:.4f} ms; bit-equal [{card}]")
        torch.cuda.empty_cache()
    modules = epilogue_modules(card, dev)
    print(f"phase epilogue: {time.perf_counter() - t0:.1f} s")
    return {"name": "conv_epilogue", "route": "cuda",
            "source": "tf_faster_rcnn_torch/csrc/epilogue.cu",
            "replaces": None, "small_cases": n, "cases": rows,
            "modules": modules}


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
    t_plain = timed(lambda: plain(*args, **kwargs), iters=1, warmup=0)
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


def build_train_path(dev, backbone="res101", extra_cfg=(), mesh=None):
    """The backbone's train step at its YAML's TRAIN settings and
    extra_cfg, from the entry points a user calls: spec_from_cfg,
    FasterRCNN, create_train_state, make_train_step (data parallel over
    mesh, when given)."""
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
        nan_guard=bool(cfg.TPU.NAN_GUARD), mesh=mesh)
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


def build_detect_path(dev, spec, batch=BATCH, canvas=CANVAS):
    """A detect step of spec through make_detect_fn, with phase 4's seeded
    weights and scenes (the first `batch` of them), on canvas: each image
    600 x 1000 at scale 1.6 on the 608x1024 canvas, and in proportion on
    another (tools/profile_net.py's extents)."""
    import torch
    from tf_faster_rcnn_torch.engine.test_engine import make_detect_fn
    from tf_faster_rcnn_torch.models.init import init_model
    from tf_faster_rcnn_torch.models.network import FasterRCNN
    model = FasterRCNN(spec).eval()
    init_model(model, torch.Generator().manual_seed(SEED))
    h, w = canvas
    image = synthetic_scenes(np.random.RandomState(SEED), max(batch, BATCH),
                             h, w)
    image = torch.from_numpy(image[:batch]).to(dev)
    ih, iw = float(h * 600 // 608), float(w * 1000 // 1024)
    im_info = torch.tensor([[ih, iw, 1.6]] * batch, device=dev)
    orig_hw = torch.tensor([[ih / 1.6, iw / 1.6]] * batch, device=dev)
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
    from tf_faster_rcnn_torch.ops import epilogue
    from tf_faster_rcnn_torch.utils import trace
    model, detect, inputs = build_detect_path(dev, spec, batch)
    record = {}
    K.reset_launch_counts()
    trace.zero(epilogue.LAUNCHES)
    with nms_route(record=record):
        det, dv = detect(*inputs)
    torch.cuda.synchronize()
    launches = K.launch_counts()
    fused = trace.counts().get(epilogue.LAUNCHES, 0)
    top = spec.test_mode == "top"
    print(f"{label} path: {spec.backbone} {spec.compute_dtype} B={batch} "
          f"{CANVAS[0]}x{CANVAS[1]} {spec.num_classes} classes, proposals "
          + (f"top {spec.rpn_top_n}" if top else
             f"{spec.rpn_pre_nms_top_n}->{spec.rpn_post_nms_top_n}")
          + f"; launches {launches}, conv epilogue {fused}")
    want_k1 = 0 if top else 1
    if launches != {"nms_keep_mask_batched": want_k1, "batched_nms_keep": 1}:
        raise AssertionError(f"{label}: launches {launches}, want K1 "
                             f"{want_k1} and K2 1")
    if fused != epilogues_a_step(spec.backbone):
        raise AssertionError(f"{label}: {fused} conv epilogue launches, want "
                             f"{epilogues_a_step(spec.backbone)}")
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


@contextlib.contextmanager
def epilogue_calls(modules, calls):
    """Record in calls every frcnn::conv_epilogue call that the
    with_epilogue of one of modules (label -> ConvSame) makes, as (label,
    the conv's output, the epilogue's keyword operands), in call order."""
    from tf_faster_rcnn_torch.models import layers
    saved = layers.conv_epilogue
    current = []

    def recorded(x, **kw):
        if current:
            calls.append((current[-1], x, dict(kw)))
        return saved(x, **kw)

    def labelled(label, method):
        def call(*args, **kwargs):
            current.append(label)
            try:
                return method(*args, **kwargs)
            finally:
                current.pop()
        return call

    layers.conv_epilogue = recorded
    for label, module in modules.items():
        module.with_epilogue = labelled(label, module.with_epilogue)
    try:
        yield
    finally:
        layers.conv_epilogue = saved
        for module in modules.values():
            del module.with_epilogue


def epilogue_mode(kw):
    """A recorded call's terms in EPILOGUE_CASES' words ("bias+res+mask")."""
    terms = (("bn", kw.get("mean") is not None),
             ("bias", kw.get("mean") is None and kw.get("shift") is not None),
             ("res", kw.get("residual") is not None),
             ("relu", bool(kw.get("relu"))),
             ("mask", kw.get("valid_hw") is not None))
    return "+".join(name for name, on in terms if on)


def build_fpn_step(dev):
    """The r101-fpn-coco-detect-b8 cell's program and first batch: its
    configuration applied to the port's cfg (reset by the caller), its
    weights drawn from FPN_SEED, its first 8 images of the pool made from
    FPN_SEED prepared on their canvas. Returns (model, spec, detect,
    inputs)."""
    import torch
    from frcnn_bench import harness
    from frcnn_bench.reference.fpn import make_weights
    from frcnn_bench.traffic.scenes import make_pool
    from tf_faster_rcnn_torch.config import bucket_index, canvas_buckets
    from tf_faster_rcnn_torch.data.blob import prep_batch, upload
    from tf_faster_rcnn_torch.engine.test_engine import make_detect_fn
    cell = harness.load_cell(FPN_CELL)
    config, traffic = cell.config, cell.traffic
    cfg = harness.port_cfg(config)
    model, spec = harness.build_program(
        config, "TEST", make_weights(config, FPN_SEED, dev), dev)
    model.eval()
    pool = make_pool(traffic, config["num_classes"], FPN_SEED, dev)
    ims = pool.images[:int(traffic["batch"])]
    buckets = canvas_buckets(cfg.TEST)
    canvas = buckets[bucket_index(*ims[0].shape[:2], buckets)]
    test = config["cfg"]["TEST"]
    means = upload(np.asarray(config["cfg"]["PIXEL_MEANS"], np.float32), dev)
    inputs = prep_batch(ims, canvas, dev, [test["SCALES"][0]] * len(ims),
                        test["MAX_SIZE"], means)
    torch.cuda.synchronize()
    return model, spec, make_detect_fn(model, spec), inputs


def phase_fpn(card, dev, errors):
    """Phase 10b (docstring): R-101-FPN's detect step as its benchmark cell
    runs it. Returns {"paths": {"detect fpn": K1's and K2's rows},
    "epilogue": K3's rows at the P2 lateral and rpn_conv}, also printed
    as a kernel line."""
    import torch
    from tf_faster_rcnn_torch.config import reset_cfg
    from tf_faster_rcnn_torch.models import fpn
    from tf_faster_rcnn_torch.ops import epilogue
    from tf_faster_rcnn_torch.ops import nms_kernels as K
    from tf_faster_rcnn_torch.ops.epilogue import conv_epilogue_plain
    from tf_faster_rcnn_torch.utils import trace
    label = "detect fpn"
    t0 = time.perf_counter()
    try:
        model, spec, detect, inputs = build_fpn_step(dev)
        batch = inputs[0].shape[0]
        canvas = tuple(inputs[0].shape[1:3])
        with torch.inference_mode():
            detect(*inputs)           # cuDNN's first choices, off the count
        torch.cuda.synchronize()
        record, calls = {}, []
        modules = {f"lateral{k}": getattr(model.fpn, f"lateral{k}")
                   for k in fpn.ROI_LEVELS}
        modules["rpn_conv"] = model.rpn_conv
        K.reset_launch_counts()
        trace.zero(epilogue.LAUNCHES, fpn.NMS_INSTANCES)
        # the canvas's second step: it captures the trunk's graph, so every
        # call of the trunk runs once on the host and is counted
        with nms_route(record=record), epilogue_calls(modules, calls):
            det, dv = detect(*inputs)
        torch.cuda.synchronize()
        launches = K.launch_counts()
        counted = trace.counts()
        fused = counted.get(epilogue.LAUNCHES, 0)
        instances = counted.get(fpn.NMS_INSTANCES, 0)
        levels = len(fpn.RPN_LEVELS)
        print(f"{label} path: {spec.backbone} {spec.compute_dtype} B={batch} "
              f"{canvas[0]}x{canvas[1]} {spec.num_classes} classes, "
              f"proposals {spec.rpn_pre_nms_top_n} a level -> "
              f"{spec.rpn_post_nms_top_n}; launches {launches}, conv "
              f"epilogue {fused}, fpn.nms_instances {instances}")
        want = epilogues_a_step(spec.backbone)
        if launches != {"nms_keep_mask_batched": 1, "batched_nms_keep": 1}:
            raise AssertionError(f"{label}: launches {launches}, want K1 1 "
                                 "and K2 1")
        if fused != want:
            raise AssertionError(f"{label}: {fused} conv epilogue launches, "
                                 f"want {want}")
        if instances != batch * levels:
            raise AssertionError(f"{label}: fpn.nms_instances {instances}, "
                                 f"want {batch * levels}")
        k1_args, k1_kw = record["nms_keep_mask_batched"]
        k2_args, _ = record["batched_nms_keep"]
        k1_want = (batch * levels, spec.rpn_pre_nms_top_n, 4)
        k2_want = (batch * (spec.num_classes - 1), spec.rpn_post_nms_top_n,
                   4)
        if (tuple(k1_args[0].shape) != k1_want
                or k1_kw.get("max_keep") != spec.rpn_post_nms_top_n
                or tuple(k2_args[0].shape) != k2_want):
            raise AssertionError(
                f"{label}: K1 {tuple(k1_args[0].shape)} {k1_kw}, K2 "
                f"{tuple(k2_args[0].shape)}; want {k1_want} max_keep "
                f"{spec.rpn_post_nms_top_n} and {k2_want}")
        if tuple(det.shape) != (batch, spec.max_per_image, 6) \
                or not bool(torch.isfinite(det).all()):
            raise AssertionError(f"{label}: detections {tuple(det.shape)} "
                                 "or not finite")
        per_image = dv.sum(dim=1).tolist()
        print(f"  valid detections per image: {per_image}")
        if min(per_image) < 1:
            raise AssertionError(f"{label}: an image has no valid detection")
        for name, (args, kwargs) in record.items():
            kernel, plain = kernel_pairs()[name]
            check_equal(errors, name, kernel(*args, **kwargs),
                        plain(*args, **kwargs),
                        f"{label} path {tuple(args[0].shape)} {kwargs}")

        # K3 on the step's own operands: each lateral, rpn_conv a level
        names = [c[0] for c in calls]
        want_calls = [f"lateral{k}" for k in reversed(fpn.ROI_LEVELS)] \
            + ["rpn_conv"] * levels
        if names != want_calls:
            raise AssertionError(f"{label}: epilogue calls {names}, want "
                                 f"{want_calls}")
        rows, level = [], {}
        with torch.inference_mode():
            for name, x, kw in calls:
                level[name] = level.get(name, -1) + 1
                lv = (int(name[-1]) if name.startswith("lateral")
                      else fpn.RPN_LEVELS[level[name]])
                args = [x, kw.get("scale"), kw.get("shift"), kw.get("mean"),
                        kw.get("var"), kw.get("eps", 0.0),
                        kw.get("residual"), kw.get("valid_hw"),
                        bool(kw.get("relu", False))]
                mode = epilogue_mode(kw)
                y = epilogue.conv_epilogue(x, **kw)
                y0 = conv_epilogue_plain(*args)
                torch.cuda.synchronize()
                equal = same_bits(y, y0)
                case = f"r101-fpn {name} P{lv}"
                print(f"  epilogue {case} {tuple(x.shape)} {mode}: bit-equal "
                      f"to the plain composition {equal}")
                if not equal:
                    raise AssertionError(f"{label}: epilogue {case} kernel "
                                         "!= plain")
                if lv == fpn.ROI_LEVELS[0]:
                    row = {"case": case, "shape": list(x.shape),
                           "dtype": str(x.dtype).split(".")[-1],
                           "mode": mode, "equal": {"y": equal},
                           "launches": ("1 a forward" if name != "rpn_conv"
                                        else f"1 a level, {levels} a "
                                        "forward")}
                    row.update(epilogue_times(kw, x, None, y, args,
                                              backward=False))
                    print(f"time epilogue {case} {tuple(x.shape)} {mode}: "
                          f"forward {row['fwd_ms']:.4f} ms (bound "
                          f"{row['fwd_bound_ms']:.4f}, share "
                          f"{row['fwd_share']:.3f}), plain forward "
                          f"{row['plain_fwd_ms']:.4f} ms [{card}]")
                    rows.append(row)
        del calls

        syncs = host_syncs(lambda: detect(*inputs))
        print(f"  host syncs of the step (sync debug mode): {len(syncs)} "
              f"(the single-map step's: {DETECT_SYNCS})")
        for message in syncs:
            print("    " + message.splitlines()[0][:160])
        if len(syncs) > DETECT_SYNCS:
            raise AssertionError(f"{label}: {len(syncs)} host syncs, more "
                                 f"than the single-map step's "
                                 f"{DETECT_SYNCS}")

        # the trunk replayed from its graph against the trunk run eagerly,
        # and a replayed step against an eager one (a fresh cache's first)
        image, info = inputs[0], inputs[1]
        with torch.inference_mode():
            replayed = [t.clone() for t in model.trunk_graphs(
                model.head, spec.dtype, image, info)]
            eager = model.head(image.to(spec.dtype).permute(0, 3, 1, 2),
                               info[:, :2])
            det_r, dv_r = detect(*inputs)
            graphs, model.trunk_graphs = (model.trunk_graphs,
                                          fpn.TrunkGraphs())
            det_e, dv_e = detect(*inputs)
            model.trunk_graphs = graphs
        torch.cuda.synchronize()
        trunk_equal = all(same_bits(a, b) for a, b in zip(replayed, eager))
        step_equal = same_bits(det_r, det_e) and torch.equal(dv_r, dv_e)
        print(f"  trunk replayed from its CUDA graph ({len(graphs.graphs)} "
              f"canvas): bit-equal to the eager trunk {trunk_equal}; "
              f"replayed step's detections to an eager step's {step_equal}")
        if not (trunk_equal and step_equal):
            raise AssertionError(f"{label}: the replayed trunk differs from "
                                 "the eager one")
        del replayed, eager, det_r, dv_r, det_e, dv_e
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ms = timed(lambda: detect(*inputs))
        peak = torch.cuda.max_memory_allocated()
        print(f"time {label} step: {ms:.3f} ms, {batch * 1000.0 / ms:.2f} "
              f"images/s ({spec.backbone} {spec.compute_dtype}, TF32 off, "
              f"B={batch}, mean of {ITERS}), peak memory "
              f"{peak / 2**30:.3f} GiB [{card}]")
        paths = {label: {
            name: kernel_row(card, label, name, args, kwargs,
                             launches[name])
            for name, (args, kwargs) in record.items()}}
    finally:
        reset_cfg()
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": SOURCE,
         "replaces": REPLACES[name], "paths": {label: paths[label][name]}}
        for name in ("nms_keep_mask_batched", "batched_nms_keep")]
        + [{"name": "conv_epilogue", "route": "cuda",
            "source": "tf_faster_rcnn_torch/csrc/epilogue.cu",
            "replaces": None, "cases": rows}]}))
    print(f"phase {label}: {time.perf_counter() - t0:.1f} s")
    return {"paths": paths, "epilogue": rows}


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
    card, in process and through the CLIs; returns the kernels' rows, and
    the in-process run's all_boxes and mAP (phase 16's reference)."""
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
            rows, model, all_boxes, mean_ap = eval_in_process(card, dev,
                                                              errors, tmp)
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
    return rows, (all_boxes, mean_ap)


def eval_in_process(card, dev, errors, tmp):
    """test_net at the cfg in force (experiments/cfgs/res101.yml, B = 8) on
    phase 4's seeded weights: launches, kernels against their plain
    versions on the path's own inputs, the first batch's card canvases
    against CPU-built ones and its detections against make_detect_fn's,
    detections.pkl, mAP, ground truth scoring 1.0; then a second, timed
    run. Returns (the kernels' rows, the model, the run's all_boxes and
    mAP)."""
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
    return rows, model, all_boxes, mean_ap


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
                 "--workdir", wd, "--iters", str(REHEARSAL_ITERS)],
                cwd=root, env=CALLER_ENV, stdout=f,
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


def moved(args, device):
    """The tensors of a call's positional arguments on device."""
    import torch
    return [a.to(device) if torch.is_tensor(a) else a for a in args]


def phase_data_parallel(card, dev, errors, eval_ref):
    """Phases 16 and 17 (docstring), which share the two ranks' processes:
    the data-parallel step through NCCL at one rank and phase 17's vgg16
    reference step here, then two ranks sharing the card over gloo for
    phase 16's train step and striped eval and phase 17's model axis, then
    --devices above the GPU count; returns the kernels' rows of the
    two-rank paths."""
    import tempfile
    import torch
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_dp_") as tmp:
        reference = dp_one_rank(card, dev, tmp)
        torch.cuda.empty_cache()
        t_ma = time.perf_counter()
        ma_vgg16_noise(dev, tmp)
        references = {b: ma_float64(dev, b, tmp) for b in MA_BACKBONES}
        t_ma = time.perf_counter() - t_ma
        write_eval_tree(tmp)
        results = dp_spawn(tmp)
        rows = {"train dp2": dp_train_checks(card, dev, errors, reference,
                                             results, tmp),
                "eval dp2": dp_eval_checks(card, dev, errors, eval_ref,
                                           results, tmp)}
        dp_too_many_devices()
        t1 = time.perf_counter()
        ma_s = max(r["model_axis"]["seconds"] for r in results)
        print(f"phase data parallel: {t1 - t0 - t_ma - ma_s:.1f} s (the "
              f"ranks' phase 17 work taken out)")
        rows.update(phase_model_axis(card, dev, errors, references,
                                     eval_ref, results, tmp))
    print(f"phase model axis: {time.perf_counter() - t1 + t_ma + ma_s:.1f} "
          f"s (the float64 references {t_ma:.1f} s, the ranks' work "
          f"{ma_s:.1f} "
          f"s, the checks here)")
    return rows


def dp_one_rank(card, dev, tmp):
    """16a: phase 6's train step (a fresh state from its seed, its batch,
    one noise draw) once plain and once through the data-parallel step
    over an NCCL group of one rank, both under torch's deterministic
    algorithms: the losses and every parameter equal within DP_NCCL_TOL
    relative; then both steps' times. Saves the plain step's reference for
    16b in tmp (the noise, the global losses, the momentum after the step,
    the sampled labels) and returns it."""
    import torch
    from tf_faster_rcnn_torch.models.network import draw_noise
    from tf_faster_rcnn_torch.parallel import dist
    from tf_faster_rcnn_torch.parallel.launch import free_port
    from tf_faster_rcnn_torch.parallel.mesh import make_mesh
    spec, state, step, batch = build_train_path(dev)
    fh, fw = CANVAS[0] // spec.feat_stride, CANVAS[1] // spec.feat_stride
    noise = draw_noise(torch.Generator(device=dev).manual_seed(SEED + 16),
                       BATCH, fh * fw * spec.num_anchors,
                       spec.rpn_post_nms_top_n, dev)
    dist.initialize(f"localhost:{free_port()}", 1, 0, backend="nccl",
                    device=dev)
    try:
        mesh = make_mesh()
        _, dp_state, dp_step, _ = build_train_path(dev, mesh=mesh)
        dp_state.load_state_dict(state.state_dict())
        torch.use_deterministic_algorithms(True)
        try:
            runs = {}
            for label, st, fn in (("plain", state, step),
                                  ("nccl", dp_state, dp_step)):
                outs = {}
                with record_outputs(outs):
                    _, m = fn(st, batch, noise=noise)
                torch.cuda.synchronize()
                runs[label] = ({k: float(v) for k, v in m.items()}, {
                    n: p.detach().clone()
                    for n, p in st.model.named_parameters()}, outs)
        finally:
            torch.use_deterministic_algorithms(False)
        (pm, pp, po), (nm, np_, _) = runs["plain"], runs["nccl"]
        loss_err = max(abs(nm[k] - pm[k]) / max(abs(pm[k]), 1e-30)
                       for k in DP_LOSSES)
        param_err = max(float((np_[n] - pp[n]).abs().max())
                        / max(float(pp[n].abs().max()), 1e-30) for n in pp)
        print(f"data parallel, NCCL at one rank (deterministic "
              f"algorithms): losses max rel {loss_err:.2e}, parameters max "
              f"rel {param_err:.2e} (tol {DP_NCCL_TOL:g}); "
              f"{ {k: round(nm[k], 6) for k in DP_LOSSES} }")
        if loss_err > DP_NCCL_TOL or param_err > DP_NCCL_TOL:
            raise AssertionError("the NCCL data-parallel step differs from "
                                 "the plain step")
        reference = {
            "noise": tuple(t.cpu() for t in noise[:4]), "metrics": pm,
            "trace": {k: v.cpu() for k, v in state.trace.items()},
            "roi_labels": po["proposal_target"].labels.cpu(),
            "anchor_labels": po["anchor_target"].labels.cpu()}
        plain_ms = timed(lambda: step(state, batch), iters=DP_ITERS)
        nccl_ms = timed(lambda: dp_step(dp_state, batch), iters=DP_ITERS)
        print(f"time data parallel NCCL one rank: plain step "
              f"{plain_ms:.3f} ms, data-parallel step {nccl_ms:.3f} ms, the "
              f"reduce's cost {nccl_ms - plain_ms:.3f} ms (res101 f32, "
              f"B={BATCH}, mean of {DP_ITERS}) [{card}]")
    finally:
        dist.shutdown()
    torch.save(reference["noise"], os.path.join(tmp, "noise.pt"))
    del state, step, dp_state, dp_step, batch, runs
    return reference


def dp_spawn(tmp):
    """16b-16c: DP_RANKS processes (dp_worker) sharing the card over gloo;
    each must exit 0 within DP_TIMEOUT_S (both are stopped otherwise).
    Returns their results, by rank."""
    from tf_faster_rcnn_torch.parallel.launch import free_port
    root = os.path.dirname(os.path.abspath(__file__))
    port = free_port()
    procs, logs = [], []
    for rank in range(DP_RANKS):
        log = open(os.path.join(tmp, f"rank{rank}.log"), "w")
        logs.append(log)
        procs.append(subprocess.Popen(
            [sys.executable, "-c", "import chip_smoke; chip_smoke.dp_worker("
             f"{rank}, {DP_RANKS}, {port}, {tmp!r})"],
            cwd=root, env=dict(os.environ), stdout=log,
            stderr=subprocess.STDOUT))
    deadline = time.time() + DP_TIMEOUT_S
    try:
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.time()))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()
    failed = [r for r, p in enumerate(procs) if p.returncode != 0]
    for rank in range(DP_RANKS):
        with open(os.path.join(tmp, f"rank{rank}.log")) as f:
            lines = f.read().splitlines()
        keep = lines if rank in failed else [
            ln for ln in lines if ln.startswith("rank")]
        for ln in keep[-60:]:
            print(f"  [rank {rank}] {ln}")
    if failed:
        raise AssertionError(f"data-parallel ranks {failed} failed (exit "
                             f"codes {[p.returncode for p in procs]})")
    results = [load_pickle(os.path.join(tmp, f"rank{rank}.pkl"))
               for rank in range(DP_RANKS)]
    imported = [res["jax"] for res in results]
    print(f"data parallel ranks: modules of JAX or the JAX package "
          f"imported: {imported}")
    if any(imported):
        raise AssertionError("a rank imported JAX or the JAX package")
    return results


@contextlib.contextmanager
def timed_agreements(record):
    """parallel.dist's host agreements (barrier, broadcast_object,
    any_process), each call's seconds on the host clock appended to
    record[name] while the context is open; the engine and the loop call
    them through the module, so they see the timed ones."""
    from tf_faster_rcnn_torch.parallel import dist
    plain = {n: getattr(dist, n) for n in ("barrier", "broadcast_object",
                                           "any_process")}

    def timing(name, fn):
        def call(*args, **kwargs):
            t = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                record.setdefault(name, []).append(time.perf_counter() - t)
        return call

    for name, fn in plain.items():
        setattr(dist, name, timing(name, fn))
    try:
        yield record
    finally:
        for name, fn in plain.items():
            setattr(dist, name, fn)


def dp_worker(rank, world, port, tmp):
    """One rank of 16b-16c, a process of its own on cuda:0 in a gloo group
    of world ranks: phase 6's train step on its rows of the global batch
    and noise (one compared step, then DP_STEPS more, timed, with the
    gradient reduce timed apart), then test_net over the VOC tree in tmp
    on phase 4's seeded weights, striped over the ranks, at phase 11's
    TPU.IMS_PER_DEVICE and at DP_EVAL_BATCH (dp_eval_run). Writes its
    results to tmp/rank{rank}.pkl (and the momentum after the compared step
    to tmp/trace{rank}.pt)."""
    import pickle
    import torch
    from tf_faster_rcnn_torch.config import cfg
    from tf_faster_rcnn_torch.engine import train as train_mod
    from tf_faster_rcnn_torch.models.network import TrainNoise, shard_noise
    from tf_faster_rcnn_torch.ops import nms_kernels as K
    from tf_faster_rcnn_torch.parallel import dist
    from tf_faster_rcnn_torch.parallel.mesh import make_mesh, shard_batch
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()
    dist.initialize(f"localhost:{port}", world, rank, backend="gloo",
                    device=dev)
    out = {"rank": rank}
    try:
        mesh = make_mesh()
        spec, state, step, batch = build_train_path(dev, mesh=mesh)
        local = shard_batch(mesh, batch)
        noise = shard_noise(TrainNoise(*(t.to(dev) for t in torch.load(
            os.path.join(tmp, "noise.pt")))), rank, world)
        k1, outs = {}, {}
        K.reset_launch_counts()
        torch.use_deterministic_algorithms(True)
        try:
            with nms_route(record=k1), record_outputs(outs):
                _, m = step(state, local, noise=noise)
            torch.cuda.synchronize()
        finally:
            torch.use_deterministic_algorithms(False)
        args, kwargs = k1["nms_keep_mask_batched"]
        out["train"] = {
            "metrics": {k: float(v) for k, v in m.items()},
            "launches": K.launch_counts(),
            "k1": (moved(args, "cpu"), kwargs),
            "roi_labels": outs["proposal_target"].labels.cpu(),
            "anchor_labels": outs["anchor_target"].labels.cpu()}
        torch.save({k: v.cpu() for k, v in state.trace.items()},
                   os.path.join(tmp, f"trace{rank}.pt"))

        # DP_STEPS more, with the noise drawn from the state's generator;
        # the gradient reduce timed on the host clock to a synchronize
        reduce_s = []
        plain_reduce = train_mod.all_reduce_buckets

        def timed_reduce(grads, mesh_):
            torch.cuda.synchronize()
            t = time.perf_counter()
            plain_reduce(grads, mesh_)
            torch.cuda.synchronize()
            reduce_s.append(time.perf_counter() - t)

        train_mod.all_reduce_buckets = timed_reduce
        try:
            steps = []
            for _ in range(DP_STEPS):
                dist.barrier("dp_step")
                torch.cuda.synchronize()
                t = time.perf_counter()
                _, m = step(state, local)
                torch.cuda.synchronize()
                steps.append(((time.perf_counter() - t),
                              {k: float(v) for k, v in m.items()}))
        finally:
            train_mod.all_reduce_buckets = plain_reduce
        # the train loop's host agreements, timed apart: the preemption
        # flags' all_gather (every TRAIN.DISPLAY steps) and the barrier
        # after a summary or an eval
        agree = {}
        with timed_agreements(agree):
            for _ in range(DP_ITERS):
                dist.any_process(False)
                dist.barrier("dp_agree")
        out["train"]["steps"] = steps
        out["train"]["reduce_s"] = reduce_s
        out["train"]["agree_s"] = agree
        out["train"]["display"] = int(cfg.TRAIN.DISPLAY)
        out["train"]["launches_all"] = K.launch_counts()
        print(f"rank {rank}: train steps done, launches "
              f"{K.launch_counts()}", flush=True)
        del state, step, batch, local
        torch.cuda.empty_cache()
        out["eval"] = {b: dp_eval_run(tmp, b, f"eval_dp2_b{b}")
                       for b in (BATCH, DP_EVAL_BATCH)}
        out["dp_seconds"] = time.perf_counter() - t_start
        torch.cuda.empty_cache()
        out["model_axis"] = ma_worker(rank, tmp, dev)
        out["jax"] = sorted(
            name for name in sys.modules
            if name == "jax" or name.startswith(("jax.",
                                                 "tf_faster_rcnn_tpu")))
    finally:
        dist.shutdown()
    with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    print(f"rank {rank}: done", flush=True)


def dp_eval_run(tmp, batch, name, mesh=None):
    """test_net over the VOC tree in tmp at TPU.IMS_PER_DEVICE batch on
    phase 4's seeded weights, into tmp/name (striped over the ranks when a
    process group is up; over mesh's data groups, the model laid out for
    its model axis at TPU.MODEL_DEVICES, when given), its NMS calls logged;
    each call's kernels against their plain versions here. Returns the
    run's record."""
    import torch
    from tf_faster_rcnn_torch.config import cfg_from_file, cfg_from_list, \
        reset_cfg
    from tf_faster_rcnn_torch.datasets.factory import get_imdb
    from tf_faster_rcnn_torch.engine import test_engine as E
    from tf_faster_rcnn_torch.models.init import init_model
    from tf_faster_rcnn_torch.models.network import FasterRCNN, spec_from_cfg
    from tf_faster_rcnn_torch.ops import nms_kernels as K
    from tf_faster_rcnn_torch.parallel import dist
    from tf_faster_rcnn_torch.parallel.mesh import (model_axis_size,
                                                    shard_model)
    root = os.path.dirname(os.path.abspath(__file__))
    reset_cfg()
    cfg_from_file(os.path.join(root, EVAL_CFG_FILE))
    cfg_from_list(["TPU.IMS_PER_DEVICE", str(batch), "DATA_DIR", tmp,
                   "ROOT_DIR", tmp, "TPU.MODEL_DEVICES",
                   str(model_axis_size(mesh))])
    try:
        spec = spec_from_cfg("res101", NUM_CLASSES, "TEST")
        model = FasterRCNN(spec).eval()
        init_model(model, torch.Generator().manual_seed(SEED))
        shard_model(mesh, model, "res101")
        imdb = get_imdb("voc_2007_test")
        calls = []
        K.reset_launch_counts()
        dist.barrier(f"{name}_start")
        t = time.perf_counter()
        agree = {}
        with nms_route(log=calls), timed_agreements(agree):
            mean_ap, _ = quiet(lambda: E.test_net(
                model, spec, imdb, name, output_dir=os.path.join(tmp, name),
                mesh=mesh))
        seconds = time.perf_counter() - t
        launches = K.launch_counts()
        err = {n: 0 for n in kernel_pairs()}
        for n, args, kwargs in calls:
            kernel, plain = kernel_pairs()[n]
            quiet(lambda: check_equal(err, n, kernel(*args, **kwargs),
                                      plain(*args, **kwargs), name))
        first = {}
        for n, args, kwargs in calls:
            first.setdefault(n, (moved(args, "cpu"), kwargs))
    finally:
        reset_cfg()
    print(f"rank {dist.process_index()}: {name} done, {len(calls)} NMS "
          f"calls, mAP {mean_ap}", flush=True)
    return {"mAP": mean_ap, "seconds": seconds, "launches": launches,
            "calls": len(calls), "max_abs_err": err, "first": first,
            "agree_s": sum(sum(v) for v in agree.values())}


def dp_train_checks(card, dev, errors, reference, results, tmp):
    """16b's checks in this process: each rank's global losses against
    16a's within DP_LOSS_TOL relative, the momentum after the step (the
    gradients) within DP_GRAD_TOL of its largest, the ranks' momentum
    equal, the sampled labels equal to 16a's rows, K1 launched once a step
    at this rank's [B / ranks, N] and equal to its plain version on its
    inputs; the times of the steps after; returns rank 0's kernel row."""
    import torch
    want = reference["metrics"]
    traces = [torch.load(os.path.join(tmp, f"trace{r}.pt"))
              for r in range(DP_RANKS)]
    scale = max(float(t.abs().max()) for t in reference["trace"].values())
    grad_err = max(float((traces[0][k] - t).abs().max())
                   for k, t in reference["trace"].items()) / scale
    same = all(torch.equal(traces[0][k], traces[r][k])
               for r in range(1, DP_RANKS) for k in traces[0])
    per = BATCH // DP_RANKS
    flips = {}
    for name in ("roi_labels", "anchor_labels"):
        got = torch.cat([res["train"][name] for res in results])
        flips[name] = int((got != reference[name]).sum())
    rows = []
    for res in results:
        tr = res["train"]
        loss_err = max(abs(tr["metrics"][k] - want[k])
                       / max(abs(want[k]), 1e-30) for k in DP_LOSSES)
        args, kwargs = tr["k1"]
        args = moved(args, dev)
        n = tuple(args[0].shape)
        print(f"data parallel rank {res['rank']} of {DP_RANKS} (gloo, "
              f"cuda:0 shared): losses max rel {loss_err:.2e} (tol "
              f"{DP_LOSS_TOL:g}); "
              f"{ {k: round(tr['metrics'][k], 6) for k in DP_LOSSES} }; "
              f"K1 launches after the step {tr['launches']}, at {n} "
              f"{kwargs}")
        if loss_err > DP_LOSS_TOL:
            raise AssertionError("two-rank losses differ from one rank's")
        if tr["launches"] != {"nms_keep_mask_batched": 1,
                              "batched_nms_keep": 0} or \
                n[0] != per or kwargs["max_keep"] != 2000:
            raise AssertionError(f"K1 on rank {res['rank']}: "
                                 f"{tr['launches']} at {n} {kwargs}")
        check_equal(errors, "nms_keep_mask_batched",
                    kernel_pairs()["nms_keep_mask_batched"][0](*args,
                                                               **kwargs),
                    kernel_pairs()["nms_keep_mask_batched"][1](*args,
                                                               **kwargs),
                    f"train dp2 rank {res['rank']} {n} {kwargs}")
        step_ms = [ms * 1e3 for ms, _ in tr["steps"]]
        reduce_ms = [s * 1e3 for s in tr["reduce_s"]]
        print(f"time data parallel train rank {res['rank']}: steps "
              f"{[round(x, 3) for x in step_ms]} ms (two ranks on one card, "
              f"B={per} each), gradient reduce "
              f"{[round(x, 3) for x in reduce_ms]} ms = "
              f"{sum(reduce_ms) / sum(step_ms):.1%} of the step; losses "
              f"{[round(m['total_loss'], 6) for _, m in tr['steps']]} "
              f"[{card}]")
        agree_ms = {k: 1e3 * sum(v) / len(v) for k, v in tr["agree_s"].items()}
        share = agree_ms["any_process"] / (tr["display"] * np.mean(step_ms))
        print(f"time data parallel host agreements rank {res['rank']}: "
              f"any_process {agree_ms['any_process']:.3f} ms, barrier "
              f"{agree_ms['barrier']:.3f} ms (gloo host group, mean of "
              f"{DP_ITERS}); any_process every TRAIN.DISPLAY="
              f"{tr['display']} steps = {share:.3%} of the step time "
              f"[{card}]")
        if not all(np.isfinite(m["total_loss"]) for _, m in tr["steps"]):
            raise AssertionError("a two-rank step's loss is not finite")
        rows.append(kernel_row(card, f"train dp2 rank {res['rank']}",
                               "nms_keep_mask_batched", args, kwargs,
                               tr["launches_all"]["nms_keep_mask_batched"]))
    print(f"  momentum after the step (the gradients): max |diff| "
          f"{grad_err:.2e} of the largest (tol {DP_GRAD_TOL:g}); equal on "
          f"every rank {same}; labels that differ from one rank's "
          f"(deterministic algorithms): {flips}")
    if grad_err > DP_GRAD_TOL or not same or any(flips.values()):
        raise AssertionError("two-rank gradients or labels differ")
    row = dict(rows[0])
    row["rank_launches"] = [r["launches"] for r in rows]
    return {"nms_keep_mask_batched": row}


def boxes_diff(a, b):
    """(the (class, image) entries of two detections.pkl trees that differ,
    the largest |difference| of those of one shape)."""
    differ, worst = 0, 0.0
    for ra, rb in zip(a[1:], b[1:]):
        for x, y in zip(ra, rb):
            x, y = np.asarray(x), np.asarray(y)
            if x.shape != y.shape:
                differ += 1
            elif not np.array_equal(x, y):
                differ += 1
                worst = max(worst, float(np.abs(x - y).max()))
    return differ, worst


def dp_eval_checks(card, dev, errors, eval_ref, results, tmp):
    """16c's checks: at phase 11's batch (TPU.IMS_PER_DEVICE 8 on each
    rank) the merged detections.pkl equal to phase 11's and the same mAP;
    at DP_EVAL_BATCH the merged detections equal to one process's at that
    batch (run here) and the same mAP as phase 11, with the difference from
    phase 11's detections (another batch, other cuDNN algorithms) printed;
    in both, every image detected, only rank 0 with the mAP, and each
    rank's kernels equal to their plain versions on its calls. Times:
    images/s of the ranks together. Returns the kernels' rows of the
    DP_EVAL_BATCH run (rank 0's inputs)."""
    all_boxes, mean_ap = eval_ref
    one = dp_eval_run(tmp, DP_EVAL_BATCH, "eval_one_process")
    one_boxes = load_pickle(os.path.join(tmp, "eval_one_process",
                                         "detections.pkl"))
    ok = True
    for batch, want, want_map, label in (
            (BATCH, all_boxes, mean_ap, "phase 11's"),
            (DP_EVAL_BATCH, one_boxes, one["mAP"], "one process's")):
        merged = load_pickle(os.path.join(tmp, f"eval_dp2_b{batch}",
                                          "detections.pkl"))
        ev = [res["eval"][batch] for res in results]
        equal = equal_all_boxes(merged, want)
        covered = all(isinstance(merged[c][i], np.ndarray)
                      for c in range(1, NUM_CLASSES)
                      for i in range(len(merged[1])))
        n = len(merged[1])
        seconds = max(e["seconds"] for e in ev)
        print(f"data parallel eval ({DP_RANKS} ranks on one card, "
              f"IMS_PER_DEVICE {batch}): mAP {ev[0]['mAP']} ({label} "
              f"{want_map}, phase 11's {mean_ap}), other ranks "
              f"{[e['mAP'] for e in ev[1:]]}; merged detections equal to "
              f"{label} {equal}, every image covered {covered}; launches "
              f"{[e['launches'] for e in ev]}; kernel errors "
              f"{[e['max_abs_err'] for e in ev]}")
        if batch != BATCH:
            differ, worst = boxes_diff(merged, all_boxes)
            print(f"  IMS_PER_DEVICE {batch} against phase 11's 8: "
                  f"{differ} of {(NUM_CLASSES - 1) * n} (class, image) "
                  f"entries differ, by at most {worst:.3g}")
        print(f"time data parallel eval IMS_PER_DEVICE {batch}: "
              f"{seconds:.3f} s for {n} images = {n / seconds:.2f} images/s "
              f"for the {DP_RANKS} ranks together (decode to mAP; res101 "
              f"f32, TF32 off); host agreements (barriers, run token) by "
              f"rank {[round(e['agree_s'], 3) for e in ev]} s = "
              f"{[round(e['agree_s'] / e['seconds'], 4) for e in ev]} of "
              f"each rank's eval [{card}]")
        ok &= (equal and covered and ev[0]["mAP"] == want_map == mean_ap
               and all(e["mAP"] is None for e in ev[1:])
               and not any(v for e in ev for v in e["max_abs_err"].values()))
    if not ok:
        raise AssertionError("the striped eval differs")
    print(f"time eval one process IMS_PER_DEVICE {DP_EVAL_BATCH}: "
          f"{one['seconds']:.3f} s for 64 images [{card}]")
    rows = {}
    ev = [res["eval"][DP_EVAL_BATCH] for res in results]
    for name in kernel_pairs():
        args, kwargs = ev[0]["first"][name]
        args = moved(args, dev)
        check_equal(errors, name, kernel_pairs()[name][0](*args, **kwargs),
                    kernel_pairs()[name][1](*args, **kwargs),
                    f"eval dp2 {tuple(args[0].shape)} {kwargs}")
        rows[name] = kernel_row(card, "eval dp2", name, args, kwargs,
                                ev[0]["launches"][name])
        rows[name]["rank_launches"] = [e["launches"][name] for e in ev]
    return rows


def dp_too_many_devices():
    """16d: tools.trainval_net --devices (one more than the GPUs) exits
    nonzero with a message that names the GPU count."""
    import torch
    root = os.path.dirname(os.path.abspath(__file__))
    n = torch.cuda.device_count()
    proc = subprocess.run(
        [sys.executable, "-m", "tf_faster_rcnn_torch.tools.trainval_net",
         "--devices", str(n + 1)], cwd=root, env=CALLER_ENV,
        capture_output=True, text=True, timeout=300)
    said = (proc.stdout + proc.stderr).strip().splitlines()[-1:]
    print(f"trainval_net --devices {n + 1} on {n} GPU(s): exit "
          f"{proc.returncode}, {said}")
    if proc.returncode == 0 or f"this host has {n}" not in proc.stderr:
        raise AssertionError("--devices above the GPU count did not fail "
                             "naming the GPU count")


def ma_vgg16_noise(dev, tmp):
    """17b's noise for phase 9's vgg16 step, with the dropout masks, saved
    to tmp for the ranks (17a takes 16a's)."""
    import torch
    from tf_faster_rcnn_torch.config import cfg_from_list, reset_cfg
    from tf_faster_rcnn_torch.models.network import draw_noise, spec_from_cfg
    reset_cfg()
    cfg_from_list(BACKBONE_TRAIN_CFG["vgg16"])
    spec = spec_from_cfg("vgg16", NUM_CLASSES, "TRAIN")
    reset_cfg()
    fh, fw = CANVAS[0] // spec.feat_stride, CANVAS[1] // spec.feat_stride
    noise = draw_noise(torch.Generator(device=dev).manual_seed(SEED + 17),
                       BATCH, fh * fw * spec.num_anchors,
                       spec.rpn_post_nms_top_n, dev,
                       BATCH * spec.roi_batch_size)
    torch.save({"noise": tuple(t.cpu() for t in noise[:4]),
                "dropout": tuple(t.cpu() for t in noise.dropout)},
               os.path.join(tmp, "noise_vgg16.pt"))


@contextlib.contextmanager
def computing_in(model, dtype):
    """Every convolution and matmul of model computing in dtype (their
    compute_dtype) while the context is open."""
    saved = [(m, m.compute_dtype) for m in model.modules()
             if hasattr(m, "compute_dtype")]
    for m, _ in saved:
        m.compute_dtype = dtype
    try:
        yield model
    finally:
        for m, dt in saved:
            m.compute_dtype = dt


@contextlib.contextmanager
def timed_collectives(record):
    """The model axis's collectives, each call's seconds (host clock
    between two synchronizes, the packing included) appended to
    record[kind] while the context is open: "halo" (the halo exchanges,
    forward and backward), "gather" (the feature gather), "tp" (the tensor
    parallel reduces, forward and backward) and "grad" (the gradient
    reduces of the step)."""
    import torch
    from tf_faster_rcnn_torch.engine import train as train_mod
    from tf_faster_rcnn_torch.parallel import spatial, tensor_parallel
    sites = [(spatial._Halo, "forward", "halo"),
             (spatial._Halo, "backward", "halo"),
             (spatial._GatherRows, "forward", "gather"),
             (tensor_parallel._Reduce, "forward", "tp"),
             (tensor_parallel._Copy, "backward", "tp")]
    saved = [(cls, name, cls.__dict__[name]) for cls, name, _ in sites]

    def timing(kind, fn):
        def call(*args, **kwargs):
            torch.cuda.synchronize()
            t = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                torch.cuda.synchronize()
                record.setdefault(kind, []).append(time.perf_counter() - t)
        return call

    for cls, name, kind in sites:
        setattr(cls, name, staticmethod(timing(kind, cls.__dict__[name]
                                               .__func__)))
    plain_reduce = train_mod.all_reduce_buckets
    train_mod.all_reduce_buckets = timing("grad", plain_reduce)
    try:
        yield record
    finally:
        for cls, name, fn in saved:
            setattr(cls, name, fn)
        train_mod.all_reduce_buckets = plain_reduce


def ma_train(mesh, backbone, tmp, dev, rank):
    """17a-17b (and 17d for res101) on this rank: the backbone's train step
    from build_train_path laid out for the 1 x 2 mesh (shard_params: TP of
    the RoI head), on the whole batch's rows of this rank (split_canvas:
    SP of the head), with the reference's noise, under deterministic
    algorithms and computing in float64 as the reference does; then
    MA_STEPS more in float32 timed, and one with the collectives timed.
    Writes the layout-free momentum after the compared step (rank 0) and,
    for res101, the snapshot and the gathered state to tmp."""
    import torch
    from tf_faster_rcnn_torch.ops import nms_kernels as K
    from tf_faster_rcnn_torch.parallel import dist
    from tf_faster_rcnn_torch.parallel.mesh import (gather_params,
                                                    model_index,
                                                    shard_batch,
                                                    shard_params, tp_dim)
    from tf_faster_rcnn_torch.utils import checkpoint as ckpt
    spec, state, step, batch = build_train_path(dev, backbone, mesh=mesh)
    shard_params(mesh, state, backbone)
    local = shard_batch(mesh, batch, spatial=True)
    noise = ma_noise(tmp, backbone, dev)
    k1, outs = {}, {}
    K.reset_launch_counts()
    torch.use_deterministic_algorithms(True)
    try:
        with nms_route(record=k1), record_outputs(outs), \
                computing_in(state.model, torch.float64):
            _, m = step(state, local, noise=noise)
        torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(False)
    args, kwargs = k1["nms_keep_mask_batched"]
    res = {"metrics": {k: float(v) for k, v in m.items()},
           "launches": K.launch_counts(), "k1": (moved(args, "cpu"), kwargs),
           "roi_labels": outs["proposal_target"].labels.cpu(),
           "anchor_labels": outs["anchor_target"].labels.cpu(),
           "canvas_h": local.get("canvas_h"),
           "rows": tuple(local["image"].shape)}
    full = gather_params(mesh, state)
    if rank == 0:
        torch.save({k: v.cpu() for k, v in full["trace"].items()},
                   os.path.join(tmp, f"ma_trace_{backbone}.pt"))
    if backbone == "res101":
        # 17d: the snapshot, layout-free; each rank's slices are its part
        # of the gathered state
        i = model_index(mesh)
        own = dict(state.model.state_dict(), **{
            "trace:" + k: v for k, v in state.trace.items()})
        whole = dict(full["params"], **{
            "trace:" + k: v for k, v in full["trace"].items()})
        res["shards_ok"] = all(
            torch.equal(t, whole[k]) if tp_dim(k.split(":")[-1], backbone)
            is None else torch.equal(t, whole[k].chunk(DP_RANKS, dim=tp_dim(
                k.split(":")[-1], backbone))[i]) for k, t in own.items())
        res["snapshot"] = ckpt.snapshot(os.path.join(tmp, "ma_snap"),
                                        MA_PREFIX, state, {}, mesh=mesh)
        if rank == 0:
            torch.save({part: {k: v.cpu() for k, v in full[part].items()}
                        for part in ("params", "trace")},
                       os.path.join(tmp, "ma_gathered.pt"))
    del full
    torch.cuda.reset_peak_memory_stats()
    steps = []
    for _ in range(MA_STEPS):
        dist.barrier("ma_step")
        torch.cuda.synchronize()
        t = time.perf_counter()
        _, m = step(state, local)
        torch.cuda.synchronize()
        steps.append(time.perf_counter() - t)
    res["steps_s"] = steps
    res["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    collectives = {}
    dist.barrier("ma_collectives")
    with timed_collectives(collectives):
        torch.cuda.synchronize()
        t = time.perf_counter()
        step(state, local)
        torch.cuda.synchronize()
        res["instrumented_s"] = time.perf_counter() - t
    res["collectives"] = {k: (len(v), sum(v)) for k, v in collectives.items()}
    res["launches_all"] = K.launch_counts()
    del state, step, batch, local
    torch.cuda.empty_cache()
    return res


def ma_worker(rank, tmp, dev):
    """Phase 17 on this rank of phase 16's two processes: the 1 x 2 mesh
    (make_hybrid_mesh), res101 and vgg16 train steps (ma_train), and
    test_net over phase 11's tree at TPU.MODEL_DEVICES 2 (dp_eval_run with
    the mesh)."""
    from tf_faster_rcnn_torch.parallel.mesh import make_hybrid_mesh
    t0 = time.perf_counter()
    mesh = make_hybrid_mesh(DP_RANKS)
    out = {"coords": (mesh.get_local_rank("data"),
                      mesh.get_local_rank("model"))}
    for backbone in MA_BACKBONES:
        out[backbone] = ma_train(mesh, backbone, tmp, dev, rank)
        print(f"rank {rank}: model axis {backbone} train done", flush=True)
    out["eval"] = dp_eval_run(tmp, BATCH, "eval_ma", mesh=mesh)
    out["seconds"] = time.perf_counter() - t0
    return out


def all_boxes_slabs(all_boxes):
    """detections.pkl's all_boxes as detection slabs: (det [N, D, 6] of
    (cls, score, x1, y1, x2, y2), valid [N, D]) tensors, D the most
    detections of an image."""
    import torch
    n = len(all_boxes[1])
    rows = [[(c, *b[4:5], *b[:4]) for c in range(1, len(all_boxes))
             for b in np.asarray(all_boxes[c][i]).reshape(-1, 5)]
            for i in range(n)]
    d = max(1, max(len(r) for r in rows))
    det = np.zeros((n, d, 6), np.float32)
    valid = np.zeros((n, d), bool)
    for i, r in enumerate(rows):
        if r:
            det[i, :len(r)] = r
            valid[i, :len(r)] = True
    return torch.from_numpy(det), torch.from_numpy(valid)


def ma_noise(tmp, backbone, dev):
    """The TrainNoise of the backbone's reference step, saved in tmp."""
    import torch
    from tf_faster_rcnn_torch.models.network import TrainNoise
    if backbone == "vgg16":
        saved = torch.load(os.path.join(tmp, "noise_vgg16.pt"))
        return TrainNoise(*(t.to(dev) for t in saved["noise"]),
                          dropout=tuple(t.to(dev) for t in saved["dropout"]))
    return TrainNoise(*(t.to(dev) for t in torch.load(
        os.path.join(tmp, "noise.pt"))))


def trace_err(got, want):
    """The largest |difference| of two momentum traces over the largest
    magnitude of want's."""
    scale = max(float(t.abs().max()) for t in want.values())
    return max(float((got[k].cpu() - t.cpu()).abs().max())
               for k, t in want.items()) / scale


def step_distance(metrics, trace, outs, reference):
    """How far a step is from the reference step: the losses' largest
    relative difference, the momentum's (trace_err), and the sampled RoI
    and anchor labels that differ."""
    want = reference["metrics"]
    return {"loss": max(abs(metrics[k] - want[k]) / max(abs(want[k]), 1e-30)
                        for k in DP_LOSSES),
            "loss_by_key": {k: abs(metrics[k] - want[k])
                            / max(abs(want[k]), 1e-30) for k in DP_LOSSES},
            "grad": trace_err(trace, reference["trace"]),
            "roi_labels": int((outs["roi_labels"].cpu()
                               != reference["roi_labels"]).sum()),
            "anchor_labels": int((outs["anchor_labels"].cpu()
                                  != reference["anchor_labels"]).sum())}


def ma_float64(dev, backbone, tmp):
    """17a-17b's reference, the plain step in float64: phase 6's (or 9's)
    step from a fresh seeded state with 16a's (or ma_vgg16_noise's) noise,
    every convolution and matmul computing in float64, under
    deterministic algorithms; its metrics, momentum and sampled labels."""
    import torch
    _, state, step, batch = build_train_path(dev, backbone)
    outs = {}
    torch.use_deterministic_algorithms(True)
    try:
        with record_outputs(outs), computing_in(state.model, torch.float64):
            _, m = step(state, batch, noise=ma_noise(tmp, backbone, dev))
        torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(False)
    exact = {"metrics": {k: float(v) for k, v in m.items()},
             "trace": {k: v.cpu() for k, v in state.trace.items()},
             "roi_labels": outs["proposal_target"].labels.cpu(),
             "anchor_labels": outs["anchor_target"].labels.cpu()}
    del state, step, batch, outs
    torch.cuda.empty_cache()
    return exact


def ma_train_checks(card, dev, errors, backbone, reference, results, tmp,
                    failed):
    """17a-17b's checks in this process, both steps in float64: the
    ranks' losses equal; against the reference (step_distance) the losses
    within DP_LOSS_TOL relative, the layout-free momentum within
    DP_GRAD_TOL of its largest, the sampled labels of both ranks equal.
    (In float32 the random-weight step is discontinuous within an ulp of
    its parameters, and a split canvas's convolutions, which cuDNN runs by
    other algorithms, and a split layer's sums round otherwise: PERF.md.)
    SP and TP in force; K1 once at [BATCH, N] -> 2000 on each rank, equal
    to its plain version on each rank's inputs; the float32 times.
    Appends what failed to failed and returns rank 0's kernel row."""
    import torch
    trace = torch.load(os.path.join(tmp, f"ma_trace_{backbone}.pt"))
    runs = [res["model_axis"][backbone] for res in results]
    far = [step_distance(r["metrics"], trace, r, reference) for r in runs]
    by_key = far[0].pop("loss_by_key")
    far = {k: max(f[k] for f in far) for k in far[0]}
    same = all(r["metrics"] == runs[0]["metrics"] for r in runs)
    tol = {"loss": DP_LOSS_TOL, "grad": DP_GRAD_TOL, "roi_labels": 0,
           "anchor_labels": 0}
    print(f"model axis {backbone} train (1 x 2 mesh, TP of the RoI head and "
          f"SP of the head, two ranks on cuda:0 over gloo; float64, "
          f"deterministic algorithms): canvas rows "
          f"{[r['rows'] for r in runs]} of {runs[0]['canvas_h']}; losses "
          f"equal on both ranks {same}; "
          f"{ {k: round(runs[0]['metrics'][k], 6) for k in DP_LOSSES} }; "
          f"from one rank's step: {far}, the losses by key "
          f"{ {k: float(f'{v:.3g}') for k, v in by_key.items()} } (tol "
          f"{tol})")
    if not (same and all(far[k] <= tol[k] for k in tol)
            and all(r["canvas_h"] == CANVAS[0] for r in runs)):
        failed.append(f"model axis {backbone}: the step differs from one "
                      "rank's")
    rows = []
    for rank, r in enumerate(runs):
        args, kwargs = r["k1"]
        args = moved(args, dev)
        n = tuple(args[0].shape)
        if r["launches"] != {"nms_keep_mask_batched": 1,
                             "batched_nms_keep": 0} or n[0] != BATCH \
                or kwargs["max_keep"] != 2000:
            raise AssertionError(f"K1 on rank {rank}: {r['launches']} at {n} "
                                 f"{kwargs}")
        check_equal(errors, "nms_keep_mask_batched",
                    kernel_pairs()["nms_keep_mask_batched"][0](*args,
                                                               **kwargs),
                    kernel_pairs()["nms_keep_mask_batched"][1](*args,
                                                               **kwargs),
                    f"train model axis {backbone} rank {rank} {n} {kwargs}")
        step_ms = [x * 1e3 for x in r["steps_s"]]
        inst = r["instrumented_s"]
        shares = {k: f"{c} calls {s * 1e3:.3f} ms = {s / inst:.1%}"
                  for k, (c, s) in sorted(r["collectives"].items())}
        print(f"time model axis {backbone} train rank {rank}: steps "
              f"{[round(x, 3) for x in step_ms]} ms (B={BATCH}, half the "
              f"canvas rows each, two ranks on one card over gloo, f32); "
              f"peak memory {r['peak_gib']:.3f} GiB; one step with each "
              f"collective synchronized {inst * 1e3:.3f} ms, of it {shares} "
              f"[{card}]")
        rows.append(kernel_row(card, f"train model axis {backbone} rank "
                               f"{rank}", "nms_keep_mask_batched", args,
                               kwargs,
                               r["launches_all"]["nms_keep_mask_batched"]))
    row = dict(rows[0])
    row["rank_launches"] = [r["launches"] for r in rows]
    return {"nms_keep_mask_batched": row}


def ma_eval_checks(card, dev, errors, eval_ref, results, tmp, failed):
    """17c's checks: every image detected, the detections matched to phase
    11's at IoU 0.9 (matched_share) in at least MA_SHARE of them, the mAP
    on rank 0 only (its difference from phase 11's printed), each rank's
    kernels equal to their plain versions on its calls; the time. Returns
    the kernels' rows (rank 0's inputs)."""
    all_boxes, mean_ap = eval_ref
    merged = load_pickle(os.path.join(tmp, "eval_ma", "detections.pkl"))
    ev = [res["model_axis"]["eval"] for res in results]
    n = len(merged[1])
    covered = all(isinstance(merged[c][i], np.ndarray)
                  for c in range(1, NUM_CLASSES) for i in range(n))
    hit, total = matched_share(*all_boxes_slabs(merged),
                               *all_boxes_slabs(all_boxes))
    got_map = ev[0]["mAP"]
    print(f"model axis eval (test_net at TPU.MODEL_DEVICES 2, both ranks "
          f"on every batch, IMS_PER_DEVICE {BATCH}): every image covered "
          f"{covered}; {hit} of {total} of phase 11's detections matched at "
          f"IoU 0.9 = {hit / max(total, 1):.4f} (min {MA_SHARE}); mAP "
          f"{got_map} against phase 11's {mean_ap} (difference "
          f"{(got_map or 0.0) - mean_ap:+.6f}), other rank "
          f"{[e['mAP'] for e in ev[1:]]}; launches "
          f"{[e['launches'] for e in ev]}; kernel errors "
          f"{[e['max_abs_err'] for e in ev]}")
    print(f"time model axis eval: {max(e['seconds'] for e in ev):.3f} s for "
          f"{n} images = {n / max(e['seconds'] for e in ev):.2f} images/s "
          f"(both ranks on every image; res101 f32, TF32 off) [{card}]")
    if (not covered or hit < MA_SHARE * total or got_map is None
            or any(e["mAP"] is not None for e in ev[1:])
            or any(v for e in ev for v in e["max_abs_err"].values())):
        failed.append("the model-axis eval differs")
    rows = {}
    for name in kernel_pairs():
        args, kwargs = ev[0]["first"][name]
        args = moved(args, dev)
        check_equal(errors, name, kernel_pairs()[name][0](*args, **kwargs),
                    kernel_pairs()[name][1](*args, **kwargs),
                    f"eval model axis {tuple(args[0].shape)} {kwargs}")
        rows[name] = kernel_row(card, "eval model axis", name, args, kwargs,
                                ev[0]["launches"][name])
        rows[name]["rank_launches"] = [e["launches"][name] for e in ev]
    return rows


def ma_snapshot_check(dev, results, tmp, failed):
    """17d: the snapshot written at 1 x 2, restored into one process's
    state (build_train_path), equals the gathered state bit for bit; each
    rank's slices were its part of it."""
    import torch
    from tf_faster_rcnn_torch.utils import checkpoint as ckpt
    runs = [res["model_axis"]["res101"] for res in results]
    path = runs[0]["snapshot"][0]
    _, state, _, _ = build_train_path(dev)
    ckpt.restore(state, path)
    gathered = torch.load(os.path.join(tmp, "ma_gathered.pt"))
    loaded = state.state_dict()
    equal = all(torch.equal(loaded[part][k].cpu(), v)
                for part in ("params", "trace")
                for k, v in gathered[part].items())
    keys = all(set(loaded[p]) == set(gathered[p]) for p in ("params",
                                                          "trace"))
    print(f"model axis snapshot: {os.path.basename(path)} written by rank 0 "
          f"alone {[r['snapshot'] is None for r in runs[1:]]}, restored in "
          f"one process equal to the gathered state bit for bit "
          f"{equal and keys}; each rank's slices its part of it "
          f"{[r['shards_ok'] for r in runs]}")
    if not (equal and keys and all(r["shards_ok"] for r in runs)
            and all(r["snapshot"] is None for r in runs[1:])):
        failed.append("the model-axis snapshot differs from the gathered "
                      "state")
    del state
    torch.cuda.empty_cache()


def phase_model_axis(card, dev, errors, references, eval_ref, results,
                     tmp):
    """Phase 17 (docstring), the checks in this process of what phase 16's
    two ranks ran (ma_worker); returns the kernels' rows of its paths."""
    coords = [res["model_axis"]["coords"] for res in results]
    print(f"model axis: ranks at (data, model) {coords}; worker seconds "
          f"{[round(r['model_axis']['seconds'], 1) for r in results]}")
    if coords != [(0, r) for r in range(DP_RANKS)]:
        raise AssertionError(f"the 1 x {DP_RANKS} mesh: {coords}")
    failed = []
    rows = {f"train model axis {b}": ma_train_checks(
        card, dev, errors, b, references[b], results, tmp, failed)
        for b in MA_BACKBONES}
    rows["eval model axis"] = ma_eval_checks(card, dev, errors, eval_ref,
                                             results, tmp, failed)
    ma_snapshot_check(dev, results, tmp, failed)
    if failed:
        raise AssertionError("; ".join(failed))
    return rows


def phase_nms_api(card, dev, errors):
    """Phase 18 (docstring): class_aware_nms and multiclass_nms on phase 4's
    per-class boxes. Returns the kernel rows of the two API paths."""
    import torch
    from tf_faster_rcnn_torch.engine.detect import class_boxes, multiclass_nms
    from tf_faster_rcnn_torch.ops import nms_kernels as K
    from tf_faster_rcnn_torch.ops.nms import class_aware_nms
    t0 = time.perf_counter()
    model, _, (image, im_info, orig_hw) = build_detect_path(dev, build_spec())
    with torch.inference_mode():
        out = model(image, im_info)
        pb, ps = class_boxes(out["rois"], out["cls_prob"], out["bbox_pred"],
                             im_info, orig_hw, num_classes=NUM_CLASSES)
    boxes, scores = pb[0].clone(), ps[0].clone()
    valid = out["roi_valid"][0][None].expand_as(scores).clone()
    del model, out, pb, ps
    rows = {}
    for label, fn, kw in (
            ("class_aware_nms", class_aware_nms, dict(max_out=100)),
            ("multiclass_nms", multiclass_nms, dict())):
        record = {}
        K.reset_launch_counts()
        with nms_route(record=record):
            got = fn(boxes, scores, valid, 0.3, **kw)
        torch.cuda.synchronize()
        launches = K.launch_counts()
        with nms_route(plain=True):
            want = fn(boxes, scores, valid, 0.3, **kw)
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        equal = all(torch.equal(a, b) for a, b in zip(got, want))
        print(f"{label} {tuple(boxes.shape)} {kw}: launches {launches}, "
              f"output equal to its plain version: {equal}, kept "
              f"{int(got[-1].sum())}")
        if launches != {"nms_keep_mask_batched": 1, "batched_nms_keep": 0} \
                or not equal:
            raise AssertionError(f"{label}: launches {launches} or kernel "
                                 "!= plain")
        args, kwargs = record["nms_keep_mask_batched"]
        check_equal(errors, "nms_keep_mask_batched",
                    K.nms_keep_mask_batched(*args, **kwargs),
                    K.nms_keep_mask_plain(*args, **kwargs),
                    f"{label} path {tuple(args[0].shape)} {kwargs}")
        rows[label] = {"nms_keep_mask_batched": kernel_row(
            card, label, "nms_keep_mask_batched", args, kwargs,
            launches["nms_keep_mask_batched"])}
    torch.cuda.empty_cache()
    print(f"phase NMS API: {time.perf_counter() - t0:.1f} s")
    return rows


def phase_tools(card, dev, errors):
    """Phase 19 (docstring): the measurement tools' path. Returns the kernel
    rows of the bench's train path and of the sweep's largest batch."""
    import torch
    from tf_faster_rcnn_torch.engine.test_engine import make_detect_fn
    from tf_faster_rcnn_torch.ops import nms_kernels as K
    from tf_faster_rcnn_torch.tools import bench, bench_sweep, bench_train
    t0 = time.perf_counter()
    workload, first, log = bench.detect_workload, {}, []

    def recording(*args, **kwargs):
        """bench.detect_workload whose detect keeps its first output."""
        spec, model, detect, inputs = workload(*args, **kwargs)

        def call(*a):
            out = detect(*a)
            if not first:
                first.update(out=tuple(t.clone() for t in out), spec=spec,
                             model=model, inputs=inputs)
            return out
        return spec, model, call, inputs

    bench.detect_workload = recording
    try:
        K.reset_launch_counts()
        with nms_route(log=log):
            result = bench.measure(iters=TOOL_ITERS, windows=TOOL_WINDOWS,
                                   warmup=TOOL_WARMUP,
                                   train_iters=TOOL_TRAIN_ITERS)
        torch.cuda.synchronize()
        launches = K.launch_counts()
    finally:
        bench.detect_workload = workload
    detect_steps = TOOL_WARMUP + TOOL_ITERS * TOOL_WINDOWS
    train_steps = bench_train.WARMUP + TOOL_TRAIN_ITERS * bench_train.WINDOWS
    k1_caps = [kw.get("max_keep") for name, _, kw in log
               if name == "nms_keep_mask_batched"]
    print(f"tools: bench.measure {json.dumps(result)}; {detect_steps} detect "
          f"and {train_steps} train steps, launches {launches}, K1 caps "
          f"{k1_caps} [{card}]")
    want = {"nms_keep_mask_batched": detect_steps + train_steps,
            "batched_nms_keep": detect_steps}
    if launches != want or k1_caps != ([300] * detect_steps
                                       + [2000] * train_steps):
        raise AssertionError(f"tools: launches {launches}, want {want}; K1 "
                             f"caps {k1_caps}")
    if set(result) != BENCH_KEYS or not all(
            np.isfinite(result[k]) and result[k] > 0
            for k in BENCH_KEYS - {"metric", "unit"}):
        raise AssertionError(f"tools: bench.measure returned {result}")
    det, dv = first["out"]
    with torch.inference_mode():
        ref = make_detect_fn(first["model"], first["spec"])(*first["inputs"])
    torch.cuda.synchronize()
    equal = torch.equal(det, ref[0]) and torch.equal(dv, ref[1])
    per_image = dv.sum(dim=1).tolist()
    print(f"tools: the bench's first detections {tuple(det.shape)}, finite "
          f"{bool(torch.isfinite(det).all())}, valid per image {per_image}, "
          f"equal to make_detect_fn's bit for bit {equal}")
    if not (equal and tuple(det.shape) == (BATCH, 100, 6)
            and bool(torch.isfinite(det).all()) and min(per_image) >= 1):
        raise AssertionError("tools: the bench's detections")
    _, args, kwargs = [c for c in log if c[0] == "nms_keep_mask_batched"][-1]
    del first, log, det, dv, ref
    rows = {}
    check_equal(errors, "nms_keep_mask_batched",
                K.nms_keep_mask_batched(*args, **kwargs),
                K.nms_keep_mask_plain(*args, **kwargs),
                f"bench train path {tuple(args[0].shape)} {kwargs}")
    rows["bench train bf16"] = {"nms_keep_mask_batched": kernel_row(
        card, "bench train bf16", "nms_keep_mask_batched", args, kwargs,
        launches["nms_keep_mask_batched"] - detect_steps)}
    del args, kwargs
    torch.cuda.empty_cache()

    # the sweep's largest batch, in process
    record = {}
    K.reset_launch_counts()
    with nms_route(record=record):
        line = bench_sweep.measure(SWEEP_BATCH, 1, warmup=1, reps=1)
    torch.cuda.synchronize()
    launches = K.launch_counts()
    print(f"tools: bench_sweep.measure B={SWEEP_BATCH} {json.dumps(line)}, "
          f"launches {launches} [{card}]")
    if launches != {"nms_keep_mask_batched": 2, "batched_nms_keep": 2} \
            or set(line) != SWEEP_KEYS or not line["images_per_sec"] > 0:
        raise AssertionError(f"tools: the sweep at B={SWEEP_BATCH}")
    args, kwargs = record["batched_nms_keep"]
    check_equal(errors, "batched_nms_keep",
                K.batched_nms_keep(*args, **kwargs),
                K.batched_nms_keep_plain(*args, **kwargs),
                f"sweep path {tuple(args[0].shape)} {kwargs}")
    rows[f"sweep B={SWEEP_BATCH} bf16"] = {"batched_nms_keep": kernel_row(
        card, f"sweep B={SWEEP_BATCH} bf16", "batched_nms_keep", args, kwargs,
        launches["batched_nms_keep"])}
    del record, args, kwargs
    torch.cuda.empty_cache()

    # the sweep's CLI, as a user runs it
    root = os.path.dirname(os.path.abspath(__file__))
    t = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, os.path.join("tf_faster_rcnn_torch", "tools",
                                      "bench_sweep.py"), *SWEEP_CLI],
        cwd=root, env=CALLER_ENV, capture_output=True, text=True, timeout=300)
    if proc.returncode:
        raise AssertionError(f"bench_sweep.py exited {proc.returncode}:\n"
                             f"{proc.stdout[-2000:]}{proc.stderr[-3000:]}")
    lines = proc.stdout.splitlines()
    last = json.loads(lines[-1])
    print(f"tools: bench_sweep.py {' '.join(SWEEP_CLI)} in "
          f"{time.perf_counter() - t:.1f} s (process start and build "
          f"included); its card line {lines[0]!r}; last line {lines[-1]}")
    if set(last) != SWEEP_KEYS or lines[0] != card or (
            last["net"], last["batch"], last["s2d"], last["cfg"]) != (
            "res101", BATCH, False, None) or not last["images_per_sec"] > 0:
        raise AssertionError("tools: bench_sweep.py's output")
    print(f"phase tools: {time.perf_counter() - t0:.1f} s")
    return rows


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
    epilogue_row = phase_epilogue(card, dev)
    print(f"phases 1-3b: {time.perf_counter() - start:.1f} s")
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
    fpn_rows = phase_fpn(card, dev, errors)
    paths.update(fpn_rows["paths"])
    epilogue_row["cases"] += fpn_rows["epilogue"]
    torch.cuda.empty_cache()
    paths["eval f32"], eval_ref = phase_eval(card, dev, errors)
    paths.update(phase_train_loop(card, dev, errors, train_ms))
    paths["serve f32"] = phase_serve(card, dev, errors)
    paths.update(phase_from_scratch(card, dev, errors))
    paths.update(phase_rehearsal(card, dev, errors))
    print(f"phases 1-15: {time.perf_counter() - start:.1f} s")
    paths.update(phase_data_parallel(card, dev, errors, eval_ref))
    print(f"phases 1-17: {time.perf_counter() - start:.1f} s")
    paths.update(phase_nms_api(card, dev, errors))
    print(f"phases 1-18: {time.perf_counter() - start:.1f} s")
    paths.update(phase_tools(card, dev, errors))
    print(f"phases 1-19: {time.perf_counter() - start:.1f} s")

    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": SOURCE,
         "replaces": REPLACES[name], "launches": launches[name],
         "max_abs_err": errors[name], "ms": times[name][0],
         "plain_ms": times[name][1], "bound_ms": times[name][2],
         "bound_by": times[name][3], "library_ms": None,
         "paths": {path: rows[name] for path, rows in paths.items()
                   if name in rows}}
        for name in ("nms_keep_mask_batched", "batched_nms_keep")]
        + [epilogue_row]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
