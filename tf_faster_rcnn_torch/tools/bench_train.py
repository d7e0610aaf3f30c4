#!/usr/bin/env python3
"""Train-step throughput of the bench workload on one NVIDIA GPU: the port's
counterpart of the JAX package's ``tools/bench_train.py``.

    python3 tf_faster_rcnn_torch/tools/bench_train.py [--batch 8]
        [--iters 10] [--net res101] [--canvas 608,1024]
        [--s2d 0] [--cfg YML]

The workload is ``tools/bench_train.py:41-76``'s: net (res101) in TRAIN mode
with **6000 -> 2000** proposals (K1 at max_keep 2000) on the canvas H,W, or,
with --cfg, that YAML's TRAIN canvas (``canvas_hw(cfg.TRAIN)``) and counts
with 6000 pre-NMS; TPU.COMPUTE_DTYPE bfloat16 with float32 parameters, TF32
off; B images of scaled noise (``randn * 40`` at seed 0) unless the caller
gives its own (``bench.py`` gives its scenes), the extent h*600//608 by
w*1000//1024 at scale 1.6, and two GT boxes an image. The step is
``engine/train.py::make_train_step``'s, on ``create_train_state``'s state,
with ``lr_schedule(0.001, 0.1, [350000])`` for the learning-rate metric, the
YAML's weight decays, SGD with momentum as the defaults set it.

As in ``bench.py`` in this directory: the weights are
``models/init.py::init_model``'s from a CPU generator seeded 0, and the
state's sampling generator is seeded 3 (torch's bits differ from JAX's
PRNGKey(0) and PRNGKey(3)); --s2d 1 sets TPU.SPACE_TO_DEPTH, which
``spec_from_cfg`` refuses, so the default is 0 where the JAX tool's is 1
(the port runs the plain stem, which is exact); WARMUP steps, then WINDOWS
windows of --iters steps on the host clock from a synchronize to another,
and the median window, where the JAX tool keeps the best of 3 on-device
loops. Each step updates the state in place, as a training run does.

Prints the card's name and power limit, that TF32 is off, the windows'
images/s, and last one JSON line with the JAX tool's keys: metric, batch,
images_per_sec and ms_per_step. Runs on the card only; the tests call
``measure(device="cpu")``.
"""

import argparse
import dataclasses
import json
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

WARMUP = 2
WINDOWS = 3
# two GT boxes an image (x1, y1, x2, y2, class), bench_train.py:72-75
GT_BOXES = [[40, 60, 300, 400, 7], [200, 100, 500, 330, 12]]


def train_workload(net="res101", batch=8, canvas="608,1024", cfg_file=None,
                   image=None, s2d=False, device=None):
    """(spec, state, step, batch): the bench's train step on device (the card
    when None). The spec: net in TRAIN mode at TPU.COMPUTE_DTYPE bfloat16
    with 6000 -> 2000 proposals on canvas "H,W"; or, with cfg_file, that
    YAML merged over it, its TRAIN counts with 6000 pre-NMS and its TRAIN
    canvas. s2d sets TPU.SPACE_TO_DEPTH, which spec_from_cfg refuses. The
    weights are init_model's (a CPU generator seeded 0), the state
    create_train_state's (its generator seeded 3), the step
    make_train_step's at the cfg's weight decays, which the port's cfg keeps
    as this set it. image ([batch, H, W, 3]) defaults to randn * 40 at seed
    0; every image gets GT_BOXES."""
    from tf_faster_rcnn_torch.config import (canvas_hw, cfg, cfg_from_file,
                                             reset_cfg)
    from tf_faster_rcnn_torch.engine.train import (create_train_state,
                                                   lr_schedule,
                                                   make_train_step)
    from tf_faster_rcnn_torch.models.init import init_model
    from tf_faster_rcnn_torch.models.network import FasterRCNN, spec_from_cfg
    from tf_faster_rcnn_torch.tools.bench import DTYPE, device_for, noise
    from tf_faster_rcnn_torch.tools.train_profile import NUM_CLASSES
    dev = device_for(device)
    reset_cfg()
    cfg.TPU.COMPUTE_DTYPE = DTYPE
    cfg.TPU.SPACE_TO_DEPTH = bool(s2d)
    if cfg_file:
        cfg_from_file(cfg_file)
        spec = dataclasses.replace(spec_from_cfg(net, NUM_CLASSES, "TRAIN"),
                                   rpn_pre_nms_top_n=6000)
        h, w = canvas_hw(cfg.TRAIN)
    else:
        spec = dataclasses.replace(spec_from_cfg(net, NUM_CLASSES, "TRAIN"),
                                   rpn_pre_nms_top_n=6000,
                                   rpn_post_nms_top_n=2000)
        h, w = (int(x) for x in canvas.split(","))
    if image is None:
        image = noise(np.random.RandomState(0), batch, h, w)
    if image.shape != (batch, h, w, 3):
        raise ValueError(f"image {image.shape}, the workload wants "
                         f"{(batch, h, w, 3)}")
    ih, iw = float(h * 600 // 608), float(w * 1000 // 1024)
    inputs = {
        "image": image.astype(np.float32),
        "im_info": np.tile(np.array([[ih, iw, 1.6]], np.float32), (batch, 1)),
        "gt_boxes": np.tile(np.array([GT_BOXES], np.float32), (batch, 1, 1)),
        "gt_valid": np.ones((batch, len(GT_BOXES)), bool)}
    model = FasterRCNN(spec, device=dev)
    init_model(model, torch.Generator().manual_seed(0))
    state = create_train_state(spec, model,
                               torch.Generator(device=dev).manual_seed(3))
    step = make_train_step(
        model, spec, weight_decay=float(cfg.TRAIN.WEIGHT_DECAY),
        bias_decay=bool(cfg.TRAIN.BIAS_DECAY),
        mobile_weight_decay=float(cfg.MOBILENET.WEIGHT_DECAY),
        regu_depth=bool(cfg.MOBILENET.REGU_DEPTH),
        lr_fn=lr_schedule(0.001, 0.1, [350000]))
    return spec, state, step, {k: torch.from_numpy(v).to(dev)
                               for k, v in inputs.items()}


def measure(net="res101", batch=8, iters=10, canvas="608,1024", s2d=False,
            cfg_path=None, image=None, windows=WINDOWS, warmup=WARMUP,
            device=None):
    """Measure the train step; returns the JAX tool's dict (bench.py folds
    it into its line). image: an optional [batch, H, W, 3] float32 input."""
    from tf_faster_rcnn_torch.tools.bench import (device_for, median_window,
                                                  time_windows)
    dev = device_for(device)
    _, state, step, inputs = train_workload(net, batch, canvas, cfg_path,
                                            image, s2d, dev)
    seconds = time_windows(lambda: step(state, inputs), iters, windows,
                           warmup, dev)
    dt = median_window("train", batch, iters, seconds, dev)
    return {"metric": f"{net}_train_throughput", "batch": batch,
            "images_per_sec": batch * iters / dt,
            "ms_per_step": 1000 * dt / iters}


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--batch", type=int, default=8)
    parser.add_argument("--iters", type=int, default=10)
    parser.add_argument("--net", default="res101")
    parser.add_argument("--canvas", default="608,1024")
    parser.add_argument("--s2d", type=int, default=0,
                        help="TPU.SPACE_TO_DEPTH: refused (the port runs the "
                             "plain stem)")
    parser.add_argument("--cfg", default=None,
                        help="yml config; uses its TRAIN canvas/anchors/"
                             "counts")
    args = parser.parse_args()
    sys.path.insert(0, ROOT)
    from tf_faster_rcnn_torch.tools.bench import (card_line, device_for,
                                                  tf32_off)
    device_for()
    print(card_line())
    tf32_off()
    print(json.dumps(measure(net=args.net, batch=args.batch, iters=args.iters,
                             canvas=args.canvas, s2d=bool(args.s2d),
                             cfg_path=args.cfg)))


if __name__ == "__main__":
    main()
