#!/usr/bin/env python3
"""The two readings that each compared number's limit is set from.

    python3 frcnn_bench/calibrate.py --workload <cell> --seeds 1,2,...
        [--control-seeds 7,8,9] [--seconds 3] [--fault <name>]

Lower reading: the cell run as the benchmark runs it (a short window), on
each seed of --seeds, and its compared numbers. Upper reading: the
control, on each of --control-seeds: the reference itself in the
program's place at one precision below the configuration's bfloat16
(float8 e4m3 inputs and weights of every convolution and matrix product),
its outputs judged as the program's are, at the cell's own sizes. With
--fault, the --seeds run under that fault of ``faults.py`` instead (a
training number's other upper reading). Prints one JSON line per run and,
last, the largest reading of each number on each side and the smallest of
the control's. Not run by the benchmark's own runs.
"""

import argparse
import contextlib
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from frcnn_bench import harness  # noqa: E402
from frcnn_bench.faults import FAULTS  # noqa: E402
from frcnn_bench.reference.model import (Reference, fp8, prep_images,  # noqa: E402,E501
                                         sgd_step, trainable)
from frcnn_bench.traffic.scenes import make_pool  # noqa: E402
from frcnn_bench.weights import make_weights  # noqa: E402


def control_detect(cell, seed, device, quant=fp8):
    """The numbers of the reference at quant in the program's place, on
    the sampled steps of seed's run."""
    from tf_faster_rcnn_torch.config import bucket_index, canvas_buckets
    from frcnn_bench import detect_loop
    config, traffic = cell.config, cell.traffic
    cfg = harness.port_cfg(config)
    buckets = canvas_buckets(cfg.TEST)
    pool = make_pool(traffic, config["num_classes"], seed, device)
    batch = int(traffic["batch"])
    weights = make_weights(config, seed, device)
    ref = Reference(config, weights)
    low = Reference(config, weights, quant=quant)

    def images_of(i):
        return [(i * batch + j) % len(pool) for j in range(batch)]

    def canvas_of(i):
        k = images_of(i)[0]
        return buckets[bucket_index(*pool.images[k].shape[:2], buckets)]

    sample = detect_loop._sample(cell, seed,
                                 lambda i: buckets.index(canvas_of(i)))
    numbers = {}
    for i in sample:
        ims = [pool.images[k] for k in images_of(i)]
        prog = detect_loop.control_outputs(low, ims, canvas_of(i), device)
        got, _ = detect_loop.judge(ref, ims, canvas_of(i), prog, "")
        for k, v in got.items():
            numbers[k] = max(numbers.get(k, 0.0), v)
    return numbers


def control_train(cell, seed, device, quant=fp8):
    """The numbers of the reference at quant in the program's place through
    the three recorded steps of a train cell, followed by the float32
    reference as the program is."""
    from tf_faster_rcnn_torch.config import canvas_buckets
    from tf_faster_rcnn_torch.models.network import TrainNoise
    from frcnn_bench.entries import train as entry
    config, traffic = cell.config, cell.traffic
    c = config["cfg"]
    t = c["TRAIN"]
    cfg = harness.port_cfg(config)
    canvas = canvas_buckets(cfg.TRAIN)[0]
    pool = make_pool(traffic, config["num_classes"], seed, device)
    batch = int(traffic["batch"])
    params = make_weights(config, seed, device, "TRAIN")
    names = [n for n in params if trainable(config, n)]
    for n in names:
        params[n].requires_grad_(True)
    low = Reference(config, params, quant=quant)
    start = {n: params[n].detach().clone() for n in names}
    gen = torch.Generator(device=device).manual_seed(int(seed) + 1)
    a = len(c["ANCHOR_SCALES"]) * len(c["ANCHOR_RATIOS"])
    n_anchors = (canvas[0] // 16) * (canvas[1] // 16) * a
    recorded, tapped, losses, trace_v = [], [], [], {}
    for s in range(entry.RECORDED):
        idx = [(s * batch + j) % len(pool) for j in range(batch)]
        flips = [pool.flipped[k] for k in idx]
        gt, gv = entry._gt_rows(pool, idx, flips, t["SCALES"][0],
                                t["MAX_SIZE"], int(c["TPU"]["MAX_GT"]))
        noise = TrainNoise(*[torch.rand((batch, n), generator=gen,
                                        device=device)
                             for n in (n_anchors, n_anchors,
                                       t["RPN_POST_NMS_TOP_N"],
                                       t["RPN_POST_NMS_TOP_N"])])
        image, info, _ = prep_images([pool.images[k] for k in idx], canvas,
                                     t["SCALES"][0], t["MAX_SIZE"],
                                     c["PIXEL_MEANS"], device, flipped=flips)
        with torch.no_grad():
            feat = low.head(image, info)
            pairs, deltas = low.rpn(feat)
            boxes, fg, inside = low.anchor_boxes(feat, pairs, deltas, info)
            props = low.proposals(boxes, fg, inside, "TRAIN")
            tap = {"rois": props[0], "scores": props[1], "valid": props[2],
                   "deltas": deltas, "fg": fg, "im_info": info,
                   "fw": feat.shape[-1]}
        del feat, pairs
        total, got, _ = low.train_loss(
            image, info, torch.from_numpy(gt).to(device),
            torch.from_numpy(gv).to(device),
            {"anchor_fg": noise.anchor_fg, "anchor_bg": noise.anchor_bg,
             "roi_fg": noise.roi_fg, "roi_bg": noise.roi_bg},
            (props[0], props[2]))
        grads = torch.autograd.grad(total, [params[n] for n in names])
        losses.append({k: float(v.detach()) for k, v in got.items()})
        sgd_step(config, params, dict(zip(names, grads)), trace_v, s, batch)
        if s == 0:
            grad_norms = {n: float(v.norm()) for n, v in trace_v.items()}
        recorded.append({"feed": (idx, flips, gt, gv, canvas),
                         "noise": noise})
        tapped.append(tap)
    update = {n: float((params[n].detach() - start[n]).norm())
              for n in names}
    del params, low, start
    numbers, _ = entry.follow(config, seed, device, pool, recorded, tapped,
                              losses, grad_norms, update, batch, "")
    return numbers


def main():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--fault", default="",
                   help="run the --seeds under a fault of faults.py")
    args = p.parse_args()
    cell = harness.load_cell(args.workload)
    device = harness.require_cards(cell.chips)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    entry = harness.load_module("entries", cell.entry)
    lower, upper = {}, {}
    side = f"fault:{args.fault}" if args.fault else "program"
    for seed in [int(s) for s in args.seeds.split(",") if s]:
        with (FAULTS[args.fault]() if args.fault
              else contextlib.nullcontext()):
            out = entry.run(cell, seed, args.seconds, False, device)
        print(json.dumps({"side": side, "seed": seed,
                          "numbers": out["numbers"],
                          "failed": out["failed"]}), flush=True)
        for k, v in out["numbers"].items():
            lower[k] = max(lower.get(k, 0.0), v)
    control = control_train if cell.entry == "train" else control_detect
    for seed in [int(s) for s in args.control_seeds.split(",") if s]:
        got = control(cell, seed, device)
        print(json.dumps({"side": "control", "seed": seed,
                          "numbers": got}), flush=True)
        for k, v in got.items():
            upper[k] = min(upper.get(k, np.inf), v)
    print(json.dumps({"workload": cell.name, side: lower,
                      "control": upper}))


if __name__ == "__main__":
    main()
