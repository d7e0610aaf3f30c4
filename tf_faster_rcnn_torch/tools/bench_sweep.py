#!/usr/bin/env python3
"""Detect throughput of the bench workload over batch sizes and backbones on
one NVIDIA GPU: the port's counterpart of the JAX package's
``tools/bench_sweep.py``, which picked the bench's batch.

    python3 tf_faster_rcnn_torch/tools/bench_sweep.py [--batches 4,8,16,32]
        [--iters 20] [--net res101] [--s2d 0] [--cfg YML]

For each batch B, ``bench.py``'s detect step in this directory
(``detect_workload``: net in TEST mode, bfloat16 compute, TF32 off, 6000 ->
300 proposals on 608x1024, or with --cfg that YAML's TEST counts and first
canvas bucket), on B images of scaled noise (``randn * 40`` at seed 0, as
``bench_sweep.py:50-51``) with the extent h*600//608 by w*1000//1024 at
scale 1.6: 3 warm-up steps, then 4 windows of --iters steps, each on the
host clock from a synchronize to another, and the median window (the JAX
tool keeps the best of 4 on-device loops; ``bench.py`` says why). --s2d 1
sets TPU.SPACE_TO_DEPTH, which the port refuses (it runs the plain stem).

Prints the card's name and power limit, that TF32 is off, each batch's
windows, and one JSON line per batch with the JAX tool's keys: net, batch,
s2d, cfg and images_per_sec. Runs on the card only; the tests call
``measure(..., device="cpu")``.
"""

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

def measure(batch, iters, warmup=3, reps=4, canvas=(608, 1024),
            net="res101", s2d=False, cfg_file=None, device=None):
    """One batch size's line: {"net", "batch", "s2d", "cfg",
    "images_per_sec"} over reps windows of iters detect steps."""
    from tf_faster_rcnn_torch.tools import bench
    dev = bench.device_for(device)
    _, _, detect, inputs = bench.detect_workload(
        net, batch, "%d,%d" % canvas, cfg_file, bench.noise, s2d, dev)
    seconds = bench.time_windows(lambda: detect(*inputs), iters, reps,
                                 warmup, dev)
    dt = bench.median_window(f"detect {net}", batch, iters, seconds, dev)
    return {"net": net, "batch": batch, "s2d": bool(s2d), "cfg": cfg_file,
            "images_per_sec": batch * iters / dt}


def main():
    sys.path.insert(0, ROOT)
    from tf_faster_rcnn_torch.tools.bench import (card_line, device_for,
                                                  tf32_off)
    from tf_faster_rcnn_torch.tools.train_profile import NETS
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--batches", default="4,8,16,32")
    parser.add_argument("--iters", type=int, default=20)
    parser.add_argument("--net", default="res101", choices=NETS)
    parser.add_argument("--s2d", type=int, default=0,
                        help="TPU.SPACE_TO_DEPTH: refused (the port runs the "
                             "plain stem)")
    parser.add_argument("--cfg", default=None,
                        help="yml config; uses its TEST canvas/proposal "
                             "counts")
    args = parser.parse_args()
    device_for()
    print(card_line())
    tf32_off()
    for b in [int(x) for x in args.batches.split(",")]:
        print(json.dumps(measure(b, args.iters, net=args.net,
                                 s2d=bool(args.s2d), cfg_file=args.cfg)),
              flush=True)


if __name__ == "__main__":
    main()
