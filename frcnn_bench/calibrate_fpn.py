#!/usr/bin/env python3
"""The two readings of a feature-pyramid cell's compared numbers, and the
limits they give (``calibrate.py``'s method for the families the
reference of ``reference/fpn.py`` builds).

    python3 frcnn_bench/calibrate_fpn.py --workload <cell> --seeds 1,2,...
        [--control-seeds 7,8,9] [--seconds 3]

Lower reading: the cell run as the benchmark runs it (a short window), on
each seed of --seeds. Upper reading: the control, on each of
--control-seeds: the reference in the program's place with every
convolution's and matrix product's inputs and weights rounded to float8
e4m3 (one precision below the configuration's bfloat16), judged as the
program's outputs are, on the sampled steps of that seed's run. Prints one
JSON line per run and, last, the largest lower reading, the smallest upper
reading, and each continuous number's limit lower^0.4 x upper^0.6 rounded
to two places (the exact replays keep the limit 0). Not run by the
benchmark's own runs.
"""

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from frcnn_bench import detect_loop, harness  # noqa: E402
from frcnn_bench.reference.fpn import FPNReference, make_weights  # noqa: E402
from frcnn_bench.reference.model import fp8  # noqa: E402
from frcnn_bench.traffic.scenes import make_pool  # noqa: E402

EXACT = ("proposal_replay", "det_replay")


def control(cell, seed, device, quant=fp8):
    """The numbers of the reference at quant in the program's place, on
    the sampled steps of seed's run."""
    from tf_faster_rcnn_torch.config import bucket_index, canvas_buckets
    entry = harness.load_module("entries", cell.entry)
    config, traffic = cell.config, cell.traffic
    cfg = harness.port_cfg(config)
    buckets = canvas_buckets(cfg.TEST)
    pool = make_pool(traffic, config["num_classes"], seed, device)
    batch = int(traffic["batch"])
    weights = make_weights(config, seed, device)
    ref = FPNReference(config, weights)
    low = FPNReference(config, weights, quant=quant)

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
        prog = entry.control_outputs(low, ims, canvas_of(i), device)
        got, _ = entry.judge(ref, ims, canvas_of(i), prog, "")
        for k, v in got.items():
            numbers[k] = max(numbers.get(k, 0.0), v)
    return numbers


def limits(lower, upper):
    """Each number's limit from its two readings."""
    out = {}
    for k in lower:
        if k in EXACT:
            out[k] = 0.0
        elif k in upper:
            out[k] = round(lower[k] ** 0.4 * upper[k] ** 0.6, 2)
    return out


def main():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=3.0)
    args = p.parse_args()
    cell = harness.load_cell(args.workload)
    device = harness.require_cards(cell.chips)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    entry = harness.load_module("entries", cell.entry)
    lower, upper = {}, {}
    for seed in [int(s) for s in args.seeds.split(",") if s]:
        out = entry.run(cell, seed, args.seconds, False, device)
        print(json.dumps({"side": "program", "seed": seed,
                          "numbers": out["numbers"],
                          "failed": out["failed"]}), flush=True)
        for k, v in out["numbers"].items():
            lower[k] = max(lower.get(k, 0.0), v)
    for seed in [int(s) for s in args.control_seeds.split(",") if s]:
        got = control(cell, seed, device)
        print(json.dumps({"side": "control", "seed": seed,
                          "numbers": got}), flush=True)
        for k, v in got.items():
            upper[k] = min(upper.get(k, np.inf), v)
    print(json.dumps({"workload": cell.name, "program": lower,
                      "control": upper, "limits": limits(lower, upper)}))


if __name__ == "__main__":
    main()
