#!/usr/bin/env python3
"""The benchmark of the PyTorch/CUDA port (``tf_faster_rcnn_torch``).

    python3 frcnn_bench/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

Runs one cell of ``BENCHMARK.json`` on the card this process finds: set-up
(weights made on the card from the seed, the image pool, the cell's shapes
warmed up), then ``--seconds`` of the measured window, then, with
``--trace 1``, a short span under ``torch.profiler``, then the comparison
of what the timed path returned with the plain float32 reference. Prints
the compared numbers beside their limits on standard error, and as the last
line of standard output one JSON object: correct, attempted, failed,
metrics (the cell's end-to-end metrics, or with --trace 1 its per-layer
ones), device, and with --trace 1 a breakdown. Exits non-zero, printing no
result, where torch finds no card or fewer than the cell asks for, where a
module of JAX or the JAX package is loaded, or where the measured program
is missing.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
# one host thread for torch's and numpy's CPU work: the loop is one client
# that launches work, and a pool of spinning threads on a shared host makes
# runs spread
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ.setdefault(_var, "1")


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def measure(args, device=None, t_start=T_START, cell=None):
    """Run the cell; returns (result dict, compared lines). device: the
    card check's device, or a given one; cell: the cell's files as loaded,
    or a given Cell (the tests pass the CPU and a cell at a small size)."""
    import torch
    from frcnn_bench import harness, profiling

    cell = cell or harness.load_cell(args.workload)
    if device is None:
        device = harness.require_cards(cell.chips)
        torch.set_num_threads(1)
    tf32 = bool(cell.config.get("tf32", False))
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    entry = harness.load_module("entries", cell.entry)
    out = entry.run(cell, args.seed, args.seconds, bool(args.trace), device)
    setup_s = out["t_window"] - t_start
    limits = cell.spec["limits"]
    numbers = out["numbers"]
    missing = sorted(set(limits) - set(numbers))
    correct = (not missing and out["compared_steps"] > 0
               and out["failed"] == 0
               and all(numbers[k] <= lim for k, lim in limits.items()))
    record = out["record"]
    if args.trace:
        metrics = {}
        units = {m["name"]: m["unit"] for m in cell.bench["per_layer"]}
        for name in cell.per_layer:
            value = harness.load_module("metrics", name).read(record)
            if value is not None:
                metrics[name] = {"value": float(value), "unit": units[name]}
    else:
        units = {m["name"]: m["unit"] for m in cell.bench["end_to_end"]}
        metrics = {}
        for name in cell.metrics:
            value = (setup_s if name == "setup_s"
                     else record[cell.spec["end_to_end"][name]])
            metrics[name] = {"value": float(value), "unit": units[name]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "count": cell.chips,
           "memory_peak_bytes": out["memory_peak_bytes"]}
    if device.type == "cuda":
        info = harness.card(device)
        dev["kind"] = info["kind"]
        dev["power_limit_w"] = info["power_limit_w"]
    else:
        dev["kind"] = "cpu"
    if args.trace and record.get("trace"):
        dev["busy_s"] = record["trace"]["busy_s"]
        dev["window_s"] = record["trace"]["window_s"]
    compared = {k: {"value": numbers.get(k), "limit": lim}
                for k, lim in limits.items()}
    result = {"correct": bool(correct), "attempted": out["attempted"],
              "failed": out["failed"], "metrics": metrics, "device": dev}
    if args.trace and record.get("trace"):
        result["breakdown"] = profiling.breakdown(record["trace"])
    result["compared"] = compared
    lines = [f"{k} {v['value']!r} limit {v['limit']!r}"
             for k, v in compared.items()]
    return result, lines


def main(argv=None, device=None):
    args = parse(argv)
    from frcnn_bench import harness
    result, lines = measure(args, device)
    found = harness.forbidden_modules()
    if found:
        print("frcnn_bench: modules of JAX or the JAX package are loaded: "
              + ", ".join(found), file=sys.stderr)
        return 3
    for line in lines:
        print(line, file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
