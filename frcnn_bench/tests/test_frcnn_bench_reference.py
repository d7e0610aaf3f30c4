"""The plain reference against the measured program on the CPU: at float32
compute the program's outputs, taken by the harness's own run, must sit on
the reference's to rounding; the greedy NMS against a loop."""

import itertools

import numpy as np
import pytest
import torch

from frcnn_bench_tiny import tiny
from frcnn_bench import harness
from frcnn_bench.reference.nms import first_kept, greedy_keep, iou

SEED = 2**31 + 11     # larger than 32 signed bits hold, as the driver's


@pytest.mark.parametrize("name", ["res101-voc-detect-b8",
                                  "vgg16-voc-detect-b1",
                                  "vgg16-voc-detect-b8"])
def test_detect_path_equals_reference_at_float32(name):
    cell = tiny(name, compute_dtype="float32")
    out = harness.load_module("entries", cell.entry).run(
        cell, SEED, 0.5, False, torch.device("cpu"))
    assert out["compared_steps"] >= 1 and out["failed"] == 0
    for key, value in out["numbers"].items():
        assert value <= 1e-5, (key, value)


def test_train_steps_equal_reference_at_float32():
    cell = tiny("res101-voc-train-b8", compute_dtype="float32")
    out = harness.load_module("entries", "train").run(
        cell, SEED, 0.5, False, torch.device("cpu"))
    assert out["compared_steps"] == 3 and out["failed"] == 0
    # three float32 steps whose CPU reductions run in an order that varies
    # with the threads: the update of a small leaf reads up to ~5e-5 (the
    # bf16 program reads ~1e-2 on the card)
    for key, value in out["numbers"].items():
        assert value <= 1e-4, (key, value)


def _loop_nms(boxes, valid, thresh, plus_one):
    keep = []
    for i in range(len(boxes)):
        if not valid[i]:
            keep.append(False)
            continue
        ok = all(not (keep[j] and float(iou(boxes[j:j + 1], boxes[i:i + 1],
                                                plus_one)[0, 0]) > thresh)
                 for j in range(i))
        keep.append(ok)
    return torch.tensor(keep)


@pytest.mark.parametrize("seed,plus_one", itertools.product(range(4),
                                                            [False, True]))
def test_greedy_keep_equals_a_loop(seed, plus_one):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, 80, (3, 60, 2))
    wh = rng.uniform(4, 40, (3, 60, 2))
    boxes = torch.tensor(np.concatenate([xy, xy + wh], -1), dtype=torch.float32)
    valid = torch.tensor(rng.uniform(size=(3, 60)) > 0.1)
    keep = greedy_keep(boxes, valid, 0.5, plus_one)
    for g in range(3):
        assert torch.equal(keep[g], _loop_nms(boxes[g], valid[g], 0.5,
                                              plus_one))
    idx, ok = first_kept(keep, 7)
    for g in range(3):
        want = torch.nonzero(keep[g])[:7, 0]
        assert torch.equal(idx[g][ok[g]], want)
