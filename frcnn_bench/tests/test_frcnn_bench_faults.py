"""A run of the benchmark, with its look for a card skipped, on a cell cut
to a CPU test's size: sound, it comes out correct; with the timed path
broken underneath, or with the lower-precision control in the program's
place, it does not. The program runs at float32 here, where it sits on the
reference to rounding, so that a small cell's few proposals and
detections cannot blur what a fault does; the limits are the cells' own."""

import argparse

import pytest
import torch

from frcnn_bench_tiny import tiny
import frcnn_bench.run as bench_run
from frcnn_bench import calibrate
from frcnn_bench.faults import FAULTS
from frcnn_bench.reference.model import fp8

SEED = 2**31 + 29
CPU = torch.device("cpu")
DETECT = ["res101-voc-detect-b8", "vgg16-voc-detect-b1",
          "vgg16-voc-detect-b8"]


def _measure(name):
    cell = tiny(name, compute_dtype="float32")
    args = argparse.Namespace(workload=name, seed=SEED, seconds=0.5,
                              trace=0)
    result, lines = bench_run.measure(args, device=CPU, cell=cell)
    assert len(lines) == len(cell.spec["limits"])
    return result


@pytest.mark.parametrize("name", DETECT + ["res101-voc-train-b8"])
def test_sound_run_is_correct(name):
    assert _measure(name)["correct"]


@pytest.mark.parametrize("name", DETECT)
def test_an_altered_answer_is_not_correct(name):
    with FAULTS["altered_answer"]():
        assert not _measure(name)["correct"]


@pytest.mark.parametrize("name", ["res101-voc-detect-b8",
                                  "vgg16-voc-detect-b8"])
def test_half_the_batch_left_out_is_not_correct(name):
    with FAULTS["half_batch_detect"]():
        assert not _measure(name)["correct"]


def test_a_step_that_leaves_the_state_unchanged_is_not_correct():
    with FAULTS["unchanged_state"]():
        assert not _measure("res101-voc-train-b8")["correct"]


def test_half_the_training_batch_left_out_is_not_correct():
    with FAULTS["half_batch_train"]():
        assert not _measure("res101-voc-train-b8")["correct"]


@pytest.mark.parametrize("name", DETECT)
def test_the_fp8_control_is_not_correct(name):
    cell = tiny(name)
    numbers = calibrate.control_detect(cell, SEED, CPU, quant=fp8)
    limits = cell.spec["limits"]
    assert any(numbers[k] > lim for k, lim in limits.items()), numbers


def test_the_fp8_control_is_not_correct_in_training():
    cell = tiny("res101-voc-train-b8")
    numbers = calibrate.control_train(cell, SEED, CPU, quant=fp8)
    limits = cell.spec["limits"]
    assert any(numbers[k] > lim for k, lim in limits.items()), numbers
