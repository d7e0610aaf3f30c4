"""BENCHMARK.json and the files it names: every cell, configuration,
traffic mix, entry and per-layer metric found by name; names and units in
the allowed characters; the JAX check by whole top-level names; no result
without a card or without the measured program."""

import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from frcnn_bench_tiny import ROOT
from frcnn_bench import harness

BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_exact_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    names = [x["name"] for key in ("configs", "workloads", "end_to_end",
                                   "per_layer") for x in BENCH[key]]
    assert len(names) == len(set(names))
    for name in names:
        assert NAME.match(name), name
    for w in BENCH["workloads"]:
        assert NAME.match(w["traffic"]) and w["chips"] in (1, 4)
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    assert 1 <= BENCH["run_seconds"] <= 51


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_is_found_by_name(cell):
    c = harness.load_cell(cell)
    assert hasattr(harness.load_module("entries", c.entry), "run")
    assert "setup_s" in c.metrics and len(c.metrics) >= 2 and c.per_layer
    for name, key in c.spec["end_to_end"].items():
        assert name in c.metrics and isinstance(key, str)
    assert c.spec["limits"]


@pytest.mark.parametrize("metric", BENCH["per_layer"],
                         ids=[m["name"] for m in BENCH["per_layer"]])
def test_every_metric_has_a_reader_and_its_cells_report_what_it_moves(metric):
    assert callable(harness.load_module("metrics", metric["name"]).read)
    moved = [m for m in BENCH["end_to_end"] if m["name"] == metric["moves"]]
    assert moved
    for cell in metric["workloads"]:
        c = harness.load_cell(cell)
        assert metric["moves"] in c.metrics and metric["name"] in c.per_layer


def test_each_config_file_lies_under_paths_and_is_its_own():
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))
    for f in files:
        assert f.startswith(BENCH["paths"][0] + "/")
        assert json.load(open(os.path.join(ROOT, f)))["source"]


def test_jax_check_compares_whole_top_level_names():
    mods = {"tf_faster_rcnn_torch.models": 1, "jaxtyping": 1, "flaxen": 1}
    assert harness.forbidden_modules(mods) == []
    mods.update({"jax.numpy": 1, "tf_faster_rcnn_tpu": 1})
    assert harness.forbidden_modules(mods) == ["jax.numpy",
                                               "tf_faster_rcnn_tpu"]


def _run(cwd, env_extra=None):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", **(env_extra or {}))
    return subprocess.run(
        [sys.executable, "frcnn_bench/run.py", "--workload",
         "res101-voc-detect-b8", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=cwd, capture_output=True, text=True, env=env,
        timeout=600)


def test_run_refuses_without_a_card():
    proc = _run(ROOT)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""


def test_run_fails_with_only_the_benchmark_files(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "frcnn_bench"),
                    tmp_path / "frcnn_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = _run(tmp_path)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""


@pytest.mark.cuda
def test_a_cell_runs_on_the_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    proc = subprocess.run(
        [sys.executable, "frcnn_bench/run.py", "--workload",
         "vgg16-voc-detect-b1", "--seed", "2147483659", "--seconds", "2",
         "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        timeout=900)
    assert proc.returncode == 0, proc.stderr[-4000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"
