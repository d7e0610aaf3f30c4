"""What every entry of the benchmark shares: the cell's files, found by
name; the card check; the measured program's configuration, model and
weights; the tap that keeps the program's outputs on the sampled steps; the
JAX check.

Files, all under ``frcnn_bench/`` and named after ``BENCHMARK.json``:
``workloads/<cell>.json`` (entry, sample, limits), ``configs/<config>.json``
(sizes, settings, layer table), ``traffic/<traffic>.json`` (the mix),
``entries/<entry>.py`` (the loop the window drives), ``metrics/<name>.py``
(one reader per per-layer metric).
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import subprocess
import sys
from typing import Optional

import numpy as np

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
# top-level module names that no process of the benchmark may hold
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "tf_faster_rcnn_tpu")

__all__ = ["Cell", "load_cell", "load_module", "require_cards",
           "forbidden_modules", "card", "port_cfg", "build_program",
           "Tap", "FORBIDDEN", "ROOT", "BENCH_DIR"]


def load_json(path):
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    """One cell of BENCHMARK.json with the files it names."""
    name: str
    chips: int
    entry: str
    spec: dict        # workloads/<cell>.json
    config: dict      # configs/<config>.json
    traffic: dict     # traffic/<traffic>.json
    metrics: list     # end-to-end metric names this cell reports
    per_layer: list   # per-layer metric names this cell reports
    bench: dict       # BENCHMARK.json


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: str = ROOT) -> Cell:
    """The cell called name, from BENCHMARK.json and the files it names."""
    bench = load_json(os.path.join(root, "BENCHMARK.json"))
    rows = [w for w in bench["workloads"] if w["name"] == name]
    if not rows:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    row = rows[0]
    configs = {c["name"]: c for c in bench["configs"]}
    spec = load_json(os.path.join(BENCH_DIR, "workloads", f"{name}.json"))
    config = load_json(os.path.join(root, configs[row["config"]]["file"]))
    traffic = load_json(os.path.join(BENCH_DIR, "traffic",
                                     f"{row['traffic']}.json"))
    e2e = [m["name"] for m in bench["end_to_end"] if _reports(m, name)]
    layer = [m["name"] for m in bench["per_layer"] if _reports(m, name)]
    return Cell(name, int(row["chips"]), spec["entry"], spec, config,
                traffic, e2e, layer, bench)


def load_module(kind: str, name: str):
    """frcnn_bench/<kind>/<name>.py as a module (names may hold dots)."""
    path = os.path.join(BENCH_DIR, kind, f"{name}.py")
    mod_spec = importlib.util.spec_from_file_location(
        f"frcnn_bench_{kind}_{name.replace('.', '_').replace('-', '_')}",
        path)
    module = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(module)
    return module


def require_cards(count: int):
    """The first CUDA device, or SystemExit when torch sees no card or
    fewer than the cell asks for. Nothing falls back to the CPU."""
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("frcnn_bench: torch.cuda.is_available() is False; "
                         "the benchmark runs on an NVIDIA GPU only")
    if torch.cuda.device_count() < count:
        raise SystemExit(f"frcnn_bench: the cell needs {count} cards, torch "
                         f"sees {torch.cuda.device_count()}")
    return torch.device("cuda", 0)


def forbidden_modules(modules=None) -> list:
    """Loaded modules whose top-level name is one of FORBIDDEN, compared
    whole: the port's own name begins with the JAX package's."""
    modules = sys.modules if modules is None else modules
    return sorted({m for m in modules if m.split(".")[0] in FORBIDDEN})


def card(device) -> dict:
    """The card's name and its power limit in W (nvidia-smi; None where it
    cannot be read)."""
    import torch
    info = {"kind": torch.cuda.get_device_name(device)}
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, check=True)
        info["power_limit_w"] = float(smi.stdout.split()[0])
    except (OSError, subprocess.CalledProcessError, ValueError,
            IndexError):
        info["power_limit_w"] = None
    return info


def port_cfg(config: dict):
    """Set the port's global cfg to the configuration's settings: its
    defaults, then each key of config['cfg'] (a list where the default is
    a tuple, PIXEL_MEANS as the [1, 1, 3] array the port keeps)."""
    from tf_faster_rcnn_torch.config import cfg, reset_cfg
    reset_cfg()

    def merge(src, dst, path):
        for key, value in src.items():
            if key not in dst:
                raise KeyError(f"the port's cfg has no key {path}{key}")
            if isinstance(value, dict):
                merge(value, dst[key], f"{path}{key}.")
            elif key == "PIXEL_MEANS":
                dst[key] = np.asarray(value, np.float64).reshape(1, 1, 3)
            elif isinstance(dst[key], tuple):
                dst[key] = tuple(value)
            elif isinstance(dst[key], float):
                dst[key] = float(value)
            else:
                dst[key] = value
    merge(config["cfg"], cfg, "")
    return cfg


def build_program(config: dict, mode: str, weights: dict, device):
    """(model, spec) of the port in mode ('TEST' or 'TRAIN'), built from
    the port's cfg as port_cfg set it, with the benchmark's weights loaded
    through load_state_dict (strict: every name and shape must match)."""
    from tf_faster_rcnn_torch.models.network import FasterRCNN, spec_from_cfg
    spec = spec_from_cfg(config["backbone"], config["num_classes"], mode)
    model = FasterRCNN(spec, device=device)
    model.load_state_dict(weights, strict=True)
    return model, spec


class Tap:
    """A forward hook on the program's model that keeps a copy of its
    output dict on the step armed for the comparison; other steps pass
    through untouched."""

    KEYS = ("rpn_cls_score", "rpn_bbox_pred", "rois", "roi_scores",
            "roi_valid", "cls_score", "bbox_pred")

    def __init__(self, model):
        self.armed: Optional[int] = None
        self.kept = {}
        self.handle = model.register_forward_hook(self._hook)

    def _hook(self, module, args, out):
        if self.armed is None:
            return
        self.kept[self.armed] = {k: out[k].detach().clone()
                                 for k in self.KEYS if out.get(k) is not None}
        self.armed = None

    def close(self):
        self.handle.remove()
