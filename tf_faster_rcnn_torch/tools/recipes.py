"""The dataset recipes of the experiment drivers, and their helpers.

The port's copy of ``experiments/scripts/recipes.sh`` (which the shell
drivers of the JAX package source): the reference's published schedules,
counted in images (the engine's ``scale_recipe`` re-derives the step count
and learning rate at any global batch), the anchor sweep per dataset, the
run tag made from the extra ``--set`` pairs (``slug``), and the log that
tees a driver's output under ``experiments/logs/`` (``run_logged``).
"""

from __future__ import annotations

import os
import subprocess
import sys
import time
from typing import NamedTuple, Optional, Sequence

__all__ = ["Recipe", "RECIPES", "recipe", "slug", "log_path", "run_logged"]

LOG_DIR = os.path.join("experiments", "logs")


class Recipe(NamedTuple):
    """One dataset's recipe. iters and stepsize are in images; stepsize,
    scales and ratios are the ``--set`` values the drivers pass."""
    train_imdb: str
    test_imdb: str
    iters: int
    stepsize: str
    scales: str = "[8,16,32]"
    ratios: str = "[0.5,1,2]"
    num_classes: int = 21


RECIPES = {
    "pascal_voc": Recipe("voc_2007_trainval", "voc_2007_test", 70000,
                         "[50000]"),
    "pascal_voc_0712": Recipe("voc_2007_trainval+voc_2012_trainval",
                              "voc_2007_test", 110000, "[80000]"),
    "coco": Recipe("coco_2014_train+coco_2014_valminusminival",
                   "coco_2014_minival", 490000, "[350000]",
                   scales="[4,8,16,32]", num_classes=81),
}


def recipe(name: str, iters: Optional[int] = None,
           stepsize: Optional[str] = None) -> Recipe:
    """The recipe of dataset name, its schedule shortened by iters and
    stepsize when given (the rehearsal's hooks)."""
    if name not in RECIPES:
        raise SystemExit(f"unknown dataset '{name}' (expected "
                         f"{'|'.join(RECIPES)})")
    r = RECIPES[name]
    return r._replace(iters=r.iters if iters is None else int(iters),
                      stepsize=stepsize or r.stepsize)


def slug(extra: Sequence[str]) -> str:
    """A run tag from the extra --set arguments: joined by '_'."""
    return "_".join(extra)


def log_path(name: str) -> str:
    """experiments/logs/<name>.<date>.log, under the working directory."""
    os.makedirs(LOG_DIR, exist_ok=True)
    return os.path.join(LOG_DIR,
                        f"{name}.{time.strftime('%Y-%m-%d_%H-%M-%S')}.log")


def run_logged(cmd: Sequence[str], log: str):
    """Run cmd, its output and errors teed to stdout and appended to log;
    raise CalledProcessError when it fails."""
    print(f"logging to {log}", flush=True)
    env = dict(os.environ, PYTHONUNBUFFERED="True")
    with open(log, "a") as f:
        f.write("+ " + " ".join(cmd) + "\n")
        proc = subprocess.Popen(list(cmd), stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True, env=env)
        for line in proc.stdout:
            sys.stdout.write(line)
            f.write(line)
        rc = proc.wait()
    sys.stdout.flush()
    if rc:
        raise subprocess.CalledProcessError(rc, list(cmd))
