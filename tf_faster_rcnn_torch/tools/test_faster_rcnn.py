#!/usr/bin/env python3
"""Evaluate the newest snapshot of a driver run on its recipe's test imdb.

    python -m tf_faster_rcnn_torch.tools.test_faster_rcnn \\
        DEVICES DATASET NET \\
        [--tag TAG] [--cfg FILE] [--output-root DIR] [--device cuda] \\
        [--set KEY VALUE ...]

The port's counterpart of ``experiments/scripts/test_faster_rcnn.sh``, its
environment hooks as flags (``FRCNN_TAG`` -> --tag, ``FRCNN_CFG`` -> --cfg,
``FRCNN_OUTPUT_ROOT`` -> --output-root). DATASET is a recipe of
``tools/recipes.py``; the run it evaluates is
``<output-root>/output/<NET>/<train imdb>/<tag or 'default'>``, whose
newest ``<NET>_faster_rcnn_iter_<N>.pt`` snapshot is found by its numeric
N (a batched run's step count depends on the batch, and 'iter_800' sorts
after 'iter_1600' as text). ``tools.test_net`` then runs on it in a
subprocess, with the recipe's anchors and the extra --set pairs, its output
teed to ``experiments/logs/``. The tag defaults to the extra pairs joined
by '_'. The port evaluates on one device: DEVICES above 1 raises.
"""

import argparse
import glob
import os
import re
import sys

from tf_faster_rcnn_torch.tools.recipes import (log_path, recipe,
                                                run_logged, slug)

NETS = ("vgg16", "res50", "res101", "res152", "mobile")
_ITER = re.compile(r"_iter_(\d+)\.pt$")


def build_parser(description, train=False):
    ap = argparse.ArgumentParser(description=description)
    add = ap.add_argument
    add("devices", type=int, help="devices (the port runs on one)")
    add("dataset", help="pascal_voc | pascal_voc_0712 | coco")
    add("net", choices=NETS)
    add("--tag", default=None,
        help="run tag (default: the extra --set pairs joined by '_'; '' "
             "for none)")
    add("--cfg", dest="cfg_file", default=None,
        help="config file (default experiments/cfgs/<NET>.yml)")
    add("--output-root", default=".",
        help="the ROOT_DIR the run's output/ lives under")
    add("--device", default="cuda",
        help="torch device to run on (default cuda)")
    if train:
        add("--weight", default=None,
            help="ImageNet weights (default data/imagenet_weights/<NET>.npz;"
                 " '' trains from scratch with the JAX package's "
                 "initializers)")
        add("--iters", type=int, default=None,
            help="training length in images (default: the recipe's)")
        add("--stepsize", default=None,
            help="LR steps in images, e.g. '[50000]' (default: the "
                 "recipe's)")
    add("--set", dest="set_cfgs", default=[], nargs=argparse.REMAINDER,
        help="extra config KEY VALUE pairs")
    return ap


def resolve(args):
    """Fill the defaults that depend on the other arguments; raise where
    DEVICES asks for more than one device."""
    if args.devices > 1:
        raise SystemExit(f"DEVICES {args.devices}: the port runs on one "
                         "device (ROADMAP.md, Queue A: parallelism)")
    if len(args.set_cfgs) % 2:
        raise SystemExit("--set takes KEY VALUE pairs (got an odd count)")
    if args.tag is None:
        args.tag = slug(args.set_cfgs)
    if args.cfg_file is None:
        args.cfg_file = os.path.join("experiments", "cfgs",
                                     f"{args.net}.yml")
    return args


def newest_snapshot(rundir, net):
    """The snapshot of the highest iteration in rundir, by number."""
    snaps = [p for p in glob.glob(os.path.join(
        rundir, f"{net}_faster_rcnn_iter_*.pt")) if _ITER.search(p)]
    if not snaps:
        raise SystemExit(f"no snapshots under {rundir}")
    return max(snaps, key=lambda p: int(_ITER.search(p).group(1)))


def main(argv=None):
    args = resolve(build_parser(__doc__.splitlines()[0]).parse_args(argv))
    r = recipe(args.dataset)
    tag = f"_{args.tag}" if args.tag else ""
    log = log_path(f"test_{args.net}_{r.train_imdb}{tag}")
    rundir = os.path.join(args.output_root, "output", args.net,
                          r.train_imdb, args.tag or "default")
    snapshot = newest_snapshot(rundir, args.net)
    run_logged([sys.executable, "-m", "tf_faster_rcnn_torch.tools.test_net",
                "--imdb", r.test_imdb, "--model", snapshot,
                "--cfg", args.cfg_file, "--net", args.net,
                "--device", args.device,
                "--set", "ANCHOR_SCALES", r.scales, "ANCHOR_RATIOS",
                r.ratios] + args.set_cfgs, log)
    return snapshot


if __name__ == "__main__":
    main()
