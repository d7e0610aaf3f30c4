#!/usr/bin/env python3
"""Evaluate the newest snapshot of a driver run on its recipe's test imdb.

    python -m tf_faster_rcnn_torch.tools.test_faster_rcnn \\
        DEVICES DATASET NET \\
        [--tag TAG] [--cfg FILE] [--output-root DIR] [--device cuda] \\
        [--coordinator HOST:PORT --num-procs N --proc-id I] \\
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
by '_'. DEVICES goes to ``tools.test_net --devices``: DEVICES ranks on this
host, one GPU each (gloo processes with ``--device cpu``); more than the
host's GPUs raises here. The multi-host flags (``--coordinator``,
``--num-procs``, ``--proc-id``) go to it as given; each process is then one
rank, so DEVICES above 1 with them raises here.
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
    add("devices", type=int,
        help="data-parallel devices on this host (0 = all GPUs)")
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
    add("--coordinator", default=None,
        help="multi-host coordinator host:port (or env FRCNN_COORDINATOR)")
    add("--num-procs", dest="num_procs", default=None, type=int,
        help="multi-host: total process count")
    add("--proc-id", dest="proc_id", default=None, type=int,
        help="multi-host: this process id")
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
    DEVICES asks for more GPUs than this host has, or for more than one
    with the multi-host flags (each process is then one rank)."""
    from tf_faster_rcnn_torch.parallel.launch import local_ranks
    try:
        local_ranks(args)
    except SystemExit as e:
        raise SystemExit(f"DEVICES {args.devices}: {e}") from None
    if len(args.set_cfgs) % 2:
        raise SystemExit("--set takes KEY VALUE pairs (got an odd count)")
    if args.tag is None:
        args.tag = slug(args.set_cfgs)
    if args.cfg_file is None:
        args.cfg_file = os.path.join("experiments", "cfgs",
                                     f"{args.net}.yml")
    return args


def multihost_flags(args):
    """The multi-host flags given, as arguments of the CLIs."""
    out = []
    for flag, value in (("--coordinator", args.coordinator),
                        ("--num-procs", args.num_procs),
                        ("--proc-id", args.proc_id)):
        if value is not None:
            out += [flag, str(value)]
    return out


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
                "--devices", str(args.devices), "--device", args.device]
               + multihost_flags(args)
               + ["--set", "ANCHOR_SCALES", r.scales, "ANCHOR_RATIOS",
                  r.ratios] + args.set_cfgs, log)
    return snapshot


if __name__ == "__main__":
    main()
