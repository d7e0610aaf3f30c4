#!/usr/bin/env python3
"""Train on a dataset recipe, then evaluate the run's newest snapshot.

    python -m tf_faster_rcnn_torch.tools.train_faster_rcnn \\
        DEVICES DATASET NET \\
        [--weight FILE] [--iters N] [--stepsize '[N]'] [--tag TAG] \\
        [--cfg FILE] [--output-root DIR] [--device cuda] \\
        [--coordinator HOST:PORT --num-procs N --proc-id I] \\
        [--set KEY VALUE ...]

The port's counterpart of ``experiments/scripts/train_faster_rcnn.sh``,
its environment hooks as flags (``FRCNN_TAG`` -> --tag, ``FRCNN_CFG`` ->
--cfg, ``FRCNN_WEIGHT`` -> --weight, ``FRCNN_ITERS`` -> --iters,
``FRCNN_STEPSIZE`` -> --stepsize, ``FRCNN_OUTPUT_ROOT`` -> --output-root).
DATASET is a recipe of ``tools/recipes.py`` (pascal_voc, pascal_voc_0712,
coco). ``tools.trainval_net`` runs in a subprocess on the recipe's train
imdb(s) for its image budget, with its anchors and LR steps and the extra
--set pairs, its output teed to ``experiments/logs/``; then
``tools.test_faster_rcnn`` evaluates the newest snapshot. ``--weight ''``
trains from scratch: every tensor drawn by the JAX package's initializers
(``models/init.py::reference_init``). DEVICES goes to both stages as
``--devices``: DEVICES ranks on this host, one GPU each (gloo processes
with ``--device cpu``); more than the host's GPUs raises here. The
multi-host flags (``--coordinator``, ``--num-procs``, ``--proc-id``) go to
both stages as given; each process is then one rank, so DEVICES above 1 with
them raises here.
"""

import os
import sys

from tf_faster_rcnn_torch.tools import test_faster_rcnn
from tf_faster_rcnn_torch.tools.recipes import (log_path, recipe,
                                                run_logged)


def main(argv=None):
    args = test_faster_rcnn.resolve(test_faster_rcnn.build_parser(
        __doc__.splitlines()[0], train=True).parse_args(argv))
    r = recipe(args.dataset, args.iters, args.stepsize)
    weight = args.weight
    if weight is None:
        weight = os.path.join("data", "imagenet_weights", f"{args.net}.npz")
    tag = f"_{args.tag}" if args.tag else ""
    log = log_path(f"train_{args.net}_{r.train_imdb}{tag}")
    run_logged([sys.executable, "-m",
                "tf_faster_rcnn_torch.tools.trainval_net",
                "--weight", weight, "--imdb", r.train_imdb,
                "--imdbval", r.test_imdb, "--iters", str(r.iters),
                "--cfg", args.cfg_file, "--net", args.net,
                "--devices", str(args.devices), "--device", args.device]
               + test_faster_rcnn.multihost_flags(args)
               + (["--tag", args.tag] if args.tag else [])
               + ["--set", "ANCHOR_SCALES", r.scales, "ANCHOR_RATIOS",
                  r.ratios, "TRAIN.STEPSIZE", r.stepsize] + args.set_cfgs,
               log)
    return test_faster_rcnn.main(
        [str(args.devices), args.dataset, args.net, "--tag", args.tag,
         "--cfg", args.cfg_file, "--output-root", args.output_root,
         "--device", args.device] + test_faster_rcnn.multihost_flags(args)
        + ["--set"] + args.set_cfgs)


if __name__ == "__main__":
    main()
