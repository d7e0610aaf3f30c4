#!/usr/bin/env python3
"""Train (and snapshot) a Faster R-CNN detector on one or more imdbs, with
the port.

    python -m tf_faster_rcnn_torch.tools.trainval_net \\
        --cfg experiments/cfgs/res101.yml --net res101 \\
        --weight data/imagenet_weights/res101.ckpt \\
        --imdb voc_2007_trainval --imdbval voc_2007_test --iters 70000 \\
        [--device cuda] [--set KEY VALUE ...]

The flags of ``tools/trainval_net.py`` (--cfg --weight --imdb --imdbval
--iters --tag --net --devices --coordinator --num-procs --proc-id --set),
with '+'-joined imdb names training on the concatenated roidbs, and
``--device`` (default ``cuda``; the tests pass ``cpu``). --weight is a slim
var dict (.npz/.pkl) or a TF .ckpt bundle prefix. The run resumes from the
newest snapshot in its output dir, so the same command continues a run that
was preempted. TF32 is off: a float32 compute dtype runs float32
convolutions.

Data parallel (``parallel/launch.py``): ``--devices N`` starts N ranks on
this host, one GPU each (0 = every GPU; fewer GPUs than N is an error), or N
gloo processes with ``--device cpu``; the multi-host flags make this
process one rank of a run across hosts (or the FRCNN_COORDINATOR,
FRCNN_NUM_PROCS and FRCNN_PROC_ID variables). The global batch is
TPU.IMS_PER_DEVICE times the data groups: TPU.MODEL_DEVICES m above 1
(m dividing the ranks; single-host only) lays the N ranks out as an (N / m,
m) mesh, whose model groups train each batch together, the RoI head tensor
parallel and, under TPU.SPATIAL_PARTITION, the backbone head on each
rank's rows of the canvas (``engine/train_loop.py``).
"""

import argparse
import pprint
import sys

import numpy as np
import torch

from tf_faster_rcnn_torch.parallel.launch import (launch, model_devices,
                                                  rank_device)

NETS = ("vgg16", "res50", "res101", "res152", "mobile")


def build_parser():
    ap = argparse.ArgumentParser(description="Train a Faster R-CNN network")
    add = ap.add_argument
    add("--cfg", dest="cfg_file", default=None, help="optional config file")
    add("--weight", default=None,
        help="pretrained weights: TF .ckpt bundle or slim var dict .npz/.pkl")
    add("--imdb", dest="imdb_name", default="voc_2007_trainval",
        help="dataset(s) to train on, '+'-joined")
    add("--imdbval", dest="imdbval_name", default="voc_2007_test",
        help="dataset to validate on")
    add("--iters", dest="max_iters", default=70000, type=int,
        help="training length in images (reference iteration units)")
    add("--tag", default=None, help="experiment tag (output subdir)")
    add("--net", default="res50", choices=NETS)
    add("--devices", default=0, type=int,
        help="data-parallel devices on this host (0 = all available)")
    add("--coordinator", default=None,
        help="multi-host coordinator host:port (or env FRCNN_COORDINATOR)")
    add("--num-procs", dest="num_procs", default=None, type=int,
        help="multi-host: total process count")
    add("--proc-id", dest="proc_id", default=None, type=int,
        help="multi-host: this process id")
    add("--device", default="cuda",
        help="torch device to train on (default cuda)")
    add("--set", dest="set_cfgs", default=None, nargs=argparse.REMAINDER,
        help="dotted config overrides")
    return ap


def load_training_roidbs(joined_names):
    """(imdb, roidb) for '+'-joined imdb names: for one name the imdb
    itself; for several, a bare imdb carrying the joined name and the shared
    class list, with the concatenated roidbs (reference trainval_net.py:
    63-85)."""
    from tf_faster_rcnn_torch.config import cfg
    from tf_faster_rcnn_torch.datasets.factory import get_imdb
    from tf_faster_rcnn_torch.engine.train_loop import get_training_roidb

    names = joined_names.split("+")
    roidb, ds = [], None
    for name in names:
        ds = get_imdb(name)
        print("Loaded dataset `{:s}`".format(ds.name))
        ds.set_proposal_method(cfg.TRAIN.PROPOSAL_METHOD)
        print("Set proposal method: {:s}".format(cfg.TRAIN.PROPOSAL_METHOD))
        roidb.extend(get_training_roidb(ds))

    if len(names) == 1:
        return ds, roidb
    from tf_faster_rcnn_torch.datasets.imdb import imdb as imdb_shell
    return imdb_shell(joined_names, ds.classes), roidb


def main(argv=None):
    if argv is None and len(sys.argv) == 1:
        build_parser().print_help()
        sys.exit(1)
    args = build_parser().parse_args(argv)
    print("Called with args:")
    print(args)
    return launch(args, run, model_devices(args))


def run(args):
    """Train with the parsed flags in this process: one rank of a process
    group under the multi-host flags (or their variables), else alone."""
    from tf_faster_rcnn_torch.config import (cfg, cfg_from_file,
                                             cfg_from_list, get_output_dir,
                                             get_output_tb_dir)
    from tf_faster_rcnn_torch.parallel import dist
    if args.cfg_file is not None:
        cfg_from_file(args.cfg_file)
    if args.set_cfgs is not None:
        cfg_from_list(args.set_cfgs)
    device = rank_device(args)
    dist.initialize(args.coordinator, args.num_procs, args.proc_id,
                    device=device)
    try:
        if dist.is_initialized():
            print(f"Training: rank {dist.process_index()} of "
                  f"{dist.process_count()} on {device}")
        print("Using config:")
        pprint.pprint(cfg)
        np.random.seed(cfg.RNG_SEED)
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False

        imdb, roidb = load_training_roidbs(args.imdb_name)
        print("{:d} roidb entries".format(len(roidb)))

        output_dir = get_output_dir(imdb, args.tag)
        print("Output will be saved to `{:s}`".format(output_dir))
        tb_dir = get_output_tb_dir(imdb, args.tag)
        print("Metrics will be saved to `{:s}`".format(tb_dir))

        # the validation roidb is never flip-augmented
        saved_flip, cfg.TRAIN.USE_FLIPPED = cfg.TRAIN.USE_FLIPPED, False
        try:
            valimdb, valroidb = load_training_roidbs(args.imdbval_name)
        finally:
            cfg.TRAIN.USE_FLIPPED = saved_flip
        print("{:d} validation roidb entries".format(len(valroidb)))

        from tf_faster_rcnn_torch.engine.train_loop import train_net
        return train_net(args.net, imdb, roidb, valroidb, output_dir, tb_dir,
                         pretrained_model=args.weight,
                         max_iters=args.max_iters, valimdb=valimdb,
                         device=device)
    finally:
        dist.shutdown()


if __name__ == "__main__":
    main()
