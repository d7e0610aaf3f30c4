#!/usr/bin/env python3
"""Test a Faster R-CNN network on an image database, with the port.

    python -m tf_faster_rcnn_torch.tools.test_net \\
        --cfg experiments/cfgs/res101.yml --net res101 --imdb voc_2007_test \\
        --model WEIGHTS [--device cuda] [--set KEY VALUE ...]

The flags of ``tools/test_net.py`` (--cfg --model --imdb --comp --num_dets
--tag --net --set), run on one device: ``--device`` (default ``cuda``; the
tests pass ``cpu``). --model is the port's ``save_params`` file (``.pt``), a
``.msgpack`` that the JAX package wrote (its ``save_params`` export or a
training snapshot), a training snapshot of the port (``*_iter_N.pt``),
or, as the JAX CLI takes them, a TF ``.ckpt`` bundle prefix or a slim var
dict (``.npz``/``.pkl``) through the slim import (``utils/slim_import.py``;
what it lacks keeps the RNG_SEED draw). Without it the weights are drawn
from RNG_SEED by the JAX package's initializers
(``models/init.py::reference_init``), as the reference tests with random
weights. TF32 is off: a float32 compute dtype runs float32 convolutions.
"""

import argparse
import pprint
import sys

import torch

from tf_faster_rcnn_torch.config import cfg, cfg_from_file, cfg_from_list
from tf_faster_rcnn_torch.datasets.factory import get_imdb
from tf_faster_rcnn_torch.engine.test_engine import test_net
from tf_faster_rcnn_torch.models.init import reference_init
from tf_faster_rcnn_torch.models.network import FasterRCNN, spec_from_cfg
from tf_faster_rcnn_torch.utils.checkpoint import load_params
from tf_faster_rcnn_torch.utils.slim_import import load_pretrained_into
from tf_faster_rcnn_torch.utils.tf_bundle import is_tf_checkpoint

NETS = ('vgg16', 'res50', 'res101', 'res152', 'mobile')


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description='Test a Faster R-CNN network')
    parser.add_argument('--cfg', dest='cfg_file', default=None)
    parser.add_argument('--model', dest='model', default=None,
                        help='weights to test: the port\'s .pt (params '
                             'or training snapshot), a JAX .msgpack (params '
                             'or training snapshot), a TF .ckpt prefix or a '
                             'slim var dict (.npz/.pkl)')
    parser.add_argument('--imdb', dest='imdb_name', default='voc_2007_test')
    parser.add_argument('--comp', dest='comp_mode', action='store_true',
                        help='competition mode')
    parser.add_argument('--num_dets', dest='max_per_image', default=100,
                        type=int, help='max number of detections per image')
    parser.add_argument('--tag', dest='tag', default='')
    parser.add_argument('--net', dest='net', default='res50', choices=NETS)
    parser.add_argument('--device', dest='device', default='cuda',
                        help='torch device to run on (default cuda)')
    parser.add_argument('--set', dest='set_cfgs', default=None,
                        nargs=argparse.REMAINDER)
    if argv is None and len(sys.argv) == 1:
        parser.print_help()
        sys.exit(1)
    return parser.parse_args(argv)


def load_model_params(model, model_path, net):
    """Load the weights at model_path into model, in place: None draws them
    from RNG_SEED (models/init.py::reference_init, the JAX package's
    initializers), as the reference tests with random weights; a TF
    ``.ckpt`` prefix or a slim var dict (``.npz``/``.pkl``) goes through the
    slim import over that draw (what it lacks keeps the draw); a ``.pt``
    (save_params, or a training snapshot of the port) or a JAX
    ``.msgpack`` (params or training snapshot) must hold every tensor. The
    counterpart of the JAX
    ``tools/test_net.py::load_model_params``; export_model and demo call it
    too."""
    if model_path is None:
        print('No model given, testing with random initialization '
              '(reference behavior, test_net.py:116-118)')
        reference_init(model, torch.Generator().manual_seed(cfg.RNG_SEED))
    elif is_tf_checkpoint(model_path) or model_path.endswith(('.npz',
                                                              '.pkl')):
        reference_init(model, torch.Generator().manual_seed(cfg.RNG_SEED))
        load_pretrained_into(model, model_path, net)
    else:
        model.load_state_dict(load_params(model_path), strict=True)


def main(argv=None):
    args = parse_args(argv)
    print('Called with args:')
    print(args)
    if args.cfg_file is not None:
        cfg_from_file(args.cfg_file)
    if args.set_cfgs is not None:
        cfg_from_list(args.set_cfgs)
    print('Using config:')
    pprint.pprint(cfg)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    imdb = get_imdb(args.imdb_name)
    imdb.competition_mode(args.comp_mode)
    spec = spec_from_cfg(args.net, imdb.num_classes, 'TEST')
    model = FasterRCNN(spec, device=args.device).eval()
    load_model_params(model, args.model, args.net)

    filename = (args.model or 'random').split('/')[-1] + args.tag
    return test_net(model, spec, imdb, filename,
                    max_per_image=args.max_per_image)


if __name__ == '__main__':
    main()
