#!/usr/bin/env python3
"""Convert slim/TF weights into the port's parameter file.

    python -m tf_faster_rcnn_torch.tools.convert_weights --net res101 \\
        --src res101.ckpt --dst res101.pt [--num-classes 21] [--cfg ...] \\
        [--device cuda] [--set KEY VALUE ...]

The port's counterpart of ``tools/convert_weights.py``. --src is a TF
``.ckpt`` TensorBundle prefix (read by ``utils/tf_bundle.py``, no
TensorFlow needed) or a slim var dict (.npz or .pkl); it goes through the
surgery of ``utils/slim_import.py`` into a TEST model whose other tensors
(the detection heads of an ImageNet checkpoint) are drawn from RNG_SEED
(``models/init.py``), and is written with ``utils/checkpoint.py::
save_params`` as a ``.pt`` that ``tools.test_net --model`` reads. The model
is built on ``--device`` (default ``cuda``); the draw comes from a CPU
generator, so the ``.pt`` is the same on any device.
"""

import argparse

import torch

from tf_faster_rcnn_torch.config import cfg, cfg_from_file, cfg_from_list
from tf_faster_rcnn_torch.models.init import init_model
from tf_faster_rcnn_torch.models.network import FasterRCNN, spec_from_cfg
from tf_faster_rcnn_torch.utils.checkpoint import save_params
from tf_faster_rcnn_torch.utils.slim_import import load_pretrained_into

NETS = ('vgg16', 'res50', 'res101', 'res152', 'mobile')


def build_parser():
    parser = argparse.ArgumentParser(
        description='Convert slim/TF var-dict weights to the port\'s .pt')
    parser.add_argument('--net', required=True, choices=NETS)
    parser.add_argument('--src', required=True,
                        help='TF .ckpt prefix, or slim var dict (.npz/.pkl)')
    parser.add_argument('--dst', required=True, help='output .pt')
    parser.add_argument('--num-classes', type=int, default=21)
    parser.add_argument('--cfg', dest='cfg_file', default=None)
    parser.add_argument('--device', dest='device', default='cuda',
                        help='torch device to build the model on '
                             '(default cuda)')
    parser.add_argument('--set', dest='set_cfgs', default=None,
                        nargs=argparse.REMAINDER)
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.cfg_file:
        cfg_from_file(args.cfg_file)
    if args.set_cfgs:
        cfg_from_list(args.set_cfgs)
    spec = spec_from_cfg(args.net, args.num_classes, 'TEST')
    model = FasterRCNN(spec, device=args.device)
    init_model(model, torch.Generator().manual_seed(cfg.RNG_SEED))
    load_pretrained_into(model, args.src, args.net)
    save_params(args.dst, model)
    print(f'Wrote {args.dst}')


if __name__ == '__main__':
    main()
