#!/usr/bin/env python3
"""Test a Faster R-CNN network on an image database, with the port.

    python -m tf_faster_rcnn_torch.tools.test_net \\
        --cfg experiments/cfgs/res101.yml --net res101 --imdb voc_2007_test \\
        --model WEIGHTS [--device cuda] [--set KEY VALUE ...]

The flags of ``tools/test_net.py`` (--cfg --model --imdb --comp --num_dets
--tag --net --devices --coordinator --num-procs --proc-id --set), and
``--device`` (default ``cuda``; the tests pass ``cpu``). ``--devices N``
starts N ranks on this host, one GPU each (or N gloo processes with
``--device cpu``), and the multi-host flags make this process one rank of a
run across hosts (``parallel/launch.py``): each rank detects its stripe of
the batches, and rank 0 merges them, writes detections.pkl and evaluates.
TPU.MODEL_DEVICES m above 1 (``--devices N``, m dividing N; single-host
only) lays the ranks out as an (N / m, m) mesh (``parallel/mesh.py``): the
batches are striped over the N / m data groups, and the ranks of a group
detect each batch together, the RoI head tensor parallel and, under
TPU.SPATIAL_PARTITION, the backbone head on each rank's rows of the canvas.

--model is the port's ``save_params`` file (``.pt``), a ``.msgpack`` that
the JAX package wrote (its ``save_params`` export or a training snapshot),
a training snapshot of the port (``*_iter_N.pt``), or, as the JAX CLI
takes them, a TF ``.ckpt`` bundle prefix or a slim var dict
(``.npz``/``.pkl``) through the slim import (``utils/slim_import.py``; what
it lacks keeps the RNG_SEED draw). Without it the weights are drawn
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
from tf_faster_rcnn_torch.parallel import dist
from tf_faster_rcnn_torch.parallel.launch import (launch, model_devices,
                                                  rank_device)
from tf_faster_rcnn_torch.parallel.mesh import (data_axis_size,
                                                layout_name,
                                                make_hybrid_mesh,
                                                shard_model)
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
    parser.add_argument('--devices', dest='devices', default=1, type=int,
                        help='data-parallel devices for evaluation on this '
                             'host (0 = all available)')
    parser.add_argument('--coordinator', dest='coordinator', default=None,
                        help='multi-host eval: coordinator host:port '
                             '(or env FRCNN_COORDINATOR)')
    parser.add_argument('--num-procs', dest='num_procs', default=None,
                        type=int, help='multi-host: total process count')
    parser.add_argument('--proc-id', dest='proc_id', default=None, type=int,
                        help='multi-host: this process id')
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
    return launch(args, run, model_devices(args))


def run(args):
    """Evaluate with the parsed flags in this process: one rank of a
    process group under the multi-host flags (or their variables), else
    alone. Returns the mAP (None on a rank other than 0)."""
    if args.cfg_file is not None:
        cfg_from_file(args.cfg_file)
    if args.set_cfgs is not None:
        cfg_from_list(args.set_cfgs)
    device = rank_device(args)
    dist.initialize(args.coordinator, args.num_procs, args.proc_id,
                    device=device)
    try:
        # the data axis needs no mesh here: each rank detects its stripe
        mesh, n_model = None, max(1, int(cfg.TPU.MODEL_DEVICES))
        if dist.process_count() > 1 and n_model > 1:
            mesh = make_hybrid_mesh(n_model)
            spatial = (', spatial partitioning of the backbone'
                       if cfg.TPU.SPATIAL_PARTITION else '')
            print(f'Evaluating {layout_name(data_axis_size(mesh), n_model)} '
                  f'over {dist.process_count()} ranks{spatial}')
        print('Using config:')
        pprint.pprint(cfg)
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False

        imdb = get_imdb(args.imdb_name)
        imdb.competition_mode(args.comp_mode)
        spec = spec_from_cfg(args.net, imdb.num_classes, 'TEST')
        model = FasterRCNN(spec, device=device).eval()
        load_model_params(model, args.model, args.net)
        shard_model(mesh, model, args.net)

        filename = (args.model or 'random').split('/')[-1] + args.tag
        return test_net(model, spec, imdb, filename,
                        max_per_image=args.max_per_image, mesh=mesh)
    finally:
        dist.shutdown()


if __name__ == '__main__':
    main()
