#!/usr/bin/env python3
"""Demo: Faster R-CNN detection on the demo images, with the port.

    python -m tf_faster_rcnn_torch.tools.demo [--net res101] [--model WEIGHTS]
        [--dataset pascal_voc] [--cfg FILE] [--demo-dir DIR] [--out-dir DIR]
        [--json OUT] [--device cuda]

The flags of ``tools/demo.py`` (the reference's demo.py:113-155), plus
``--device`` (default ``cuda``; the tests pass ``cpu``). It loads a model
(``tools/test_net.py::load_model_params``: none for seeded random weights,
the port's ``.pt``, a JAX ``.msgpack``, a TF ``.ckpt`` prefix or a slim var
dict), runs
``engine/test_engine.py::im_detect`` on each image and keeps the
detections at or above CONF_THRESH = 0.8, drawn per class into
``<out-dir>/det_<image>.png``. ``--json`` also writes them as
``{image: [[class_name, score, x1, y1, x2, y2], ...]}``. The images default
to data/demo, generated on first use when it holds none
(``make_demo_images.py``). The figures are drawn with PIL
(``utils/visualization.py::draw_detections``, as the port's other
drawing), not with matplotlib as the JAX demo draws them, so the demo
needs no package beyond those the port already reads images with.
"""

import argparse
import json
import os
import os.path as osp

import torch

from tf_faster_rcnn_torch.config import cfg_from_file
from tf_faster_rcnn_torch.datasets.pascal_voc import VOC_CLASSES
from tf_faster_rcnn_torch.data.blob import read_image_bgr
from tf_faster_rcnn_torch.engine.test_engine import im_detect, make_detect_fn
from tf_faster_rcnn_torch.models.network import FasterRCNN, spec_from_cfg
from tf_faster_rcnn_torch.tools.make_demo_images import (DEFAULT_DEMO_DIR,
                                                         generate)
from tf_faster_rcnn_torch.tools.test_net import NETS, load_model_params
from tf_faster_rcnn_torch.utils.timer import Timer
from tf_faster_rcnn_torch.utils.visualization import draw_detections

CONF_THRESH = 0.8
IMAGE_EXTS = ('.jpg', '.png')


def demo(detect_fn, device, image_path, out_dir):
    """Detect on one image, save its figure; returns the detections at or
    above CONF_THRESH as [(class_name, score, x1, y1, x2, y2), ...]."""
    im = read_image_bgr(image_path)
    timer = Timer()
    timer.tic()
    dets = im_detect(detect_fn, im, device)
    timer.toc()
    print('Detection took {:.3f}s for {:d} object proposals'.format(
        timer.total_time, len(dets)))
    dets = dets[dets[:, 1] >= CONF_THRESH]
    out = osp.join(out_dir, 'det_' + osp.basename(image_path) + '.png')
    draw_detections(im[:, :, ::-1], dets, VOC_CLASSES).save(out)
    print('Saved ' + out)
    return [(VOC_CLASSES[int(row[0])], float(row[1]), float(row[2]),
             float(row[3]), float(row[4]), float(row[5])) for row in dets]


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description='Faster R-CNN demo')
    parser.add_argument('--net', dest='net', default='res101', choices=NETS)
    parser.add_argument('--model', dest='model', default=None,
                        help='weights: the port\'s .pt, a JAX .msgpack, a '
                             'TF .ckpt prefix or a slim var dict')
    parser.add_argument('--dataset', dest='dataset', default=None,
                        choices=('pascal_voc', 'pascal_voc_0712'),
                        help='reference-parity shorthand (demo.py:118-126): '
                             'resolves --model to the trained snapshot under '
                             'output/<net>/<imdb>/default/')
    parser.add_argument('--cfg', dest='cfg_file', default=None)
    parser.add_argument('--demo-dir', default=DEFAULT_DEMO_DIR)
    parser.add_argument('--out-dir', default='demo_out')
    parser.add_argument('--json', dest='json_out', default=None,
                        help='also write {image: [[cls, score, x1, y1, x2, '
                             'y2], ...]}')
    parser.add_argument('--device', dest='device', default='cuda',
                        help='torch device to run on (default cuda)')
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    if args.cfg_file:
        cfg_from_file(args.cfg_file)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    if args.dataset and not args.model:
        # the reference resolves (net, dataset) to its snapshot
        # (demo.py:38-41,118-126); the port's snapshots are .pt files
        imdb = {'pascal_voc': 'voc_2007_trainval',
                'pascal_voc_0712':
                    'voc_2007_trainval+voc_2012_trainval'}[args.dataset]
        iters = {'vgg16': 70000}.get(args.net, 110000)
        args.model = osp.join('output', args.net, imdb, 'default',
                              f'{args.net}_faster_rcnn_iter_{iters}.pt')

    spec = spec_from_cfg(args.net, len(VOC_CLASSES), 'TEST')
    model = FasterRCNN(spec, device=args.device).eval()
    load_model_params(model, args.model, args.net)
    detect_fn = make_detect_fn(model, spec)
    device = torch.device(args.device)

    os.makedirs(args.out_dir, exist_ok=True)
    if not osp.isdir(args.demo_dir) or not any(
            f.endswith(IMAGE_EXTS) for f in os.listdir(args.demo_dir)):
        print(f'{args.demo_dir} holds no image: generating the synthetic '
              'demo scenes (make_demo_images.py)')
        generate(args.demo_dir)
    im_names = sorted(f for f in os.listdir(args.demo_dir)
                      if f.endswith(IMAGE_EXTS))
    all_dets = {}
    for im_name in im_names:
        print('~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~')
        print('Demo for {}'.format(im_name))
        all_dets[im_name] = demo(detect_fn, device,
                                 osp.join(args.demo_dir, im_name),
                                 args.out_dir)
    if args.json_out:
        with open(args.json_out, 'w') as f:
            json.dump(all_dets, f, indent=1)
        print('Wrote ' + args.json_out)
    return all_dets


if __name__ == '__main__':
    main()
