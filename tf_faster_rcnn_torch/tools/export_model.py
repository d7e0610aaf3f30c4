#!/usr/bin/env python3
"""Export a trained detector as self-contained torch.export serving
artifacts, with the port.

    python -m tf_faster_rcnn_torch.tools.export_model --net res101 \\
        --model WEIGHTS --out exported/ --batch 8 [--device cuda] [--verify] \\
        [--cfg FILE] [--set KEY VALUE ...]

The flags of ``tools/export_model.py``, with ``--device`` (default
``cuda``; the tests pass ``cpu``) in place of ``--platforms``: a bundle is
exported on the device that serves it (``utils/serving.py``). --model takes
what ``test_net --model`` takes (``tools/test_net.py::load_model_params``);
without it the weights are drawn from RNG_SEED, for plumbing tests.
``--verify`` reloads every artifact and checks that it gives exactly the
live program's outputs on random inputs. TF32 is off: a float32 compute
dtype runs float32 convolutions.
"""

import argparse

import numpy as np
import torch

from tf_faster_rcnn_torch.config import cfg_from_file, cfg_from_list
from tf_faster_rcnn_torch.engine.test_engine import make_detect_fn
from tf_faster_rcnn_torch.models.network import FasterRCNN, spec_from_cfg
from tf_faster_rcnn_torch.tools.test_net import NETS, load_model_params
from tf_faster_rcnn_torch.utils.serving import export_detect, load_detect


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        description="Export the detect program for serving")
    ap.add_argument("--net", required=True, choices=NETS)
    ap.add_argument("--model", default=None,
                    help="weights: the port's .pt, a JAX .msgpack, a TF "
                         ".ckpt prefix or a slim var dict (.npz/.pkl) "
                         "(default: random init, for plumbing tests)")
    ap.add_argument("--out", required=True, help="output directory")
    ap.add_argument("--num-classes", type=int, default=21)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--max-per-image", type=int, default=None)
    ap.add_argument("--device", default="cuda",
                    help="torch device to export on and serve from "
                         "(default cuda)")
    ap.add_argument("--verify", action="store_true",
                    help="reload every artifact and check it matches the "
                         "live program on random inputs")
    ap.add_argument("--cfg", dest="cfg_file", default=None)
    ap.add_argument("--set", dest="set_cfgs", default=None,
                    nargs=argparse.REMAINDER)
    return ap.parse_args(argv)


def verify(model, spec, out_dir, max_per_image=None):
    """Every artifact of out_dir against the live make_detect_fn on random
    inputs: outputs exactly equal."""
    device = next(model.parameters()).device
    detect = make_detect_fn(model, spec, max_per_image)
    manifest, fns = load_detect(out_dir)
    rng = np.random.RandomState(0)
    for e in manifest["artifacts"]:
        h, w = e["canvas"]
        image = torch.from_numpy(
            (rng.randn(*e["image_shape"]) * 50).astype(np.float32))
        im_info = torch.tensor([[h * 0.9, w * 0.9, 1.5]] * manifest["batch"])
        orig_hw = im_info[:, :2] / im_info[:, 2:]
        args = [t.to(device) for t in (image, im_info, orig_hw)]
        got = fns[(h, w)](*args)
        want = detect(*args)
        for g, v in zip(got, want, strict=True):
            torch.testing.assert_close(g, v, rtol=0, atol=0)
        print(f"verified {e['file']}: exported == live")


def main(argv=None):
    args = parse_args(argv)
    if args.cfg_file:
        cfg_from_file(args.cfg_file)
    if args.set_cfgs:
        cfg_from_list(args.set_cfgs)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    spec = spec_from_cfg(args.net, args.num_classes, "TEST")
    model = FasterRCNN(spec, device=args.device).eval()
    load_model_params(model, args.model, args.net)
    manifest = export_detect(model, spec, args.out, args.batch,
                             max_per_image=args.max_per_image)
    for e in manifest["artifacts"]:
        print(f"wrote {args.out}/{e['file']}  image {e['image_shape']}")
    if args.verify:
        verify(model, spec, args.out, args.max_per_image)
    return manifest


if __name__ == "__main__":
    main()
