#!/usr/bin/env python3
"""Times the NMS kernels of one tree of the port on one NVIDIA GPU, so that
two trees (a commit and its parent, or a kernel and a variant of it) can be
compared on the same card in one session.

    python3 tf_faster_rcnn_torch/tools/nms_ab.py --label change \\
        --inputs chiprun_out/nms_inputs.pt
    python3 tf_faster_rcnn_torch/tools/nms_ab.py --label parent \\
        --root checkout_check/parent --inputs chiprun_out/nms_inputs.pt
    python3 tf_faster_rcnn_torch/tools/nms_ab.py --label variant \\
        --replace 'OLD TEXT' 'NEW TEXT' --inputs chiprun_out/nms_inputs.pt

--root is the checkout whose tf_faster_rcnn_torch is timed (default: this
one). --replace times a copy of that package whose csrc/nms.cu has one exact
text replaced, built apart under this checkout's csrc/build/.

Each kernel is timed at the main path's own inputs (K1 [8, 6000] -> 300, K2
[160, 300]), K1 at the TRAIN shape [8, 12000] -> 2000 and K2 at the COCO
shape [640, 1000], in the two ways chip_smoke.py times them: device time of
one call from a replayed CUDA graph, and per call from Python by CUDA
events; the better of two tries each. The main path's inputs are captured
once, by this checkout's detect step, into --inputs, and every later run
loads them, so all trees time the same boxes. Each run holds its kernels
exactly to their plain versions on every input it times, and prints one
JSON line with the card's name and power limit.
"""

import argparse
import functools
import importlib.util
import json
import os.path as osp
import shutil
import sys

CHECKOUT = osp.abspath(osp.join(osp.dirname(osp.abspath(__file__)), "..", ".."))


def load_smoke():
    """This checkout's chip_smoke.py, for its inputs and timers."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", osp.join(CHECKOUT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def variant_root(root, old, new):
    """A copy of root's package with `old` replaced by `new` in csrc/nms.cu
    (exactly one match), under this checkout's csrc/build/."""
    dst = osp.join(CHECKOUT, "tf_faster_rcnn_torch", "csrc", "build",
                   "variant")
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(osp.join(root, "tf_faster_rcnn_torch"),
                    osp.join(dst, "tf_faster_rcnn_torch"),
                    ignore=shutil.ignore_patterns("build", "__pycache__"))
    path = osp.join(dst, "tf_faster_rcnn_torch", "csrc", "nms.cu")
    with open(path) as f:
        src = f.read()
    if src.count(old) != 1:
        raise SystemExit(f"nms_ab.py: {old!r} occurs {src.count(old)} times "
                         f"in {path}, not once")
    with open(path, "w") as f:
        f.write(src.replace(old, new))
    return dst


def capture(smoke, dev, path):
    """The arguments the main path's detect step gives each kernel."""
    import torch
    _, _, detect, inputs = smoke.build_main_path(dev)
    record = {}
    with smoke.nms_route(record=record), torch.inference_mode():
        detect(*inputs)
    torch.cuda.synchronize()
    torch.save(record, path)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--label", required=True)
    ap.add_argument("--inputs", required=True,
                    help="file of the main path's captured kernel inputs")
    ap.add_argument("--root", default=CHECKOUT)
    ap.add_argument("--replace", nargs=2, metavar=("OLD", "NEW"))
    args = ap.parse_args()
    root = osp.abspath(args.root)
    if args.replace:
        root = variant_root(root, *args.replace)
    if not osp.isdir(osp.join(root, "tf_faster_rcnn_torch")):
        raise SystemExit(f"nms_ab.py: no tf_faster_rcnn_torch/ in {root}")
    sys.path.insert(0, root)
    smoke = load_smoke()
    import torch
    card = smoke.phase_device()
    dev = torch.device("cuda", 0)
    from tf_faster_rcnn_torch.ops import nms_kernels as K
    if not osp.abspath(K.__file__).startswith(root + osp.sep):
        raise AssertionError(f"imported {K.__file__}, not the tree in {root}")
    if not osp.exists(args.inputs):
        if root != CHECKOUT:
            raise SystemExit("nms_ab.py: capture the inputs with this "
                             "checkout's own tree first")
        capture(smoke, dev, args.inputs)
    captured = torch.load(args.inputs, map_location=dev)
    pairs = smoke.kernel_pairs()
    train_boxes, train_valid = smoke.train_shape_inputs(dev)
    coco_boxes, coco_valid = smoke.coco_shape_inputs(dev)
    cases = (
        ("K1 main", "nms_keep_mask_batched", *captured["nms_keep_mask_batched"], 20),
        ("K2 main", "batched_nms_keep", *captured["batched_nms_keep"], 20),
        ("K1 TRAIN", "nms_keep_mask_batched",
         (train_boxes, train_valid, 0.7), dict(max_keep=2000), 5),
        ("K2 COCO", "batched_nms_keep",
         (coco_boxes, coco_valid, 0.3), dict(plus_one=True), 5))
    times = {}
    for label, name, a, kw, calls in cases:
        kernel, plain = pairs[name]
        got = kernel(*a, **kw)
        if not torch.equal(got, plain(*a, **kw)):
            raise AssertionError(f"{args.label} {label}: kernel != plain")
        fn = functools.partial(kernel, *a, **kw)
        graph = min(smoke.graph_ms(fn, calls=calls) for _ in range(2))
        call = min(smoke.timed(fn) for _ in range(2))
        times[label] = {"shape": list(a[0].shape), "graph_ms": graph,
                        "call_ms": call}
    print(json.dumps({"label": args.label, "root": osp.relpath(root, CHECKOUT),
                      "card": card, "times": times}))


if __name__ == "__main__":
    main()
