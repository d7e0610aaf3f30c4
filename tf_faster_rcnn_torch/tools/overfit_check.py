#!/usr/bin/env python3
"""Hardware-validation drill: from-scratch overfit on a synthetic VOC set.

    python -m tf_faster_rcnn_torch.tools.overfit_check      # vgg16, 1600 iters
    python -m tf_faster_rcnn_torch.tools.overfit_check --iters 400 \\
        --net res50 --eval-every 200 [--device cpu]

The port's counterpart of ``tools/overfit_check.py``: it generates a tiny
VOCdevkit tree of solid-color rectangles, trains a network from the JAX
package's initializers on it (``engine/train_loop.py::train_net``, no
--weight), evaluates on the SAME images (``engine/test_engine.py::
test_net``), and passes when every class present reaches AP >= --min-ap,
read from the eval's ``{cls}_pr.pkl``. A healthy training path memorizes
this task; a silent regression anywhere in the TRAIN graph (targets,
losses, optimizer, masking) shows up here. The tiny settings
(``configure_tiny``: bf16 compute, a 96x128 canvas, anchor scales [2, 4],
256 -> 48 proposals in TRAIN, 256 -> 32 in TEST) are the JAX tool's. Runs
on ``--device`` (default cuda), TF32 off. Exit code 0 on PASS, 1 on
FAIL.
"""

import argparse
import os
import os.path as osp
import pickle
import shutil
import sys
import tempfile
import time

import numpy as np

CLASSES_USED = ("aeroplane", "car", "person")


def make_synthetic_voc(root, n_images, seed=0):
    """VOCdevkit2007 tree of noise images with bright solid rectangles.

    The same images back both the trainval and test splits — this drill
    measures memorization, not generalization. Returns the sorted list of
    classes actually emitted (each image draws only 1-2 random classes, so
    with few images a class can be absent). Stale caches from a previous
    run of the same workdir (imdb gt_roidb pickle, voc_eval annotation
    cache) are removed first.
    """
    import cv2
    rng = np.random.RandomState(seed)
    shutil.rmtree(osp.join(root, "cache"), ignore_errors=True)
    shutil.rmtree(osp.join(root, "VOCdevkit2007", "annotations_cache"),
                  ignore_errors=True)
    voc = osp.join(root, "VOCdevkit2007", "VOC2007")
    os.makedirs(osp.join(voc, "JPEGImages"), exist_ok=True)
    os.makedirs(osp.join(voc, "Annotations"), exist_ok=True)
    os.makedirs(osp.join(voc, "ImageSets", "Main"), exist_ok=True)
    names = []
    emitted = set()
    for i in range(n_images):
        name = f"{i:06d}"
        names.append(name)
        h, w = 96, 128
        im = rng.randint(0, 60, (h, w, 3), np.uint8)
        objs = []
        for _ in range(rng.randint(1, 3)):
            x1, y1 = rng.randint(5, 60), rng.randint(5, 40)
            x2 = min(x1 + rng.randint(20, 50), w - 2)
            y2 = min(y1 + rng.randint(20, 40), h - 2)
            cls = CLASSES_USED[rng.randint(len(CLASSES_USED))]
            emitted.add(cls)
            im[y1:y2, x1:x2] = rng.randint(150, 255, 3)
            objs.append((cls, x1 + 1, y1 + 1, x2 + 1, y2 + 1))  # 1-based
        cv2.imwrite(osp.join(voc, "JPEGImages", name + ".jpg"), im)
        xml_objs = "".join(
            f"<object><name>{c}</name><pose>Left</pose>"
            f"<truncated>0</truncated><difficult>0</difficult>"
            f"<bndbox><xmin>{x1}</xmin><ymin>{y1}</ymin>"
            f"<xmax>{x2}</xmax><ymax>{y2}</ymax></bndbox></object>"
            for c, x1, y1, x2, y2 in objs)
        with open(osp.join(voc, "Annotations", name + ".xml"), "w") as f:
            f.write(f"<annotation><size><width>{w}</width>"
                    f"<height>{h}</height><depth>3</depth></size>"
                    f"{xml_objs}</annotation>")
    for split in ("trainval", "test"):
        with open(osp.join(voc, "ImageSets", "Main", split + ".txt"),
                  "w") as f:
            f.write("\n".join(names) + "\n")
    return sorted(emitted)


def configure_tiny(workdir):
    """Shrink the pipeline to the synthetic 96x128 task (single canvas,
    small anchor scales, no LR decay over the drill's horizon)."""
    from tf_faster_rcnn_torch.config import cfg
    cfg.DATA_DIR = workdir
    cfg.ROOT_DIR = workdir
    cfg.EXP_DIR = "overfit"
    cfg.TPU.CANVAS_SIZE = [96, 128]
    cfg.TPU.MAX_GT = 8
    cfg.TRAIN.SCALES = (64,)
    cfg.TRAIN.MAX_SIZE = 96
    cfg.TEST.SCALES = (64,)
    cfg.TEST.MAX_SIZE = 96
    cfg.ANCHOR_SCALES = [2, 4]
    cfg.TEST.RPN_PRE_NMS_TOP_N = 256
    cfg.TEST.RPN_POST_NMS_TOP_N = 32
    cfg.TRAIN.RPN_PRE_NMS_TOP_N = 256
    cfg.TRAIN.RPN_POST_NMS_TOP_N = 48
    cfg.TRAIN.BATCH_SIZE = 16
    cfg.TRAIN.RPN_BATCHSIZE = 32
    cfg.TRAIN.USE_FLIPPED = False
    cfg.TRAIN.STEPSIZE = [10 ** 9]
    cfg.TRAIN.DISPLAY = 100
    cfg.TPU.COMPUTE_DTYPE = "bfloat16"


def build_parser():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--net", default="vgg16",
                    choices=("vgg16", "res50", "res101", "res152", "mobile"))
    ap.add_argument("--iters", type=int, default=1600)
    ap.add_argument("--images", type=int, default=6)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--min-ap", type=float, default=0.99,
                    help="per-present-class AP gate")
    ap.add_argument("--eval-every", type=int, default=0,
                    help="in-training validation mAP cadence (TPU.EVAL_ITERS)")
    ap.add_argument("--workdir", default=None,
                    help="keep artifacts here (default: fresh temp dir)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default cuda)")
    return ap


def main(argv=None):
    """Run the drill; returns its record (the per-class APs, ok, and the
    train and eval wall seconds)."""
    args = build_parser().parse_args(argv)
    import torch
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    workdir = args.workdir or tempfile.mkdtemp(prefix="overfit_")
    os.makedirs(workdir, exist_ok=True)
    present = make_synthetic_voc(workdir, args.images, seed=args.seed)
    configure_tiny(workdir)

    from tf_faster_rcnn_torch.config import cfg
    from tf_faster_rcnn_torch.data.roidb import prepare_roidb
    from tf_faster_rcnn_torch.datasets.factory import get_imdb
    from tf_faster_rcnn_torch.engine.test_engine import test_net
    from tf_faster_rcnn_torch.engine.train_loop import train_net
    from tf_faster_rcnn_torch.models.network import FasterRCNN, spec_from_cfg
    print(f"device: {args.device}  workdir: {workdir}")

    if args.eval_every:
        cfg.TPU.EVAL_ITERS = args.eval_every

    imdb = get_imdb("voc_2007_trainval")
    imdb.set_proposal_method("gt")
    prepare_roidb(imdb)
    roidb = imdb.roidb
    out_dir = osp.join(workdir, "train_out")
    tb_dir = osp.join(workdir, "tb")
    evalimdb = get_imdb("voc_2007_test")
    t0 = time.perf_counter()
    state = train_net(args.net, imdb, roidb, list(roidb), out_dir, tb_dir,
                      max_iters=args.iters,
                      valimdb=evalimdb if args.eval_every else None,
                      device=args.device)
    train_s = time.perf_counter() - t0

    spec = spec_from_cfg(args.net, evalimdb.num_classes, "TEST")
    model = FasterRCNN(spec, device=args.device).eval()
    model.load_state_dict(state.model.state_dict(), strict=True)
    eval_dir = osp.join(workdir, "eval_out")
    t0 = time.perf_counter()
    mean_ap = test_net(model, spec, evalimdb, f"iter_{args.iters}",
                       max_per_image=20, output_dir=eval_dir)
    eval_s = time.perf_counter() - t0

    # gate only on classes the generator actually emitted: with a small
    # --images or unlucky --seed a CLASSES_USED member can have zero gt
    # instances, and its AP would be a spurious 0
    aps = {}
    for cls in present:
        with open(osp.join(eval_dir, f"{cls}_pr.pkl"), "rb") as f:
            aps[cls] = float(pickle.load(f)["ap"])
    print(f"[overfit] {args.net} @ {args.iters} iters: mAP(20cls) "
          f"{float(np.asarray(mean_ap).ravel()[0]):.4f}; present classes: "
          + ", ".join(f"{c}={a:.4f}" for c, a in aps.items()))
    ok = all(a >= args.min_ap for a in aps.values())
    print(f"[overfit] {'PASS' if ok else 'FAIL'} (gate {args.min_ap})")
    if not args.workdir:
        if ok:
            shutil.rmtree(workdir, ignore_errors=True)
        else:
            # keep the evidence (detections, PR pickles, snapshots)
            print(f"[overfit] artifacts retained for diagnosis: {workdir}")
    return {"net": args.net, "iters": args.iters, "aps": aps, "ok": ok,
            "gate": args.min_ap, "train_s": train_s, "eval_s": eval_s}


if __name__ == "__main__":
    sys.exit(0 if main()["ok"] else 1)
