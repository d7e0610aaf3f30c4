#!/usr/bin/env python3
"""COCO-scale end-to-end rehearsal at the headline shapes.

    python -m tf_faster_rcnn_torch.tools.coco_rehearsal [--device cuda]
    python -m tf_faster_rcnn_torch.tools.coco_rehearsal --iters 8000 \\
        --min-ap 0.10 --workdir DIR

The port's counterpart of ``tools/coco_rehearsal.py``. It builds an
80-class synthetic COCO devkit (``tools/make_synthetic_coco.py``:
non-contiguous category ids, crowd regions, both orientations, dense images
up to --max-gt instances), then drives the port's experiment drivers, each
in a subprocess run from the repo root:

    tools.train_faster_rcnn  (coco recipe, from the JAX package's
        initializers: --weight '') -> chains into tools.test_faster_rcnn
        under experiments/cfgs/<net>.yml
    tools.test_faster_rcnn   again under <net>-lg.yml (800 px canvases,
        RPN_POST_NMS_TOP_N 1000) on the same snapshot: the B x 80-class x
        1000-proposal postprocess NMS and the COCO results json / COCOeval
        path at the shapes the published COCO headline needs.

It passes when AP@[0.5:0.95] (``stats[0]`` of each eval's
``detection_results.pkl``) reaches --min-ap on the synthetic minival for
both evals. The synthetic task is color -> class memorization, so a
healthy TRAIN + TEST path clears the gate; a silent regression anywhere in
the 81-class pipeline (targets at 100 gt, crowd exclusion, results json,
category-id mapping, COCOeval) fails it. The record (APs, steps, the
drivers' wall seconds, ms per train step from the train log) is
printed and written to <workdir>/rehearsal.json. Exit code 0 on PASS.
"""

import argparse
import glob
import json
import os
import os.path as osp
import pickle
import shutil
import subprocess
import sys
import tempfile
import time

REPO = osp.dirname(osp.dirname(osp.dirname(osp.abspath(__file__))))
TAG = "rehearsal"


def run_driver(module, devices, net, workdir, extra_sets, flags):
    """Run tools.<module> DEVICES coco NET from the repo root; returns its
    wall seconds. The drivers emit their own ANCHOR_* / STEPSIZE pairs and
    append extra_sets (bare KEY VALUE pairs) after them."""
    cmd = ([sys.executable, "-m", f"tf_faster_rcnn_torch.tools.{module}",
            str(devices), "coco", net, "--tag", TAG,
            "--output-root", workdir] + flags + ["--set"] + extra_sets)
    print(f"[rehearsal] {' '.join(cmd)}", flush=True)
    t0 = time.perf_counter()
    subprocess.run(cmd, cwd=REPO, check=True)
    return time.perf_counter() - t0


def read_minival_ap(workdir, exp_dir):
    """AP@[0.5:0.95] of the newest minival eval under exp_dir."""
    pat = osp.join(workdir, "output", exp_dir, "coco_2014_minival", "*",
                   "detection_results.pkl")
    hits = sorted(glob.glob(pat), key=osp.getmtime)
    if not hits:
        raise SystemExit(f"[rehearsal] no detection_results.pkl under {pat}")
    with open(hits[-1], "rb") as f:
        return float(pickle.load(f)["stats"][0])


def train_log(net):
    """The newest log of the train driver's rehearsal runs."""
    logs = sorted(glob.glob(osp.join(REPO, "experiments", "logs",
                                     f"train_{net}_*{TAG}*.log")),
                  key=osp.getmtime)
    return logs[-1] if logs else None


def train_ms_per_step(log):
    """ms per step over the whole run: the last 'speed: S s / iter' line
    the train loop printed (its timer's mean over every step); None when
    there is none."""
    speed = None
    with open(log) as f:
        for line in f:
            if line.startswith("speed: "):
                speed = float(line.split()[1].rstrip("s")) * 1e3
    return speed


def build_parser():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--net", default="res101",
                    choices=("vgg16", "res50", "res101", "res152", "mobile"))
    ap.add_argument("--devices", type=int, default=1)
    ap.add_argument("--iters", type=int, default=4000,
                    help="training length in images (recipe units)")
    ap.add_argument("--train-images", type=int, default=96)
    ap.add_argument("--val-images", type=int, default=16,
                    help="images in each of valminusminival/minival")
    ap.add_argument("--base-hw", type=int, nargs=2, default=(480, 640),
                    help="generated image size (pre-resize)")
    ap.add_argument("--max-gt", type=int, default=100,
                    help="instance count of the dense images")
    ap.add_argument("--ims-per-device", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--set", dest="set_cfgs", nargs="+", default=[],
                    metavar="KEY VALUE",
                    help="extra config override pairs forwarded to both "
                         "drivers (bare pairs; the drivers add --set)")
    ap.add_argument("--min-ap", type=float, default=0.05,
                    help="AP@[0.5:0.95] gate on the synthetic minival")
    ap.add_argument("--skip-lg", action="store_true",
                    help="skip the <net>-lg.yml second eval")
    ap.add_argument("--workdir", default=None,
                    help="keep artifacts here (default: fresh temp dir)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default cuda)")
    return ap


def main(argv=None):
    ap = build_parser()
    args = ap.parse_args(argv)
    # KEY=VALUE tokens are split into pairs (lets values that start with a
    # dash through argparse); checked before any workdir is made
    set_cfgs = []
    for tok in args.set_cfgs:
        if len(set_cfgs) % 2 == 0 and "=" in tok:  # KEY position
            set_cfgs.extend(tok.split("=", 1))
        else:
            set_cfgs.append(tok)
    if len(set_cfgs) % 2:
        ap.error("--set takes KEY VALUE pairs or KEY=VALUE tokens "
                 "(got an odd count)")

    workdir = osp.abspath(args.workdir or
                          tempfile.mkdtemp(prefix="coco_rehearsal_"))
    os.makedirs(workdir, exist_ok=True)
    shutil.rmtree(osp.join(workdir, "cache"), ignore_errors=True)

    from tf_faster_rcnn_torch.tools.make_synthetic_coco import \
        make_synthetic_coco
    out = make_synthetic_coco(workdir, n_train=args.train_images,
                              n_valminusminival=args.val_images,
                              n_minival=args.val_images,
                              max_gt=args.max_gt,
                              base_hw=tuple(args.base_hw), seed=args.seed)
    for split, ds in out.items():
        print(f"[rehearsal] {split}: {len(ds['images'])} images, "
              f"{len(ds['annotations'])} annotations")

    # every run artifact (roidb caches, snapshots, detections) lives under
    # the workdir; the drivers run from the repo root
    sets = ["DATA_DIR", workdir, "ROOT_DIR", workdir,
            "TPU.IMS_PER_DEVICE", str(args.ims_per_device),
            "TRAIN.SNAPSHOT_ITERS", str(max(args.iters, 1000))] + set_cfgs
    common = ["--device", args.device]
    global_batch = args.ims_per_device * args.devices
    result = {"net": args.net, "iters": args.iters,
              "steps": -(-args.iters // global_batch), "gate": args.min_ap,
              "workdir": workdir, "ok": False, "ap_600": None,
              "ap_lg": None, "train_driver_s": None, "lg_driver_s": None,
              "train_ms_per_step": None, "log_path": None}
    try:
        # train, chained into the <net>.yml eval
        result["train_driver_s"] = run_driver(
            "train_faster_rcnn", args.devices, args.net, workdir, sets,
            common + ["--weight", "", "--iters", str(args.iters),
                      "--stepsize", f"[{10 ** 9}]"])
        result["log_path"] = train_log(args.net)
        if result["log_path"]:
            result["train_ms_per_step"] = train_ms_per_step(
                result["log_path"])
        result["ap_600"] = read_minival_ap(workdir, args.net)
        lg_cfg = osp.join("experiments", "cfgs", f"{args.net}-lg.yml")
        if not args.skip_lg and not osp.exists(osp.join(REPO, lg_cfg)):
            print(f"[rehearsal] no {args.net}-lg.yml: skipping the "
                  f"large-config second eval")
            args.skip_lg = True
        if not args.skip_lg:
            result["lg_driver_s"] = run_driver(
                "test_faster_rcnn", args.devices, args.net, workdir, sets,
                common + ["--cfg", lg_cfg])
            result["ap_lg"] = read_minival_ap(workdir, f"{args.net}-lg")
    except (subprocess.CalledProcessError, SystemExit) as e:
        result["error"] = str(e)
        print(f"[rehearsal] FAIL: driver chain died: {e}")
        print(f"[rehearsal] artifacts retained: {workdir}")
        _record(workdir, result)
        return result

    ap_std, ap_lg = result["ap_600"], result["ap_lg"]
    print(f"[rehearsal] minival AP@[0.5:0.95]: {args.net}={ap_std:.4f}"
          + (f"  {args.net}-lg={ap_lg:.4f}" if ap_lg is not None else ""))
    result["ok"] = bool(ap_std >= args.min_ap
                        and (ap_lg is None or ap_lg >= args.min_ap))
    _record(workdir, result)
    print(f"[rehearsal] {'PASS' if result['ok'] else 'FAIL'} "
          f"(gate {args.min_ap})")
    if not args.workdir:
        if result["ok"]:
            shutil.rmtree(workdir, ignore_errors=True)
        else:
            print(f"[rehearsal] artifacts retained: {workdir}")
    return result


def _record(workdir, result):
    """Print the record and write it to <workdir>/rehearsal.json."""
    print("[rehearsal] record " + json.dumps(result))
    with open(osp.join(workdir, "rehearsal.json"), "w") as f:
        json.dump(result, f)
        f.write("\n")


if __name__ == "__main__":
    sys.exit(0 if main()["ok"] else 1)
