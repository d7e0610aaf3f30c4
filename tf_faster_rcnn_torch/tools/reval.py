#!/usr/bin/env python3
"""Re-score saved detections without re-running the network, with the port.

    python -m tf_faster_rcnn_torch.tools.reval OUTPUT_DIR [--imdb NAME]
        [--matlab] [--comp] [--nms] [--set KEY VALUE ...]

The flags of ``tools/reval.py``: OUTPUT_DIR holds the ``detections.pkl``
that test_net wrote (either package's: both write lists of float32 [N, 5]
arrays), --nms re-applies per-class NMS at TEST.NMS on the host, and the
imdb's evaluator scores the result.
"""

import argparse
import pickle
from pathlib import Path


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Re-evaluate a saved detections.pkl")
    ap.add_argument("output_dir", help="directory containing detections.pkl")
    ap.add_argument("--imdb", dest="imdb_name", default="voc_2007_test")
    ap.add_argument("--matlab", dest="matlab_eval", action="store_true")
    ap.add_argument("--comp", dest="comp_mode", action="store_true")
    ap.add_argument("--nms", dest="apply_nms", action="store_true",
                    help="re-run per-class NMS at TEST.NMS before evaluating")
    ap.add_argument("--set", dest="set_cfgs", default=None,
                    nargs=argparse.REMAINDER)
    args = ap.parse_args(argv)

    from tf_faster_rcnn_torch.config import cfg, cfg_from_list
    if args.set_cfgs:
        cfg_from_list(args.set_cfgs)

    det_file = Path(args.output_dir).resolve() / "detections.pkl"
    all_boxes = pickle.loads(det_file.read_bytes())

    if args.apply_nms:
        from tf_faster_rcnn_torch.engine.test_engine import apply_nms
        print("Applying NMS to all detections")
        all_boxes = apply_nms(all_boxes, cfg.TEST.NMS)

    from tf_faster_rcnn_torch.datasets.factory import get_imdb
    imdb = get_imdb(args.imdb_name)
    imdb.competition_mode(args.comp_mode)
    imdb.config["matlab_eval"] = args.matlab_eval
    print("Evaluating detections")
    return imdb.evaluate_detections(all_boxes, str(det_file.parent))


if __name__ == "__main__":
    main()
