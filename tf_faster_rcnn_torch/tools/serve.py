#!/usr/bin/env python3
"""Run detection from an exported serving bundle, with the port: no config,
no model code.

    python -m tf_faster_rcnn_torch.tools.serve --bundle exported/ \\
        [--thresh 0.5] [--json out.json] image1.jpg image2.jpg ...

The CLI of ``tools/serve.py``. Everything it needs (canvas buckets, resize
target, max size, pixel means, batch, device, the programs, the parameters)
comes from the bundle that ``export_model`` wrote (``utils/serving.py``).
Images are grouped by orientation bucket from their headers
(``data/blob.py::image_size``), as ``engine/test_engine.py::test_net``
schedules them; each batch is decoded on the host, its canvases are built
on the bundle's device (``data/blob.py::prep_batch``), and the tail batch
repeats its last image. TF32 is off, as in the other CLIs, so a float32
program runs float32 convolutions. Prints each image's detections at or above
``--thresh``, and writes them as ``{image: [[cls, score, x1, y1, x2, y2],
...]}`` with ``--json``. The last line gives the images per second from the
first decode to the written output.
"""

import argparse
import json
import time

import numpy as np
import torch

from tf_faster_rcnn_torch.data.blob import (image_size, prep_batch,
                                            read_image_bgr, upload)
from tf_faster_rcnn_torch.utils.serving import load_detect


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="Serve from an export bundle")
    ap.add_argument("--bundle", required=True, help="export_model's output")
    ap.add_argument("--thresh", type=float, default=0.5,
                    help="score threshold for printing")
    ap.add_argument("--json", default=None, help="write detections here")
    ap.add_argument("images", nargs="+")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    # as the live CLIs run: a float32 program's convolutions in float32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    manifest, fns = load_detect(args.bundle)
    device = torch.device(manifest["device"])
    b = manifest["batch"]
    buckets = [tuple(e["canvas"]) for e in manifest["artifacts"]]
    target, max_size = manifest["scales"][0], manifest["max_size"]

    t0 = time.perf_counter()
    means = upload(np.asarray(manifest["pixel_means"], np.float32), device)
    # group by orientation bucket (landscape first, as exported) from the
    # headers, then decode one fixed-size batch at a time
    groups = {}
    for path in args.images:
        h, w = image_size(path)
        k = 0 if len(buckets) == 1 or w >= h else 1
        groups.setdefault(buckets[k], []).append(path)
    results = {}
    for bucket, paths in groups.items():
        for i in range(0, len(paths), b):
            chunk = paths[i:i + b]
            ims = [read_image_bgr(p) for p in chunk]
            ims += ims[-1:] * (b - len(chunk))
            images, im_info, orig_hw = prep_batch(
                ims, bucket, device, [target] * b, max_size, means)
            det, dv = fns[bucket](images, im_info, orig_hw)
            out = torch.cat([det, dv[..., None].to(det.dtype)], dim=-1)
            out = out.cpu().numpy()
            for j, path in enumerate(chunk):
                keep = (out[j, :, 6] > 0) & (out[j, :, 1] >= args.thresh)
                results[path] = out[j, keep, :6].tolist()

    for path in args.images:
        rows = results[path]
        print(f"{path}: {len(rows)} detections >= {args.thresh}")
        for cls, score, x1, y1, x2, y2 in rows:
            print(f"  class {int(cls):3d}  {score:.3f}  "
                  f"[{x1:.1f}, {y1:.1f}, {x2:.1f}, {y2:.1f}]")
    if args.json:
        with open(args.json, "w") as f:
            json.dump(results, f, indent=2)
        print(f"wrote {args.json}")
    seconds = time.perf_counter() - t0
    print(f"served {len(args.images)} images in {seconds:.3f} s "
          f"({len(args.images) / seconds:.2f} images/s) on {device}")
    return results


if __name__ == "__main__":
    main()
