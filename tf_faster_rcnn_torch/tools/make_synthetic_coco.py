"""Synthetic 80-class COCO devkit for the headline-shape rehearsal.

The port's copy of ``tools/make_synthetic_coco.py`` (the same output for
the same arguments, file for file). cv2 is imported only when called.

    python -m tf_faster_rcnn_torch.tools.make_synthetic_coco --root DIR

Generates a `coco/` tree (annotations + images) with the exact layout the
COCO binding expects (datasets/coco.py; reference lib/datasets/coco.py:61-121):
``instances_train2014.json``, ``instances_valminusminival2014.json`` and
``instances_minival2014.json``, with the two val views sharing the
``images/val2014`` directory, COCO file naming
(``COCO_<split>_%012d.jpg``), 80 categories with NON-contiguous category
ids (real COCO ids skip values — this exercises the label<->cat-id maps),
crowd annotations (iscrowd=1), both landscape and portrait images, and
per-image instance counts that reach TPU.MAX_GT on designated dense
images.

Every class renders as a unique (hue, brightness) solid rectangle on dark
noise, so the task is learnable from scratch: a healthy detector memorizes
color->class quickly, which lets tools/coco_rehearsal.py assert
non-trivial COCO AP after a short training run at the real headline
shapes (81 classes x 1000 proposals postprocess, 600/800px canvases).
"""

import json
import os
import os.path as osp

import numpy as np

NUM_CLASSES = 80


def category_table(num_classes=NUM_CLASSES):
    """80 categories with gappy ids (1..90-style), like real COCO."""
    cats = []
    for label in range(num_classes):
        cat_id = label + 1 + label // 8  # skip every 9th id
        cats.append({"id": cat_id, "name": f"synth{label:02d}",
                     "supercategory": "synthetic"})
    return cats


def class_color(label, num_classes=NUM_CLASSES):
    """Unique, well-separated BGR color per class: 20 hues x 4 values."""
    import cv2
    hue = (label % 20) * 9               # 0..171 on cv2's 0..179 wheel
    val = 255 - 45 * (label // 20)       # 255 / 210 / 165 / 120
    hsv = np.uint8([[[hue, 255, val]]])
    return [int(c) for c in cv2.cvtColor(hsv, cv2.COLOR_HSV2BGR)[0, 0]]


def _draw_image(rng, cats, image_id, hw, max_gt, dense, crowd_p=0.08):
    """One image + its annotation dicts (bbox in COCO xywh floats)."""
    import cv2
    h, w = hw
    im = rng.randint(0, 50, (h, w, 3), np.uint8)
    n = int(rng.randint(max(2, max_gt - 8), max_gt + 1)) if dense \
        else int(rng.randint(1, 12))
    anns = []
    side = min(h, w)
    for _ in range(n):
        # dense images carry many small boxes; normal ones anchor-sized
        # (sizes scale with the image so toy-canvas CPU tests stay valid)
        lo, hi = (max(4, side // 16), max(8, side // 7)) if dense \
            else (max(8, side // 10), max(16, side // 3))
        bw = int(rng.randint(lo, hi))
        bh = int(rng.randint(lo, hi))
        x = int(rng.randint(0, max(1, w - bw)))
        y = int(rng.randint(0, max(1, h - bh)))
        label = int(rng.randint(len(cats)))
        crowd = bool(rng.rand() < crowd_p)
        color = class_color(label, len(cats))
        if crowd:
            # crowds render as a dithered region (visually distinct mass)
            patch = im[y:y + bh, x:x + bw]
            mask = rng.rand(bh, bw) < 0.5
            patch[mask] = color
        else:
            im[y:y + bh, x:x + bw] = color
        anns.append({"image_id": image_id, "category_id": cats[label]["id"],
                     "bbox": [float(x), float(y), float(bw), float(bh)],
                     "area": float(bw * bh), "iscrowd": int(crowd)})
    return im, anns


def _write_split(root, split, view, image_ids, rng, cats, max_gt,
                 dense_every, base_hw):
    """Write one split's images + instances json. `view` is the directory
    the image files live in (minival/valminusminival share val2014)."""
    import cv2
    img_dir = osp.join(root, "coco", "images", view)
    ann_dir = osp.join(root, "coco", "annotations")
    os.makedirs(img_dir, exist_ok=True)
    os.makedirs(ann_dir, exist_ok=True)
    images, annotations = [], []
    for k, image_id in enumerate(image_ids):
        hw = base_hw if image_id % 2 == 0 else base_hw[::-1]
        dense = dense_every > 0 and k % dense_every == dense_every - 1
        im, anns = _draw_image(rng, cats, image_id, hw, max_gt, dense)
        name = f"COCO_{view}_{image_id:012d}.jpg"
        path = osp.join(img_dir, name)
        if not osp.exists(path):  # shared-view images written once
            cv2.imwrite(path, im)
        images.append({"id": image_id, "width": hw[1], "height": hw[0],
                       "file_name": name})
        annotations.extend(anns)
    for i, ann in enumerate(annotations):
        ann["id"] = i + 1
    ds = {"images": images, "annotations": annotations, "categories": cats}
    with open(osp.join(ann_dir, f"instances_{split}.json"), "w") as f:
        json.dump(ds, f)
    return ds


def make_synthetic_coco(root, n_train=96, n_valminusminival=16,
                        n_minival=16, num_classes=NUM_CLASSES, seed=0,
                        max_gt=100, dense_every=8, base_hw=(480, 640)):
    """Build the full synthetic devkit under `root`/coco.

    Returns {split: dataset-dict}. Deterministic in (seed, counts).
    The val2014 image ids partition into minival / valminusminival —
    disjoint views of one directory, as in the real minival split
    (reference lib/datasets/coco.py:52-60).
    """
    cats = category_table(num_classes)
    rng = np.random.RandomState(seed)
    out = {}
    train_ids = list(range(1, n_train + 1))
    out["train2014"] = _write_split(root, "train2014", "train2014",
                                    train_ids, rng, cats, max_gt,
                                    dense_every, base_hw)
    n_val = n_valminusminival + n_minival
    val_ids = list(range(10001, 10001 + n_val))
    out["valminusminival2014"] = _write_split(
        root, "valminusminival2014", "val2014",
        val_ids[:n_valminusminival], rng, cats, max_gt, dense_every,
        base_hw)
    out["minival2014"] = _write_split(
        root, "minival2014", "val2014", val_ids[n_valminusminival:],
        rng, cats, max_gt, 0, base_hw)
    return out


def main():
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", required=True)
    ap.add_argument("--train", type=int, default=96)
    ap.add_argument("--valminusminival", type=int, default=16)
    ap.add_argument("--minival", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--max-gt", type=int, default=100)
    args = ap.parse_args()
    out = make_synthetic_coco(args.root, args.train, args.valminusminival,
                              args.minival, seed=args.seed,
                              max_gt=args.max_gt)
    for split, ds in out.items():
        print(f"[synth-coco] {split}: {len(ds['images'])} images, "
              f"{len(ds['annotations'])} annotations")


if __name__ == "__main__":
    main()
