#!/usr/bin/env python3
"""Generate the demo images (data/demo/*.jpg), with the port.

    python -m tf_faster_rcnn_torch.tools.make_demo_images [--out data/demo]
        [--n 5] [--seed 3]

A copy of ``tools/make_demo_images.py``: five VOC-sized synthetic scenes
(a textured background with a vertical gradient and a handful of solid,
high-contrast rectangles), drawn from a seeded numpy generator, so the same
seed gives the same pixels as the JAX package's generator. The reference
ships five photographs in data/demo, which cannot be derived; the demo
generates these on first use when its directory holds no image. cv2 writes
the JPEGs, imported when called.
"""

import argparse
import os
import os.path as osp

import numpy as np

REPO_ROOT = osp.dirname(osp.dirname(osp.dirname(osp.abspath(__file__))))
DEFAULT_DEMO_DIR = osp.join(REPO_ROOT, "data", "demo")


def generate(out_dir, n=5, seed=3):
    import cv2
    rng = np.random.RandomState(seed)
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for i in range(n):
        h, w = (375, 500) if i % 2 == 0 else (500, 375)
        # textured background with a vertical luminance gradient
        im = rng.randint(30, 80, (h, w, 3)).astype(np.float32)
        im += np.linspace(60, 0, h, dtype=np.float32)[:, None, None]
        for _ in range(rng.randint(3, 7)):
            x1, y1 = rng.randint(0, w - 80), rng.randint(0, h - 80)
            bw = rng.randint(50, min(220, w - x1))
            bh = rng.randint(50, min(220, h - y1))
            color = rng.randint(120, 255, 3).astype(np.float32)
            im[y1:y1 + bh, x1:x1 + bw] = \
                0.2 * im[y1:y1 + bh, x1:x1 + bw] + 0.8 * color
        path = osp.join(out_dir, f"demo_{i:03d}.jpg")
        cv2.imwrite(path, np.uint8(np.clip(im, 0, 255)))
        paths.append(path)
    return paths


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=DEFAULT_DEMO_DIR)
    ap.add_argument("--n", type=int, default=5)
    ap.add_argument("--seed", type=int, default=3)
    args = ap.parse_args(argv)
    for p in generate(args.out, args.n, args.seed):
        print(p)


if __name__ == "__main__":
    main()
