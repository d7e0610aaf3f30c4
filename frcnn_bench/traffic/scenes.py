"""The one generator of the benchmark's traffic: a pool of VOC-sized scenes.

A traffic mix is a JSON file beside this one, of parameters only:

* ``batch``: images a step; ``pool``: images in the pool, taken in turn;
* ``long_side`` and ``short_side`` [lo, hi]: the original sizes, VOC's
  (one side 500, the other from 333 to 500), spread evenly over the range;
* ``portrait_share``: the share of the pool that stands upright;
* ``objects`` and ``object_weights``: how many rectangles (and GT boxes)
  an image holds, in those proportions;
* ``flip_share``: the share of images flipped left-right (TRAIN).

A step takes the next ``batch`` images of the pool; a batch of more than
one image keeps one orientation (``portrait_share`` 0), and a request of
one image goes on its own orientation's canvas. The entry sizes each image
by its phase's SCALES[0] and MAX_SIZE (TEST to detect, TRAIN to train).

Every seed gets the same multiset of sizes, orientations, object counts
and flips, in its own order, so the seed changes what is drawn and never
how much work there is. An image is uint8 BGR: dark noise (0-59) with
bright solid rectangles (140-254), the scenes of the repository's bench;
its GT boxes are those rectangles with a class drawn from 1..K-1.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np
import torch

__all__ = ["Pool", "make_pool", "quota"]


@dataclasses.dataclass
class Pool:
    images: List[np.ndarray]      # uint8 [h, w, 3] BGR, host memory
    gt: List[np.ndarray]          # float32 [n, 5] (x1, y1, x2, y2, class)
    flipped: List[bool]

    def __len__(self):
        return len(self.images)


def quota(n: int, weights) -> List[int]:
    """n items split over len(weights) kinds in those proportions (largest
    remainder), as one list of kind indices in kind order."""
    w = np.asarray(weights, np.float64)
    raw = n * w / w.sum()
    count = np.floor(raw).astype(int)
    for i in np.argsort(-(raw - count), kind="stable")[:n - count.sum()]:
        count[i] += 1
    return [k for k, c in enumerate(count) for _ in range(c)]


def make_pool(traffic: dict, num_classes: int, seed: int, device) -> Pool:
    """The pool of a traffic mix for seed; pixels drawn on device, then
    kept on the host, where a request's image lies before it is sent."""
    n = int(traffic["pool"])
    rng = np.random.default_rng([int(seed), 1])
    lo, hi = traffic["short_side"]
    shorts = np.round(np.linspace(lo, hi, n)).astype(int)
    upright = np.arange(n) < round(n * traffic["portrait_share"])
    counts = np.asarray(traffic["objects"])[quota(
        n, traffic["object_weights"])]
    flips = np.arange(n) < round(n * traffic.get("flip_share", 0.0))
    shorts, upright, counts, flips = (rng.permutation(x) for x in
                                      (shorts, upright, counts, flips))
    gen = torch.Generator(device=device).manual_seed(int(seed) * 2 + 1)
    images, gts = [], []
    long_side = int(traffic["long_side"])
    for i in range(n):
        h, w = long_side, int(shorts[i])
        if not upright[i]:
            h, w = w, h
        im = torch.randint(0, 60, (h, w, 3), generator=gen, device=device,
                           dtype=torch.uint8)
        gt = np.zeros((int(counts[i]), 5), np.float32)
        # the bench's rectangles: a corner 40 px from the far edges, a side
        # of 30 px up to half the image (both shrink for a small image)
        edge, least = min(40, min(h, w) // 3), min(30, min(h, w) // 4)
        for j in range(int(counts[i])):
            x1 = int(rng.integers(0, w - edge))
            y1 = int(rng.integers(0, h - edge))
            x2 = x1 + int(rng.integers(least, min(w - x1, w // 2)))
            y2 = y1 + int(rng.integers(least, min(h - y1, h // 2)))
            im[y1:y2, x1:x2] = torch.from_numpy(
                rng.integers(140, 255, 3).astype(np.uint8)).to(device)
            gt[j] = (x1, y1, x2 - 1, y2 - 1, rng.integers(1, num_classes))
        images.append(im)
        gts.append(gt)
    host = [im.cpu().numpy() for im in images]
    return Pool(host, gts, [bool(f) for f in flips])
