"""Box-array helpers for dataset code.

A copy of ``tf_faster_rcnn_tpu/datasets/ds_utils.py``.

Same surface as the reference's ds_utils (reference
lib/datasets/ds_utils.py:13-49): dedup, xywh<->xyxy in the legacy +1-width
convention, bounds validation, and the small-box filter (whose >=/> width
vs height asymmetry is preserved as-is).
"""

from __future__ import annotations

import numpy as np


def unique_boxes(boxes, scale=1.0):
    """Sorted indices of the first occurrence of each distinct box, after
    rounding coordinates at the given scale."""
    quantized = np.round(np.asarray(boxes) * scale).astype(np.int64)
    _, first = np.unique(quantized, axis=0, return_index=True)
    return np.sort(first)


def xywh_to_xyxy(boxes):
    x, y, w, h = np.asarray(boxes).T
    return np.stack([x, y, x + w - 1, y + h - 1], axis=1)


def xyxy_to_xywh(boxes):
    x1, y1, x2, y2 = np.asarray(boxes).T
    return np.stack([x1, y1, x2 - x1 + 1, y2 - y1 + 1], axis=1)


def validate_boxes(boxes, width=0, height=0):
    """Assert every box is inside a width x height image and not inverted."""
    boxes = np.asarray(boxes)
    checks = [
        ('x1 < 0', (boxes[:, 0] >= 0)),
        ('y1 < 0', (boxes[:, 1] >= 0)),
        ('x2 < x1', (boxes[:, 2] >= boxes[:, 0])),
        ('y2 < y1', (boxes[:, 3] >= boxes[:, 1])),
        ('x2 >= width', (boxes[:, 2] < width)),
        ('y2 >= height', (boxes[:, 3] < height)),
    ]
    for what, ok in checks:
        assert ok.all(), f'invalid box: {what}'


def filter_small_boxes(boxes, min_size):
    boxes = np.asarray(boxes)
    wide = (boxes[:, 2] - boxes[:, 0]) >= min_size
    tall = (boxes[:, 3] - boxes[:, 1]) > min_size
    return np.flatnonzero(wide & tall)
