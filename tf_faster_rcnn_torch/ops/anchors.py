"""Anchor generation, in numpy.

A copy of ``tf_faster_rcnn_tpu/ops/anchors.py``, which cannot be imported
without JAX (its package ``__init__`` imports the jnp box ops). The tests
hold this copy equal to the original. ``generate_anchors`` reproduces the
reference's base-anchor table; ``anchor_grid`` shifts it over a feature grid
in (y, x, a) order, the RPN head's H x W x A channel layout.
"""

from __future__ import annotations

import numpy as np

__all__ = ["generate_anchors", "anchor_grid"]


def _whctrs(anchor):
    w = anchor[2] - anchor[0] + 1
    h = anchor[3] - anchor[1] + 1
    x_ctr = anchor[0] + 0.5 * (w - 1)
    y_ctr = anchor[1] + 0.5 * (h - 1)
    return w, h, x_ctr, y_ctr


def _mkanchors(ws, hs, x_ctr, y_ctr):
    ws = ws[:, None]
    hs = hs[:, None]
    return np.hstack((x_ctr - 0.5 * (ws - 1),
                      y_ctr - 0.5 * (hs - 1),
                      x_ctr + 0.5 * (ws - 1),
                      y_ctr + 0.5 * (hs - 1)))


def generate_anchors(base_size=16, ratios=(0.5, 1, 2), scales=(8, 16, 32)):
    """Base anchors around a (0,0,15,15) window: ratios x scales, [A, 4]."""
    ratios = np.asarray(ratios, dtype=np.float64)
    scales = np.asarray(scales, dtype=np.float64)
    base = np.array([1, 1, base_size, base_size], dtype=np.float64) - 1

    w, h, x_ctr, y_ctr = _whctrs(base)
    size = w * h
    ws = np.round(np.sqrt(size / ratios))
    hs = np.round(ws * ratios)
    ratio_anchors = _mkanchors(ws, hs, x_ctr, y_ctr)

    out = []
    for i in range(ratio_anchors.shape[0]):
        w, h, x_ctr, y_ctr = _whctrs(ratio_anchors[i])
        out.append(_mkanchors(w * scales, h * scales, x_ctr, y_ctr))
    return np.vstack(out)


def anchor_grid(feat_h: int, feat_w: int, feat_stride: int = 16,
                anchor_scales=(8, 16, 32), anchor_ratios=(0.5, 1, 2)):
    """All anchors over a feat_h x feat_w grid, [feat_h*feat_w*A, 4] f32,
    row-major over (y, x, a)."""
    base = generate_anchors(ratios=np.array(anchor_ratios),
                            scales=np.array(anchor_scales))
    A = base.shape[0]
    shift_x = np.arange(0, feat_w) * feat_stride
    shift_y = np.arange(0, feat_h) * feat_stride
    sx, sy = np.meshgrid(shift_x, shift_y)
    shifts = np.stack([sx.ravel(), sy.ravel(), sx.ravel(), sy.ravel()], axis=1)
    K = shifts.shape[0]
    anchors = base.reshape(1, A, 4) + shifts.reshape(K, 1, 4)
    return anchors.reshape(K * A, 4).astype(np.float32)
