"""Anchor generation.

A copy of ``tf_faster_rcnn_tpu/ops/anchors.py``, which cannot be imported
without JAX (its package ``__init__`` imports the jnp box ops). The tests
hold this copy equal to the original. ``generate_anchors`` reproduces the
reference's base-anchor table; ``anchor_grid_on`` shifts it over a feature
grid in (y, x, a) order, the RPN head's H x W x A channel layout, with torch
ops on a device. Every value is a half-integer, exact in float64 and in
float32, so the grid equals the original's numpy one bit for bit. It adds
each base coordinate to the shifts as a Python float, so the grid needs no
host copy (and no host sync) and traces into ``torch.export`` as plain ops.
``anchor_grid`` is the same grid as a numpy array.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["generate_anchors", "anchor_grid", "anchor_grid_on"]


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


def anchor_grid_on(feat_h: int, feat_w: int, device, feat_stride: int = 16,
                   anchor_scales=(8, 16, 32), anchor_ratios=(0.5, 1, 2),
                   base_size: int = 16):
    """All anchors over a feat_h x feat_w grid, [feat_h*feat_w*A, 4] float32
    on device, row-major over (y, x, a); base_size: generate_anchors'
    window (a pyramid level's own stride, models/fpn.py)."""
    base = generate_anchors(base_size=base_size,
                            ratios=np.array(anchor_ratios),
                            scales=np.array(anchor_scales))
    sx = torch.arange(feat_w, dtype=torch.float64, device=device)
    sy = torch.arange(feat_h, dtype=torch.float64, device=device)
    sy, sx = torch.meshgrid(sy * feat_stride, sx * feat_stride,
                            indexing="ij")
    cols = [torch.stack([shift + float(b) for b in base[:, c]], dim=-1)
            for c, shift in enumerate((sx, sy, sx, sy))]     # [fh, fw, A]
    return torch.stack(cols, dim=-1).reshape(-1, 4).to(torch.float32)


def anchor_grid(feat_h: int, feat_w: int, feat_stride: int = 16,
                anchor_scales=(8, 16, 32), anchor_ratios=(0.5, 1, 2),
                base_size: int = 16):
    """anchor_grid_on's grid as a numpy array, built on the CPU."""
    return anchor_grid_on(feat_h, feat_w, "cpu", feat_stride, anchor_scales,
                          anchor_ratios, base_size).numpy()
