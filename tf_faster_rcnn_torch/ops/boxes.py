"""Box math in torch with the legacy +1 width convention.

Port of ``tf_faster_rcnn_tpu/ops/boxes.py``: the same formulas in the same
float operation order, shape-polymorphic over leading batch dims.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["bbox_transform", "bbox_transform_inv", "clip_boxes",
           "bbox_overlaps", "BBOX_XFORM_CLIP"]

# Max dw/dh before exp(): log(1000/16). The JAX package evaluates it as a
# float32 log, so it is computed in float32 here too: the two clamps must
# agree bit for bit.
BBOX_XFORM_CLIP = float(np.log(np.float32(1000.0 / 16.0)))


def bbox_transform(ex_rois, gt_rois):
    """Encode gt boxes relative to example rois -> (dx, dy, dw, dh) targets.

    ex_rois, gt_rois: [..., 4] as (x1, y1, x2, y2).
    """
    ex_w = ex_rois[..., 2] - ex_rois[..., 0] + 1.0
    ex_h = ex_rois[..., 3] - ex_rois[..., 1] + 1.0
    ex_cx = ex_rois[..., 0] + 0.5 * ex_w
    ex_cy = ex_rois[..., 1] + 0.5 * ex_h

    gt_w = gt_rois[..., 2] - gt_rois[..., 0] + 1.0
    gt_h = gt_rois[..., 3] - gt_rois[..., 1] + 1.0
    gt_cx = gt_rois[..., 0] + 0.5 * gt_w
    gt_cy = gt_rois[..., 1] + 0.5 * gt_h

    dx = (gt_cx - ex_cx) / ex_w
    dy = (gt_cy - ex_cy) / ex_h
    dw = torch.log(gt_w / ex_w)
    dh = torch.log(gt_h / ex_h)
    return torch.stack([dx, dy, dw, dh], dim=-1)


def bbox_transform_inv(boxes, deltas, xform_clip=None):
    """Decode regression deltas against boxes.

    boxes: [..., N, 4]; deltas: [..., N, 4*K] (per-class stride-4 layout) or
    [..., N, 4]. xform_clip: optional cap on dw/dh before exp().
    Returns boxes of the same shape as deltas.
    """
    boxes = boxes.to(deltas.dtype)
    widths = boxes[..., 2] - boxes[..., 0] + 1.0
    heights = boxes[..., 3] - boxes[..., 1] + 1.0
    ctr_x = boxes[..., 0] + 0.5 * widths
    ctr_y = boxes[..., 1] + 0.5 * heights

    dx = deltas[..., 0::4]
    dy = deltas[..., 1::4]
    dw = deltas[..., 2::4]
    dh = deltas[..., 3::4]
    if xform_clip is not None:
        dw = torch.clamp(dw, max=xform_clip)
        dh = torch.clamp(dh, max=xform_clip)

    pred_cx = dx * widths[..., None] + ctr_x[..., None]
    pred_cy = dy * heights[..., None] + ctr_y[..., None]
    pred_w = torch.exp(dw) * widths[..., None]
    pred_h = torch.exp(dh) * heights[..., None]

    x1 = pred_cx - 0.5 * pred_w
    y1 = pred_cy - 0.5 * pred_h
    x2 = pred_cx + 0.5 * pred_w
    y2 = pred_cy + 0.5 * pred_h
    out = torch.stack([x1, y1, x2, y2], dim=-1)  # [..., N, K, 4]
    return out.reshape(deltas.shape)


def clip_boxes(boxes, im_hw):
    """Clip interleaved (x1, y1, x2, y2)*K boxes to [0, W-1] x [0, H-1].

    im_hw: (H, W) scalars, or a [..., 2] tensor of per-image extents that
    broadcasts over the box dims.
    """
    im_hw = torch.as_tensor(im_hw, dtype=boxes.dtype, device=boxes.device)
    h, w = im_hw[..., 0], im_hw[..., 1]
    if h.ndim > 0:
        h = h.reshape(h.shape + (1,) * (boxes.ndim - h.ndim))
        w = w.reshape(w.shape + (1,) * (boxes.ndim - w.ndim))
    shp = boxes.shape
    b = boxes.reshape(shp[:-1] + (shp[-1] // 4, 4))
    zero = boxes.new_zeros(())

    def clip(x, hi):
        return torch.minimum(torch.maximum(x, zero), hi - 1)

    out = torch.stack([clip(b[..., 0], w), clip(b[..., 1], h),
                       clip(b[..., 2], w), clip(b[..., 3], h)], dim=-1)
    return out.reshape(shp)


def bbox_overlaps(boxes, query_boxes, plus_one: bool = True):
    """Dense IoU [..., N, K] between boxes [..., N, 4] and query [..., K, 4].

    plus_one=True is the reference's +1-area IoU, False the standard IoU.
    Zero-area unions give 0 (no NaN).
    """
    e = 1.0 if plus_one else 0.0
    bx = boxes[..., :, None, :]
    qx = query_boxes[..., None, :, :]
    iw = (torch.minimum(bx[..., 2], qx[..., 2])
          - torch.maximum(bx[..., 0], qx[..., 0]) + e)
    ih = (torch.minimum(bx[..., 3], qx[..., 3])
          - torch.maximum(bx[..., 1], qx[..., 1]) + e)
    iw = torch.clamp(iw, min=0.0)
    ih = torch.clamp(ih, min=0.0)
    inter = iw * ih
    area_b = (bx[..., 2] - bx[..., 0] + e) * (bx[..., 3] - bx[..., 1] + e)
    area_q = (qx[..., 2] - qx[..., 0] + e) * (qx[..., 3] - qx[..., 1] + e)
    union = area_b + area_q - inter
    pos = union > 0
    return torch.where(pos, inter / torch.where(pos, union, 1.0),
                       torch.zeros((), dtype=inter.dtype, device=inter.device))
