"""Test-time detection: decode, per-class NMS, global cap, all on device.

Port of ``tf_faster_rcnn_tpu/engine/detect.py``: a fixed-shape postprocess
whose batch x class NMS problems all run in one launch of kernel K2
(``ops/nms_kernels.py::batched_nms_keep``), then a top-k over the masked
class-score table into a [max_per_image, 6] slab with a validity mask.
Every sort is a stable descending ``torch.sort``, so ties resolve to the
lower index as ``lax.top_k`` resolves them.

``multiclass_nms`` is one image's per-class keep mask, kept as API and as a
test oracle; the batched postprocess is the production path.
"""

from __future__ import annotations

import torch

from tf_faster_rcnn_torch.ops.boxes import (BBOX_XFORM_CLIP,
                                            bbox_transform_inv, clip_boxes)
from tf_faster_rcnn_torch.ops.nms import sorted_nms
from tf_faster_rcnn_torch.ops.nms_kernels import batched_nms_keep

__all__ = ["class_boxes", "postprocess_detections", "multiclass_nms"]


def _batched_keep(sorted_boxes, sorted_valid, nms_thresh):
    """Exact greedy keep masks for G score-sorted instances [G, N], with the
    reference engine's NMS: +1 IoU, suppress at iou > thresh."""
    return batched_nms_keep(sorted_boxes.contiguous(),
                            sorted_valid.contiguous(), float(nms_thresh),
                            plus_one=True, suppress_eq=False)


def multiclass_nms(boxes, scores, valid, nms_thresh, *, plus_one=True,
                   score_thresh=0.0):
    """Per-class NMS keep mask for one image.

    boxes: [C, R, 4]; scores: [C, R]; valid: [C, R]. Returns keep [C, R]
    bool in the ORIGINAL box order: box r of class c is kept iff it is
    valid, scores above score_thresh and survives greedy NMS among its
    class (+1 IoU by default, suppress at iou > thresh). All classes go
    through one K1 call (sorted_nms); the scatter back to the original order
    makes no host sync.
    """
    c, r = scores.shape
    idx, ok = sorted_nms(boxes, scores, valid & (scores > score_thresh),
                         nms_thresh, r, plus_one=plus_one, suppress_eq=False)
    keep = torch.zeros((c, r + 1), dtype=torch.bool, device=scores.device)
    keep.scatter_(1, torch.where(ok, idx, r), ok)     # dropped slots: col r
    return keep[:, :r]


def _top(x, k):
    """lax.top_k along the last dim: values and indices, ties to the lower
    index."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def class_boxes(rois, cls_prob, bbox_pred, im_info, orig_hw, *,
                num_classes: int, bbox_reg: bool = True):
    """Each foreground class's boxes and scores, as the postprocess ranks
    them: (boxes [B, K-1, R, 4] decoded, clipped to the original image,
    scores [B, K-1, R]). Arguments as postprocess_detections'."""
    k = num_classes
    b, r, _ = rois.shape
    boxes = rois / im_info[:, 2][:, None, None]
    if bbox_reg:
        pred = bbox_transform_inv(boxes, bbox_pred,
                                  xform_clip=BBOX_XFORM_CLIP)
        pred = clip_boxes(pred, orig_hw)
    else:
        pred = boxes.repeat(1, 1, k)
    pb = pred.reshape(b, r, k, 4).permute(0, 2, 1, 3)[:, 1:]
    return pb, cls_prob.permute(0, 2, 1)[:, 1:]


def postprocess_detections(rois, roi_valid, cls_prob, bbox_pred, im_info,
                           orig_hw, *, num_classes: int,
                           max_per_image: int = 100,
                           nms_thresh: float = 0.3,
                           score_thresh: float = 0.0,
                           bbox_reg: bool = True):
    """Full batched postprocess.

    rois: [B, R, 4] proposals in scaled-image coords; roi_valid: [B, R];
    cls_prob: [B, R, K]; bbox_pred: [B, R, 4K] (already un-normalized);
    im_info: [B, 3] (h_scaled, w_scaled, scale); orig_hw: [B, 2] original
    image (h, w) for the clip.

    Returns (detections [B, max_per_image, 6] as (cls, score, x1, y1, x2,
    y2) in original-image coords, valid [B, max_per_image]).
    """
    b, r, _ = rois.shape
    kc = num_classes - 1
    pb, ps = class_boxes(rois, cls_prob, bbox_pred, im_info, orig_hw,
                         num_classes=num_classes, bbox_reg=bbox_reg)
    pv = roi_valid[:, None, :] & (ps > score_thresh)

    g = b * kc
    fb = pb.reshape(g, r, 4)
    fs = ps.reshape(g, r)
    fv = pv.reshape(g, r)

    neg = torch.tensor(-1.0e10, dtype=torch.float32, device=rois.device)
    top_s, order = _top(torch.where(fv, fs, neg), r)           # [G, R]
    sb = torch.gather(fb, 1, order[..., None].expand(-1, -1, 4))
    sv = top_s > neg / 2

    keep = _batched_keep(sb, sv, nms_thresh)                   # sorted order

    masked = torch.where(keep, top_s, torch.full_like(top_s, -float("inf")))
    flat = masked.reshape(b, kc * r)
    cap = min(max_per_image, kc * r)
    top_s2, top_i = _top(flat, cap)                            # [B, cap]
    cls_idx = top_i // r + 1
    boxes_flat = sb.reshape(b, kc * r, 4)
    out_boxes = torch.gather(boxes_flat, 1, top_i[..., None].expand(-1, -1, 4))
    det = torch.cat([cls_idx[..., None].to(torch.float32), top_s2[..., None],
                     out_boxes], dim=-1)
    dv = torch.isfinite(top_s2)
    det = torch.where(dv[..., None], det, torch.zeros_like(det))
    if cap < max_per_image:
        det = torch.nn.functional.pad(det, (0, 0, 0, max_per_image - cap))
        dv = torch.nn.functional.pad(dv, (0, max_per_image - cap))
    return det, dv
