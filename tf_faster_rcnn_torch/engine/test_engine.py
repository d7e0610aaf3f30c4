"""The detect step of the evaluation engine.

Port of ``make_detect_fn`` from ``tf_faster_rcnn_tpu/engine/test_engine.py``.
``im_detect`` and ``test_net`` are not ported yet: they read images through
``data/blob.py``, which needs cv2 (ROADMAP.md, Queue A).
"""

from __future__ import annotations

import torch

from tf_faster_rcnn_torch.engine.detect import postprocess_detections

__all__ = ["make_detect_fn"]


def make_detect_fn(model, spec):
    """(image, im_info, orig_hw) -> (detections, valid), under
    torch.inference_mode. The postprocess settings come from spec
    (spec_from_cfg snapshots TEST.NMS, TEST.BBOX_REG and TPU.MAX_PER_IMAGE).

    image [B, H, W, 3], im_info [B, 3] and orig_hw [B, 2] are tensors on the
    model's device. detections: [B, max_per_image, 6] as (cls, score, x1,
    y1, x2, y2) in original image coordinates; valid: [B, max_per_image].
    """
    @torch.inference_mode()
    def detect(image, im_info, orig_hw):
        out = model(image, im_info)
        return postprocess_detections(
            out["rois"], out["roi_valid"], out["cls_prob"], out["bbox_pred"],
            im_info, orig_hw, num_classes=spec.num_classes,
            max_per_image=spec.max_per_image, nms_thresh=spec.nms_thresh,
            bbox_reg=spec.bbox_reg)

    return detect
