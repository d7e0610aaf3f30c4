"""The Faster R-CNN detector in TEST mode, as one torch module.

Port of ``tf_faster_rcnn_tpu/models/network.py`` (``ModelSpec``,
``spec_from_cfg``, ``FasterRCNN``) for the ResNet backbones with
``TEST.MODE='nms'``: backbone head, RPN, anchor decode, NMS proposal
selection (kernel K1), RoI crop, tail, heads and bbox un-normalization. The
public layouts are the JAX ones: the image is NHWC [B, H, W, 3] and the
output dict has the keys and shapes of ``FasterRCNN.__call__``. Inside, the
convolutions run in NCHW.

Not ported yet (ROADMAP.md, "North star" and Queue A): TRAIN mode, the
'top' proposal mode, vgg16 and mobilenet, the space-to-depth stem, and
compute dtypes other than float32. Each raises NotImplementedError.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from tf_faster_rcnn_torch.models import resnet_v1
from tf_faster_rcnn_torch.ops.anchors import anchor_grid
from tf_faster_rcnn_torch.ops.boxes import (BBOX_XFORM_CLIP,
                                            bbox_transform_inv, clip_boxes)
from tf_faster_rcnn_torch.ops.nms import sorted_nms
from tf_faster_rcnn_torch.ops.roi_align import roi_crop_pool

__all__ = ["ModelSpec", "FasterRCNN", "spec_from_cfg"]

RESNETS = ("res50", "res101", "res152")
_TODO = "not ported yet; see ROADMAP.md (North star, Queue A)"


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    """Static snapshot of what the TEST graph needs from cfg. The field
    names are those of the JAX ModelSpec, plus the three postprocess
    settings that the JAX make_detect_fn reads from cfg itself, so that the
    detect path runs without the config module."""
    backbone: str
    num_classes: int
    anchor_scales: Tuple[int, ...] = (8, 16, 32)
    anchor_ratios: Tuple[float, ...] = (0.5, 1.0, 2.0)
    feat_stride: int = 16
    rpn_channels: int = 512
    pooling_size: int = 7
    resnet_max_pool: bool = False
    rpn_pre_nms_top_n: int = 6000
    rpn_post_nms_top_n: int = 300
    rpn_nms_thresh: float = 0.7
    bbox_normalize: bool = True
    bbox_normalize_means: Tuple[float, ...] = (0.0, 0.0, 0.0, 0.0)
    bbox_normalize_stds: Tuple[float, ...] = (0.1, 0.1, 0.2, 0.2)
    nms_thresh: float = 0.3        # TEST.NMS
    bbox_reg: bool = True          # TEST.BBOX_REG
    max_per_image: int = 100       # TPU.MAX_PER_IMAGE

    @property
    def num_anchors(self) -> int:
        return len(self.anchor_scales) * len(self.anchor_ratios)


def spec_from_cfg(backbone: str, num_classes: int, mode: str) -> ModelSpec:
    """Snapshot the port's global cfg (``tf_faster_rcnn_torch/config.py``).
    The detect path itself never reads cfg: a ModelSpec built directly, with
    its defaults (the cfg defaults), runs without the config module."""
    from tf_faster_rcnn_torch.config import cfg
    if mode != "TEST":
        raise NotImplementedError(f"mode {mode!r}: TRAIN is {_TODO}")
    if cfg.TEST.MODE != "nms":
        raise NotImplementedError(f"TEST.MODE {cfg.TEST.MODE!r} is {_TODO}")
    if cfg.TPU.SPACE_TO_DEPTH:
        raise NotImplementedError(
            "TPU.SPACE_TO_DEPTH is a TPU stem workaround; the port runs the "
            "plain 7x7 stem (ROADMAP.md, Rules of the port)")
    if cfg.TPU.COMPUTE_DTYPE != "float32":
        raise NotImplementedError(
            f"compute dtype {cfg.TPU.COMPUTE_DTYPE!r} is {_TODO}")
    if cfg.POOLING_MODE != "crop":
        raise NotImplementedError(
            f"POOLING_MODE {cfg.POOLING_MODE!r}: only 'crop' exists")
    pre = int(cfg.TEST.RPN_PRE_NMS_TOP_N)
    if cfg.TPU.RPN_NMS_CAP:
        pre = int(cfg.TPU.RPN_NMS_CAP)
    spec = ModelSpec(
        backbone=backbone,
        num_classes=num_classes,
        anchor_scales=tuple(cfg.ANCHOR_SCALES),
        anchor_ratios=tuple(cfg.ANCHOR_RATIOS),
        rpn_channels=int(cfg.RPN_CHANNELS),
        pooling_size=int(cfg.POOLING_SIZE),
        resnet_max_pool=bool(cfg.RESNET.MAX_POOL),
        rpn_pre_nms_top_n=pre,
        rpn_post_nms_top_n=int(cfg.TEST.RPN_POST_NMS_TOP_N),
        rpn_nms_thresh=float(cfg.TEST.RPN_NMS_THRESH),
        bbox_normalize=bool(cfg.TRAIN.BBOX_NORMALIZE_TARGETS_PRECOMPUTED),
        bbox_normalize_means=tuple(cfg.TRAIN.BBOX_NORMALIZE_MEANS),
        bbox_normalize_stds=tuple(cfg.TRAIN.BBOX_NORMALIZE_STDS),
        nms_thresh=float(cfg.TEST.NMS),
        bbox_reg=bool(cfg.TEST.BBOX_REG),
        max_per_image=int(cfg.TPU.MAX_PER_IMAGE),
    )
    _check_supported(spec)
    return spec


def _check_supported(spec: ModelSpec):
    if spec.backbone not in RESNETS:
        raise NotImplementedError(f"backbone {spec.backbone!r} is {_TODO}")


class FasterRCNN(nn.Module):
    """TEST-mode Faster R-CNN with a ResNet backbone.

    Submodule names follow the flax ones: ``head``, ``rpn_conv``,
    ``rpn_cls_score``, ``rpn_bbox_pred``, ``tail``, ``cls_score``,
    ``bbox_pred``.

    The parameters are built on ``device``: the CUDA device when it is None,
    and a RuntimeError when there is none (nothing falls back to the CPU);
    the CPU only when asked for (``device="cpu"``).
    """

    def __init__(self, spec: ModelSpec, device=None):
        super().__init__()
        _check_supported(spec)
        if device is None:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "FasterRCNN builds on the CUDA device by default and "
                    "torch finds none; pass device='cpu' to build on the CPU")
            device = "cuda"
        self.spec = spec
        depth = int(spec.backbone[3:])
        a = spec.num_anchors
        self.head = resnet_v1.ResNetV1Head(depth)
        self.rpn_conv = nn.Conv2d(1024, spec.rpn_channels, 3, padding=1)
        self.rpn_cls_score = nn.Conv2d(spec.rpn_channels, 2 * a, 1)
        self.rpn_bbox_pred = nn.Conv2d(spec.rpn_channels, 4 * a, 1)
        self.tail = resnet_v1.ResNetV1Tail(depth)
        self.cls_score = nn.Linear(2048, spec.num_classes)
        self.bbox_pred = nn.Linear(2048, 4 * spec.num_classes)
        self._anchors = {}
        self.to(device)

    def anchors(self, fh: int, fw: int, device) -> torch.Tensor:
        """The [fh*fw*A, 4] anchor grid on device, built once per shape."""
        key = (fh, fw, str(device))
        if key not in self._anchors:
            s = self.spec
            self._anchors[key] = torch.from_numpy(anchor_grid(
                fh, fw, s.feat_stride, s.anchor_scales,
                s.anchor_ratios)).to(device)
        return self._anchors[key]

    def _proposals(self, anchors, rpn_bbox, fg_scores, im_info, fw: int):
        """Decode, clip, mask anchors past each image's extent, then sorted
        NMS (kernel K1 over all B images at once) into post_nms_top_n slots.

        anchors [N, 4]; rpn_bbox [B, N, 4]; fg_scores [B, N]; im_info [B, 3].
        Returns (rois [B, R, 4], roi_scores [B, R], roi_valid [B, R]).
        """
        s = self.spec
        cell = torch.arange(anchors.shape[0], device=anchors.device)
        cell = cell // s.num_anchors
        cy, cx = cell // fw, cell % fw
        boxes = bbox_transform_inv(anchors, rpn_bbox,
                                   xform_clip=BBOX_XFORM_CLIP)
        boxes = clip_boxes(boxes, im_info[:, :2])
        ext = torch.ceil(im_info[:, :2] / s.feat_stride)
        avalid = (cy < ext[:, :1]) & (cx < ext[:, 1:])
        idx, valid = sorted_nms(
            boxes, fg_scores, avalid, s.rpn_nms_thresh, s.rpn_post_nms_top_n,
            plus_one=False, suppress_eq=False,
            pre_sort_k=min(s.rpn_pre_nms_top_n, fg_scores.shape[1]))
        rois = torch.gather(boxes, 1, idx[..., None].expand(-1, -1, 4))
        return rois, torch.gather(fg_scores, 1, idx), valid

    def _roi_heads(self, net_conv, rois, im_info):
        """Crop each RoI from net_conv [B, C, fh, fw] (samples past the
        image's feature extent read 0.0), run the tail and the class and box
        heads, and un-normalize the box deltas.

        Returns (cls_score [B, R, K], bbox_pred [B, R, 4K]), float32.
        """
        s = self.spec
        b, r = rois.shape[:2]
        feat_valid = torch.ceil(im_info[:, :2] / float(s.feat_stride))
        pooled = roi_crop_pool(net_conv.permute(0, 2, 3, 1), rois,
                               s.feat_stride, s.pooling_size,
                               max_pool=s.resnet_max_pool, valid_hw=feat_valid)
        pooled = pooled.reshape(b * r, s.pooling_size, s.pooling_size, -1)
        fc7 = self.tail(pooled.permute(0, 3, 1, 2))
        cls_score = self.cls_score(fc7).to(torch.float32)
        bbox_pred = self.bbox_pred(fc7).to(torch.float32)
        cls_score = cls_score.reshape(b, r, s.num_classes)
        bbox_pred = bbox_pred.reshape(b, r, 4 * s.num_classes)
        if s.bbox_normalize:
            stds = torch.tensor(s.bbox_normalize_stds, dtype=torch.float32,
                                device=rois.device).repeat(s.num_classes)
            means = torch.tensor(s.bbox_normalize_means, dtype=torch.float32,
                                 device=rois.device).repeat(s.num_classes)
            bbox_pred = bbox_pred * stds + means
        return cls_score, bbox_pred

    def forward(self, image, im_info):
        """image: [B, H, W, 3] mean-subtracted BGR on the static canvas;
        im_info: [B, 3] (h, w, scale) true extents. Returns the dict of
        FasterRCNN.__call__ in TEST mode."""
        s = self.spec
        a = s.num_anchors
        b, hh, ww, _ = image.shape
        if hh % s.feat_stride or ww % s.feat_stride:
            raise ValueError(f"canvas {hh}x{ww} is not a multiple of the "
                             f"feature stride {s.feat_stride}")
        im_info = im_info.to(torch.float32)

        x = image.to(torch.float32).permute(0, 3, 1, 2)
        net_conv = self.head(x, im_info[:, :2])           # [B, 1024, fh, fw]
        fh, fw = net_conv.shape[2], net_conv.shape[3]
        anchors = self.anchors(fh, fw, image.device)
        n_anchors = fh * fw * a

        rpn = F.relu(self.rpn_conv(net_conv))
        # NHWC before the flatten: anchors run in (y, x, a) order
        cls = self.rpn_cls_score(rpn).permute(0, 2, 3, 1)
        rpn_deltas = self.rpn_bbox_pred(rpn).permute(0, 2, 3, 1)
        # channel c < A is the bg logit and c + A the fg logit of anchor c
        score_pairs = torch.stack([cls[..., :a], cls[..., a:]], dim=-1)
        score_pairs = score_pairs.reshape(b, n_anchors, 2).to(torch.float32)
        fg_prob = torch.softmax(score_pairs, dim=-1)[..., 1]
        rpn_deltas = rpn_deltas.reshape(b, n_anchors, 4).to(torch.float32)

        rois, roi_scores, roi_valid = self._proposals(
            anchors, rpn_deltas, fg_prob, im_info, fw)

        cls_score, bbox_pred = self._roi_heads(net_conv, rois, im_info)
        return {
            "rpn_cls_score": score_pairs,    # [B, N, 2]
            "rpn_bbox_pred": rpn_deltas,     # [B, N, 4]
            "anchors": anchors,              # [N, 4]
            "rois": rois,                    # [B, R, 4]
            "roi_valid": roi_valid,          # [B, R]
            "roi_scores": roi_scores,        # [B, R]
            "cls_score": cls_score,          # [B, R, K]
            "cls_prob": torch.softmax(cls_score, dim=-1),
            "bbox_pred": bbox_pred,          # [B, R, 4K]
        }

