"""The Faster R-CNN detector, as one torch module.

Port of ``tf_faster_rcnn_tpu/models/network.py`` (``ModelSpec``,
``spec_from_cfg``, ``FasterRCNN``, ``trainable_mask``) for the ResNet
backbones with ``TEST.MODE='nms'``: backbone head, RPN, anchor decode, NMS
proposal selection (kernel K1), in TRAIN mode the two target samplers, RoI
crop, tail, heads and, in TEST mode, bbox un-normalization. The public
layouts are the JAX ones: the image is NHWC [B, H, W, 3] and the output
dict has the keys and shapes of ``FasterRCNN.__call__``. Inside, the
convolutions run in NCHW.

The samplers' uniform noise is an input (``TrainNoise``): the caller passes
it, or the forward draws it from a ``torch.Generator``.

Not ported yet (ROADMAP.md, "North star" and Queue A): the 'top' proposal
mode, vgg16 and mobilenet, the space-to-depth stem, and compute or
parameter dtypes other than float32. Each raises NotImplementedError.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from tf_faster_rcnn_torch.models import resnet_v1
from tf_faster_rcnn_torch.models.targets import anchor_target, proposal_target
from tf_faster_rcnn_torch.ops.anchors import anchor_grid
from tf_faster_rcnn_torch.ops.boxes import (BBOX_XFORM_CLIP,
                                            bbox_transform_inv, clip_boxes)
from tf_faster_rcnn_torch.ops.nms import sorted_nms
from tf_faster_rcnn_torch.ops.roi_align import roi_crop_pool

__all__ = ["ModelSpec", "FasterRCNN", "TrainNoise", "draw_noise",
           "spec_from_cfg", "trainable_mask"]

RESNETS = ("res50", "res101", "res152")
_TODO = "not ported yet; see ROADMAP.md (North star, Queue A)"


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    """Static snapshot of what the graph needs from cfg. The field names
    are those of the JAX ModelSpec, plus the three postprocess settings that
    the JAX make_detect_fn reads from cfg itself, so that the detect path
    runs without the config module."""
    backbone: str
    num_classes: int
    mode: str = "TEST"             # 'TRAIN' | 'TEST'
    anchor_scales: Tuple[int, ...] = (8, 16, 32)
    anchor_ratios: Tuple[float, ...] = (0.5, 1.0, 2.0)
    feat_stride: int = 16
    rpn_channels: int = 512
    pooling_size: int = 7
    resnet_max_pool: bool = False
    rpn_pre_nms_top_n: int = 6000
    rpn_post_nms_top_n: int = 300
    rpn_nms_thresh: float = 0.7
    # freeze prefix (RESNET.FIXED_BLOCKS): the stem and blocks 1..N
    fixed_blocks: int = 1
    # RPN target sampling (TRAIN)
    rpn_batchsize: int = 256
    rpn_fg_fraction: float = 0.5
    rpn_positive_overlap: float = 0.7
    rpn_negative_overlap: float = 0.3
    rpn_clobber_positives: bool = False
    rpn_positive_weight: float = -1.0
    rpn_bbox_inside_weights: Tuple[float, ...] = (1.0, 1.0, 1.0, 1.0)
    # RoI target sampling (TRAIN)
    roi_batch_size: int = 128
    fg_fraction: float = 0.25
    fg_thresh: float = 0.5
    bg_thresh_hi: float = 0.5
    bg_thresh_lo: float = 0.1
    use_gt: bool = False
    bbox_inside_weights: Tuple[float, ...] = (1.0, 1.0, 1.0, 1.0)
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
    phase = cfg.TRAIN if mode == "TRAIN" else cfg.TEST
    if mode == "TEST" and cfg.TEST.MODE != "nms":
        raise NotImplementedError(f"TEST.MODE {cfg.TEST.MODE!r} is {_TODO}")
    if cfg.TPU.SPACE_TO_DEPTH:
        raise NotImplementedError(
            "TPU.SPACE_TO_DEPTH is a TPU stem workaround; the port runs the "
            "plain 7x7 stem (ROADMAP.md, Rules of the port)")
    for key in ("COMPUTE_DTYPE", "PARAM_DTYPE"):
        if cfg.TPU[key] != "float32":
            raise NotImplementedError(
                f"TPU.{key} {cfg.TPU[key]!r} is {_TODO}")
    if cfg.POOLING_MODE != "crop":
        raise NotImplementedError(
            f"POOLING_MODE {cfg.POOLING_MODE!r}: only 'crop' exists")
    pre = int(phase.RPN_PRE_NMS_TOP_N)
    if cfg.TPU.RPN_NMS_CAP:
        pre = int(cfg.TPU.RPN_NMS_CAP)
    spec = ModelSpec(
        backbone=backbone,
        num_classes=num_classes,
        mode=mode,
        anchor_scales=tuple(cfg.ANCHOR_SCALES),
        anchor_ratios=tuple(cfg.ANCHOR_RATIOS),
        rpn_channels=int(cfg.RPN_CHANNELS),
        pooling_size=int(cfg.POOLING_SIZE),
        resnet_max_pool=bool(cfg.RESNET.MAX_POOL),
        rpn_pre_nms_top_n=pre,
        rpn_post_nms_top_n=int(phase.RPN_POST_NMS_TOP_N),
        rpn_nms_thresh=float(phase.RPN_NMS_THRESH),
        fixed_blocks=int(cfg.RESNET.FIXED_BLOCKS),
        rpn_batchsize=int(cfg.TRAIN.RPN_BATCHSIZE),
        rpn_fg_fraction=float(cfg.TRAIN.RPN_FG_FRACTION),
        rpn_positive_overlap=float(cfg.TRAIN.RPN_POSITIVE_OVERLAP),
        rpn_negative_overlap=float(cfg.TRAIN.RPN_NEGATIVE_OVERLAP),
        rpn_clobber_positives=bool(cfg.TRAIN.RPN_CLOBBER_POSITIVES),
        rpn_positive_weight=float(cfg.TRAIN.RPN_POSITIVE_WEIGHT),
        rpn_bbox_inside_weights=tuple(cfg.TRAIN.RPN_BBOX_INSIDE_WEIGHTS),
        roi_batch_size=int(cfg.TRAIN.BATCH_SIZE),
        fg_fraction=float(cfg.TRAIN.FG_FRACTION),
        fg_thresh=float(cfg.TRAIN.FG_THRESH),
        bg_thresh_hi=float(cfg.TRAIN.BG_THRESH_HI),
        bg_thresh_lo=float(cfg.TRAIN.BG_THRESH_LO),
        use_gt=bool(cfg.TRAIN.USE_GT),
        bbox_inside_weights=tuple(cfg.TRAIN.BBOX_INSIDE_WEIGHTS),
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
    if spec.mode not in ("TRAIN", "TEST"):
        raise ValueError(f"mode {spec.mode!r}: 'TRAIN' or 'TEST'")


class TrainNoise(NamedTuple):
    """The uniform [0, 1) noise that ranks sampling candidates in TRAIN
    mode, in the order the JAX package draws it: the anchors' fg and bg
    noise [B, N], then the proposals' fg and bg noise [B, R'] (R' = post-NMS
    proposals, plus the gt rows under use_gt)."""
    anchor_fg: torch.Tensor
    anchor_bg: torch.Tensor
    roi_fg: torch.Tensor
    roi_bg: torch.Tensor


def draw_noise(generator: Optional[torch.Generator], batch: int,
               n_anchors: int, n_rois: int, device) -> TrainNoise:
    """One training step's TrainNoise, drawn on device from generator (a
    generator of that device, or None for torch's default one)."""
    return TrainNoise(*(
        torch.rand((batch, n), generator=generator, device=device)
        for n in (n_anchors, n_anchors, n_rois, n_rois)))


def trainable_mask(model: nn.Module) -> dict:
    """Parameter name -> whether the optimizer updates it: the reference's
    freeze rules (the stem and the first spec.fixed_blocks blocks frozen);
    FrozenBN holds buffers, not parameters."""
    fixed = model.spec.fixed_blocks
    mask = {}
    for name, _ in model.named_parameters():
        top, _, rest = name.partition(".")
        mask[name] = (resnet_v1.trainable_filter(rest, fixed)
                      if top in ("head", "tail") else True)
    return mask


class FasterRCNN(nn.Module):
    """Faster R-CNN with a ResNet backbone, in the spec's mode.

    Submodule names follow the flax ones: ``head``, ``rpn_conv``,
    ``rpn_cls_score``, ``rpn_bbox_pred``, ``tail``, ``cls_score``,
    ``bbox_pred``. Frozen parameters (``trainable_mask``) have
    ``requires_grad`` False.

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
        self.head = resnet_v1.ResNetV1Head(depth, spec.fixed_blocks)
        self.rpn_conv = nn.Conv2d(1024, spec.rpn_channels, 3, padding=1)
        self.rpn_cls_score = nn.Conv2d(spec.rpn_channels, 2 * a, 1)
        self.rpn_bbox_pred = nn.Conv2d(spec.rpn_channels, 4 * a, 1)
        self.tail = resnet_v1.ResNetV1Tail(depth)
        self.cls_score = nn.Linear(2048, spec.num_classes)
        self.bbox_pred = nn.Linear(2048, 4 * spec.num_classes)
        self._anchors = {}
        mask = trainable_mask(self)
        for name, p in self.named_parameters():
            p.requires_grad_(mask[name])
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
        heads, and, in TEST mode, un-normalize the box deltas.

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
        if s.bbox_normalize and s.mode == "TEST":
            stds = torch.tensor(s.bbox_normalize_stds, dtype=torch.float32,
                                device=rois.device).repeat(s.num_classes)
            means = torch.tensor(s.bbox_normalize_means, dtype=torch.float32,
                                 device=rois.device).repeat(s.num_classes)
            bbox_pred = bbox_pred * stds + means
        return cls_score, bbox_pred

    def _targets(self, anchors, rois, roi_valid, im_info, gt_boxes,
                 gt_valid, noise):
        """Both samplers over the batch: (AnchorTargets, ProposalTargets)."""
        s = self.spec
        at = anchor_target(
            anchors, gt_boxes, gt_valid, im_info[:, :2], noise.anchor_fg,
            noise.anchor_bg, rpn_batchsize=s.rpn_batchsize,
            rpn_fg_fraction=s.rpn_fg_fraction,
            positive_overlap=s.rpn_positive_overlap,
            negative_overlap=s.rpn_negative_overlap,
            clobber_positives=s.rpn_clobber_positives,
            positive_weight=s.rpn_positive_weight,
            inside_weight=s.rpn_bbox_inside_weights)
        pt = proposal_target(
            rois, roi_valid, gt_boxes, gt_valid, noise.roi_fg, noise.roi_bg,
            s.num_classes, batch_size=s.roi_batch_size,
            fg_fraction=s.fg_fraction, fg_thresh=s.fg_thresh,
            bg_thresh_hi=s.bg_thresh_hi, bg_thresh_lo=s.bg_thresh_lo,
            use_gt=s.use_gt, inside_weight=s.bbox_inside_weights,
            normalize=s.bbox_normalize,
            normalize_means=s.bbox_normalize_means,
            normalize_stds=s.bbox_normalize_stds)
        return at, pt

    def forward(self, image, im_info, gt_boxes=None, gt_valid=None,
                noise: Optional[TrainNoise] = None,
                generator: Optional[torch.Generator] = None):
        """image: [B, H, W, 3] mean-subtracted BGR on the static canvas;
        im_info: [B, 3] (h, w, scale) true extents. TRAIN only: gt_boxes
        [B, G, 5] (x1, y1, x2, y2, cls) padded, gt_valid [B, G], and the
        sampling noise, drawn from generator when None. Returns the dict of
        FasterRCNN.__call__; in TRAIN mode rois and roi_valid are the
        sampled RoIs, roi_scores is None, and anchor_targets and
        proposal_targets are added."""
        s = self.spec
        train = s.mode == "TRAIN"
        a = s.num_anchors
        b, hh, ww, _ = image.shape
        if hh % s.feat_stride or ww % s.feat_stride:
            raise ValueError(f"canvas {hh}x{ww} is not a multiple of the "
                             f"feature stride {s.feat_stride}")
        if train and (gt_boxes is None or gt_valid is None):
            raise ValueError("TRAIN mode needs gt_boxes and gt_valid")
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

        # proposal selection is not differentiated (and K1 has no backward)
        rois, roi_scores, roi_valid = self._proposals(
            anchors, rpn_deltas.detach(), fg_prob.detach(), im_info, fw)
        out = {
            "rpn_cls_score": score_pairs,    # [B, N, 2]
            "rpn_bbox_pred": rpn_deltas,     # [B, N, 4]
            "anchors": anchors,              # [N, 4]
        }
        if train:
            if noise is None:
                n_rois = rois.shape[1] + (gt_boxes.shape[1] if s.use_gt
                                          else 0)
                noise = draw_noise(generator, b, n_anchors, n_rois,
                                   image.device)
            at, pt = self._targets(anchors, rois, roi_valid, im_info,
                                   gt_boxes, gt_valid, noise)
            rois, roi_valid, roi_scores = pt.rois, pt.valid, None
            out["anchor_targets"] = at
            out["proposal_targets"] = pt

        cls_score, bbox_pred = self._roi_heads(net_conv, rois, im_info)
        out.update({
            "rois": rois,                    # [B, R, 4]
            "roi_valid": roi_valid,          # [B, R]
            "roi_scores": roi_scores,        # [B, R], None in TRAIN
            "cls_score": cls_score,          # [B, R, K]
            "cls_prob": torch.softmax(cls_score, dim=-1),
            "bbox_pred": bbox_pred,          # [B, R, 4K]
        })
        return out
