"""The Faster R-CNN detector, as one torch module.

Port of ``tf_faster_rcnn_tpu/models/network.py`` (``ModelSpec``,
``spec_from_cfg``, ``FasterRCNN``, ``extract_head``, ``trainable_mask``) for
every backbone (vgg16, res50/101/152, mobile): backbone head, RPN, anchor
decode, proposal selection (NMS through kernel K1, or TEST.MODE 'top'), in
TRAIN mode the two target samplers, RoI crop, tail, heads and, in TEST mode,
bbox un-normalization. Besides, ``res101_fpn`` (TEST only): R-101-FPN, the
trunk through block4 in the pyramid layout, the feature pyramid, the RPN on
its five levels, each RoI cropped from its own level and the two-fc head
(``models/fpn.py``). The public layouts are the JAX ones: the image is NHWC
[B, H, W, 3] and the output dict has the keys and shapes of
``FasterRCNN.__call__``. Inside, the convolutions run in NCHW.

The compute dtype (TPU.COMPUTE_DTYPE) runs from the image, cast at the
head's input, through the head, RPN convs, crop, tail and heads; the RPN
outputs, ``cls_score`` and ``bbox_pred`` are cast to float32, so the
proposal selection, K1, K2, the samplers and the losses all see float32.

The randomness is an input: the samplers' uniform noise and vgg16's
dropout keep masks (``TrainNoise``), and the 'top' mode's pad indices. The
caller passes them, or the forward draws them from a ``torch.Generator``.

Not ported (ROADMAP.md, Rules of the port): the space-to-depth stem, a TPU
workaround, which raises NotImplementedError.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import torch
from torch import nn

from tf_faster_rcnn_torch.models import fpn, mobilenet_v1, resnet_v1, vgg16
from tf_faster_rcnn_torch.models.layers import ConvSame, Dense
from tf_faster_rcnn_torch.models.targets import anchor_target, proposal_target
from tf_faster_rcnn_torch.ops.anchors import anchor_grid_on
from tf_faster_rcnn_torch.ops.boxes import (BBOX_XFORM_CLIP,
                                            bbox_transform_inv, clip_boxes)
from tf_faster_rcnn_torch.ops.nms import sorted_nms
from tf_faster_rcnn_torch.ops.roi_align import pyramid_crop, roi_crop_pool
from tf_faster_rcnn_torch.parallel.dist import local_slice
from tf_faster_rcnn_torch.utils.trace import span

__all__ = ["ModelSpec", "FasterRCNN", "TrainNoise", "draw_noise",
           "extract_head", "shard_noise", "spec_from_cfg", "trainable_mask"]

BACKBONES = ("vgg16", "res50", "res101", "res152", "mobile", "res101_fpn")
RESNETS = ("res50", "res101", "res152")
PYRAMIDS = ("res101_fpn",)      # backbones with a feature pyramid
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


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
    depth_multiplier: float = 1.0  # MOBILENET.DEPTH_MULTIPLIER
    # TRAIN.TRUNCATED: the RPN and class heads' init draws truncated
    # normals (models/init.py::reference_init)
    truncated: bool = False
    compute_dtype: str = "float32"  # TPU.COMPUTE_DTYPE
    rpn_pre_nms_top_n: int = 6000
    rpn_post_nms_top_n: int = 300
    rpn_nms_thresh: float = 0.7
    test_mode: str = "nms"         # TEST.MODE: 'nms' | 'top'
    rpn_top_n: int = 5000          # TEST.RPN_TOP_N, for 'top'
    # freeze prefixes: RESNET.FIXED_BLOCKS (the stem and blocks 1..N) and
    # MOBILENET.FIXED_LAYERS (layers 0..N-1)
    fixed_blocks: int = 1
    fixed_layers: int = 5
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

    @property
    def pyramid(self) -> bool:
        """A feature-pyramid backbone: rpn_pre_nms_top_n then counts each
        (image, level) instance's candidates."""
        return self.backbone in PYRAMIDS

    @property
    def dtype(self) -> torch.dtype:
        return DTYPES[self.compute_dtype]


def spec_from_cfg(backbone: str, num_classes: int, mode: str) -> ModelSpec:
    """Snapshot the port's global cfg (``tf_faster_rcnn_torch/config.py``).
    The detect path itself never reads cfg: a ModelSpec built directly, with
    its defaults (the cfg defaults), runs without the config module."""
    from tf_faster_rcnn_torch.config import cfg
    phase = cfg.TRAIN if mode == "TRAIN" else cfg.TEST
    if cfg.TPU.SPACE_TO_DEPTH:
        raise NotImplementedError(
            "TPU.SPACE_TO_DEPTH is a TPU stem workaround; the port runs the "
            "plain 7x7 stem (ROADMAP.md, Rules of the port)")
    if not cfg.TPU.USE_PALLAS_NMS:
        raise NotImplementedError(
            "TPU.USE_PALLAS_NMS False: the port always runs NMS through its "
            "CUDA kernels on the card (their plain versions are the CPU's "
            "route and the tests' reference); ROADMAP.md, 'Not ported, by "
            "decision'")
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
        depth_multiplier=float(cfg.MOBILENET.DEPTH_MULTIPLIER),
        truncated=bool(cfg.TRAIN.TRUNCATED),
        compute_dtype=str(cfg.TPU.COMPUTE_DTYPE),
        rpn_pre_nms_top_n=pre,
        rpn_post_nms_top_n=int(phase.RPN_POST_NMS_TOP_N),
        rpn_nms_thresh=float(phase.RPN_NMS_THRESH),
        test_mode=str(cfg.TEST.MODE),
        rpn_top_n=int(cfg.TEST.RPN_TOP_N),
        fixed_blocks=int(cfg.RESNET.FIXED_BLOCKS),
        fixed_layers=int(cfg.MOBILENET.FIXED_LAYERS),
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
    for field, allowed in (("backbone", BACKBONES), ("mode", ("TRAIN", "TEST")),
                           ("compute_dtype", tuple(DTYPES)),
                           ("test_mode", ("nms", "top"))):
        if getattr(spec, field) not in allowed:
            raise ValueError(f"{field} {getattr(spec, field)!r}: one of "
                             f"{allowed}")
    if spec.pyramid and spec.mode == "TRAIN":
        raise NotImplementedError(
            f"{spec.backbone} TRAIN: training a feature pyramid (per-level "
            "anchor targets) is not ported; ROADMAP.md, Queue 4")
    if spec.pyramid and spec.test_mode != "nms":
        raise NotImplementedError(
            f"{spec.backbone}: TEST.MODE {spec.test_mode!r}; a feature "
            "pyramid's proposals take NMS ('nms')")


class TrainNoise(NamedTuple):
    """The randomness of a TRAIN forward. The uniform [0, 1) noise that
    ranks sampling candidates, in the order the JAX package draws it: the
    anchors' fg and bg noise [B, N], then the proposals' fg and bg noise
    [B, R'] (R' = post-NMS proposals, plus the gt rows under use_gt). For
    vgg16, dropout: the keep masks of fc6 and fc7, bool [B * roi_batch_size,
    4096] each (None for the other backbones)."""
    anchor_fg: torch.Tensor
    anchor_bg: torch.Tensor
    roi_fg: torch.Tensor
    roi_bg: torch.Tensor
    dropout: Optional[Tuple[torch.Tensor, torch.Tensor]] = None


def draw_noise(generator: Optional[torch.Generator], batch: int,
               n_anchors: int, n_rois: int, device,
               dropout_rows: int = 0) -> TrainNoise:
    """One training step's TrainNoise, drawn on device from generator (a
    generator of that device, or None for torch's default one); with
    dropout_rows > 0, also the two [dropout_rows, 4096] keep masks."""
    noise = [torch.rand((batch, n), generator=generator, device=device)
             for n in (n_anchors, n_anchors, n_rois, n_rois)]
    keep = None
    if dropout_rows:
        keep = tuple(torch.rand((dropout_rows, vgg16.FC_WIDTH),
                                generator=generator, device=device)
                     < vgg16.KEEP_PROB for _ in range(2))
    return TrainNoise(*noise, dropout=keep)


def shard_noise(noise: TrainNoise, index: int, count: int) -> TrainNoise:
    """Part index of count equal parts of a global batch's TrainNoise: the
    rows of that part's images, and of their RoIs in the dropout masks
    (image-major, as the tail flattens them)."""
    def part(t):
        return t[local_slice(t.shape[0], index, count)]
    keep = None if noise.dropout is None else tuple(
        part(m) for m in noise.dropout)
    return TrainNoise(*(part(t) for t in noise[:4]), dropout=keep)


def draw_top_pad(batch: int, n_anchors: int, top_n: int,
                 device) -> torch.Tensor:
    """TEST.MODE 'top' pad indices [B, top_n] into the anchors, with
    replacement, for an image whose anchors are fewer than top_n: image i's
    from a generator seeded with i, so TEST stays reproducible (the JAX
    package folds i into PRNGKey(0); torch cannot draw its bits)."""
    rows = []
    for i in range(batch):
        gen = torch.Generator(device=device).manual_seed(i)
        rows.append(torch.randint(0, n_anchors, (top_n,), generator=gen,
                                  device=device))
    return torch.stack(rows)


def trainable_mask(model: nn.Module) -> dict:
    """Parameter name -> whether the optimizer updates it: the reference's
    freeze rules per backbone (vgg16: conv1 and conv2; ResNet: the stem and
    the first spec.fixed_blocks blocks; mobile: the first spec.fixed_layers
    layers). FrozenBN holds buffers, not parameters."""
    s = model.spec
    if s.backbone == "vgg16":
        keep = vgg16.trainable_filter
    elif s.backbone in RESNETS + PYRAMIDS:
        def keep(rest):
            return resnet_v1.trainable_filter(rest, s.fixed_blocks)
    else:
        def keep(rest):
            return mobilenet_v1.trainable_filter(rest, s.fixed_layers)
    mask = {}
    for name, _ in model.named_parameters():
        top, _, rest = name.partition(".")
        mask[name] = keep(rest) if top in ("head", "tail") else True
    return mask


def decode_boxes(anchors, deltas, im_info):
    """Boxes [B, N, 4] of deltas [B, N, 4] on anchors [N, 4], decoded with
    dw, dh capped at BBOX_XFORM_CLIP and clipped to each image's extent
    (im_info [B, 3])."""
    return clip_boxes(bbox_transform_inv(anchors, deltas,
                                         xform_clip=BBOX_XFORM_CLIP),
                      im_info[:, :2])


def build_backbone(spec: ModelSpec):
    """(head, tail) modules of spec's backbone, in its compute dtype."""
    dt = spec.dtype
    if spec.backbone == "vgg16":
        return vgg16.VGG16Head(dt), vgg16.VGG16Tail(spec.pooling_size, dt)
    if spec.backbone in RESNETS:
        depth = int(spec.backbone[3:])
        return (resnet_v1.ResNetV1Head(depth, spec.fixed_blocks, dt),
                resnet_v1.ResNetV1Tail(depth, dt))
    if spec.pyramid:
        depth = int(spec.backbone[3:].split("_")[0])
        return (resnet_v1.ResNetV1Head(depth, spec.fixed_blocks, dt,
                                       pyramid=True),
                fpn.TwoFCHead(spec.pooling_size, fpn.FPN_CHANNELS, dt))
    return (mobilenet_v1.MobileNetV1Head(spec.depth_multiplier,
                                         spec.fixed_layers, dt),
            mobilenet_v1.MobileNetV1Tail(spec.depth_multiplier, dt))


class FasterRCNN(nn.Module):
    """Faster R-CNN with the spec's backbone, mode and compute dtype.

    Submodule names follow the flax ones: ``head``, ``rpn_conv``,
    ``rpn_cls_score``, ``rpn_bbox_pred``, ``tail``, ``cls_score``,
    ``bbox_pred``; a pyramid backbone adds ``fpn`` after ``head``. Frozen
    parameters (``trainable_mask``) have ``requires_grad`` False.

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
        a, dt, rpn = spec.num_anchors, spec.dtype, spec.rpn_channels
        # registered in the flax module order (head, RPN, tail, heads):
        # init_model draws in state_dict order
        head, tail = build_backbone(spec)
        self.head = head
        feat = head.out_channels
        if spec.pyramid:
            self.fpn = fpn.FPN(head.out_channels, dt)
            feat = fpn.FPN_CHANNELS
            self.trunk_graphs = fpn.TrunkGraphs()
        self.rpn_conv = ConvSame(feat, rpn, 3, compute_dtype=dt)
        self.rpn_cls_score = ConvSame(rpn, 2 * a, 1, compute_dtype=dt)
        self.rpn_bbox_pred = ConvSame(rpn, 4 * a, 1, compute_dtype=dt)
        self.tail = tail
        self.cls_score = Dense(tail.out_channels, spec.num_classes, dt)
        self.bbox_pred = Dense(tail.out_channels, 4 * spec.num_classes, dt)
        mask = trainable_mask(self)
        for name, p in self.named_parameters():
            p.requires_grad_(mask[name])
        # spatial partitioning of the head over a model group, installed by
        # parallel/spatial.py::partition; used where a batch holds rows
        self.spatial = None
        self.to(device)

    def _rpn(self, feats, valid=None):
        """The RPN head on feature maps [B, C, fh, fw] (one map, or a
        pyramid's levels), their anchors end to end, each map's in (y, x, a)
        order: (score pairs [B, N, 2], deltas [B, N, 4], fg probability
        [B, N]), float32. valid: each map's cell extents, to mask the
        conv's output, or None."""
        a = self.spec.num_anchors
        pairs, deltas = [], []
        for i, feat in enumerate(feats):
            b = feat.shape[0]
            rpn = self.rpn_conv.with_epilogue(
                feat, relu=True, valid_hw=None if valid is None else valid[i])
            # NHWC before the flatten: anchors run in (y, x, a) order
            cls = self.rpn_cls_score(rpn).permute(0, 2, 3, 1)
            # channel c < A is the bg logit and c + A the fg logit of
            # anchor c
            pairs.append(torch.stack([cls[..., :a], cls[..., a:]],
                                     dim=-1).reshape(b, -1, 2))
            deltas.append(self.rpn_bbox_pred(rpn).permute(0, 2, 3, 1)
                          .reshape(b, -1, 4))
        if len(feats) > 1:
            pairs, deltas = [torch.cat(pairs, dim=1)], [torch.cat(deltas, 1)]
        score_pairs = pairs[0].to(torch.float32)
        return (score_pairs, deltas[0].to(torch.float32),
                torch.softmax(score_pairs, dim=-1)[..., 1])

    def _proposals(self, anchors, rpn_bbox, fg_scores, im_info, fw: int,
                   top_pad=None):
        """Decode, clip, mask anchors past each image's extent, then sorted
        NMS (kernel K1 over all B images at once) into post_nms_top_n slots;
        or, with TEST.MODE 'top', the plain top rpn_top_n masked scores, no
        NMS (the reference's proposal_top_layer). With fewer anchors than
        rpn_top_n, 'top' takes the anchors at top_pad [B, rpn_top_n]
        instead, ignoring the scores (draw_top_pad when None).

        anchors [N, 4]; rpn_bbox [B, N, 4]; fg_scores [B, N]; im_info [B, 3].
        Returns (rois [B, R, 4], roi_scores [B, R], roi_valid [B, R]).
        """
        s = self.spec
        cell = torch.arange(anchors.shape[0], device=anchors.device)
        cell = cell // s.num_anchors
        cy, cx = cell // fw, cell % fw
        boxes = decode_boxes(anchors, rpn_bbox, im_info)
        ext = torch.ceil(im_info[:, :2] / s.feat_stride)
        avalid = (cy < ext[:, :1]) & (cx < ext[:, 1:])
        if s.mode == "TEST" and s.test_mode == "top":
            b, n = fg_scores.shape
            if n < s.rpn_top_n:
                idx = (draw_top_pad(b, n, s.rpn_top_n, fg_scores.device)
                       if top_pad is None else top_pad)
                valid = torch.gather(avalid, 1, idx)
            else:
                masked = torch.where(avalid, fg_scores, -torch.inf)
                top_s, idx = torch.sort(masked, dim=1, descending=True,
                                        stable=True)
                idx = idx[:, :s.rpn_top_n]
                valid = top_s[:, :s.rpn_top_n] > -torch.inf
            rois = torch.gather(boxes, 1, idx[..., None].expand(-1, -1, 4))
            return rois, torch.gather(fg_scores, 1, idx), valid
        idx, valid = sorted_nms(
            boxes, fg_scores, avalid, s.rpn_nms_thresh, s.rpn_post_nms_top_n,
            plus_one=False, suppress_eq=False,
            pre_sort_k=min(s.rpn_pre_nms_top_n, fg_scores.shape[1]))
        rois = torch.gather(boxes, 1, idx[..., None].expand(-1, -1, 4))
        return rois, torch.gather(fg_scores, 1, idx), valid

    def _roi_heads(self, net_conv, rois, im_info, dropout=None):
        """Crop each RoI from net_conv [B, C, fh, fw] (samples past the
        image's feature extent read 0.0), run the tail (vgg16: with the
        dropout keep masks, if given) and the class and box heads, and, in
        TEST mode, un-normalize the box deltas. ResNet crops pooling_size
        unless RESNET.MAX_POOL; vgg16 and mobile crop twice that and
        max-pool.

        Returns (cls_score [B, R, K], bbox_pred [B, R, 4K]), float32.
        """
        s = self.spec
        b, r = rois.shape[:2]
        max_pool = s.resnet_max_pool if s.backbone in RESNETS else True
        feat_valid = torch.ceil(im_info[:, :2] / float(s.feat_stride))
        pooled = roi_crop_pool(net_conv.permute(0, 2, 3, 1), rois,
                               s.feat_stride, s.pooling_size,
                               max_pool=max_pool, valid_hw=feat_valid)
        pooled = pooled.reshape(b * r, s.pooling_size, s.pooling_size, -1)
        if s.backbone == "vgg16":
            fc7 = self.tail(pooled, dropout)
        else:
            fc7 = self.tail(pooled)
        return self._class_heads(fc7, rois)

    def _class_heads(self, fc7, rois):
        """The class and box heads on fc7 [B * R, D] of rois [B, R, 4], and
        in TEST mode the box deltas un-normalized: (cls_score [B, R, K],
        bbox_pred [B, R, 4K]), float32."""
        s = self.spec
        b, r = rois.shape[:2]
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

    def _forward_pyramid(self, image, im_info):
        """The TEST forward of a feature-pyramid backbone (models/fpn.py):
        the trunk's C2-C5, the pyramid P2-P6, the shared RPN head on every
        level, the proposals over the levels, each RoI cropped from its own
        level of P2-P5, the two-fc head and the class and box heads. The
        outputs as forward's, the RPN's over the levels end to end."""
        s = self.spec
        b, hh, ww, _ = image.shape
        if hh % fpn.SIZE_DIVISOR or ww % fpn.SIZE_DIVISOR:
            raise ValueError(f"canvas {hh}x{ww} is not a multiple of "
                             f"{fpn.SIZE_DIVISOR}, the pyramid's stride")
        with span("model.head"):
            feats = self.trunk_graphs(self.head, s.dtype, image, im_info)
        with span("model.fpn"):
            levels, valid = self.fpn(feats, im_info[:, :2])
        shapes = [tuple(p.shape[2:]) for p in levels]
        with span("model.rpn"):
            anchors = fpn.pyramid_anchors(shapes, image.device,
                                          s.anchor_scales, s.anchor_ratios)
            score_pairs, rpn_deltas, fg_prob = self._rpn(levels, valid)
            boxes = decode_boxes(anchors, rpn_deltas, im_info)
            inside = fpn.anchor_inside(shapes, s.num_anchors, im_info)
            sizes = [h * w * s.num_anchors for h, w in shapes]
            idx, roi_valid = fpn.pyramid_proposals(
                boxes, fg_prob, inside, sizes, s.rpn_pre_nms_top_n,
                s.rpn_post_nms_top_n, s.rpn_nms_thresh)
            rois = torch.gather(boxes, 1, idx[..., None].expand(-1, -1, 4))
            roi_scores = torch.gather(fg_prob, 1, idx)
        with span("model.roi_heads"):
            r = rois.shape[1]
            with span("model.pyramid_crop"):
                n_roi = len(fpn.ROI_LEVELS)
                pooled = pyramid_crop(levels[:n_roi],
                                      fpn.level_strides(fpn.ROI_LEVELS), rois,
                                      fpn.assign_levels(rois),
                                      s.pooling_size, im_info[:, :2])
            fc7 = self.tail(pooled.reshape(b * r, s.pooling_size,
                                           s.pooling_size, -1))
            cls_score, bbox_pred = self._class_heads(fc7, rois)
            cls_prob = torch.softmax(cls_score, dim=-1)
        return {"rpn_cls_score": score_pairs, "rpn_bbox_pred": rpn_deltas,
                "anchors": anchors, "rois": rois, "roi_valid": roi_valid,
                "roi_scores": roi_scores, "cls_score": cls_score,
                "cls_prob": cls_prob, "bbox_pred": bbox_pred}

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
                generator: Optional[torch.Generator] = None,
                top_pad: Optional[torch.Tensor] = None,
                shard: Optional[Tuple[int, int]] = None,
                canvas_h: Optional[int] = None):
        """image: [B, H, W, 3] mean-subtracted BGR on the static canvas;
        im_info: [B, 3] (h, w, scale) true extents. TRAIN only: gt_boxes
        [B, G, 5] (x1, y1, x2, y2, cls) padded, gt_valid [B, G], and the
        TrainNoise (with vgg16's dropout masks), drawn from generator when
        None; shard=(index, count) makes this batch part index of count
        equal parts of a global batch (a data-parallel rank's rows): the
        noise is then drawn for the global batch and this part's rows are
        kept, so every rank's generator draws alike (shard takes the data
        axis's index and size: the model ranks of a data group draw alike).
        TEST.MODE 'top' only: top_pad, the pad indices of _proposals.
        canvas_h: the canvas height where image holds this model rank's
        rows of it (parallel/mesh.py::split_canvas); the head then runs
        spatially partitioned (self.spatial) and gathers the whole feature
        map. Returns the dict of FasterRCNN.__call__; in TRAIN mode rois and
        roi_valid are the sampled RoIs, roi_scores is None, and
        anchor_targets and proposal_targets are added."""
        s = self.spec
        train = s.mode == "TRAIN"
        a = s.num_anchors
        b, hh, ww, _ = image.shape
        if canvas_h is not None:
            if self.spatial is None:
                raise ValueError("a batch of canvas rows needs spatial "
                                 "partitioning (parallel/spatial.py)")
            hh = int(canvas_h)
        if hh % s.feat_stride or ww % s.feat_stride:
            raise ValueError(f"canvas {hh}x{ww} is not a multiple of the "
                             f"feature stride {s.feat_stride}")
        if train and (gt_boxes is None or gt_valid is None):
            raise ValueError("TRAIN mode needs gt_boxes and gt_valid")
        im_info = im_info.to(torch.float32)
        if s.pyramid:
            if canvas_h is not None:
                raise ValueError("a feature pyramid runs on whole canvases")
            return self._forward_pyramid(image, im_info)

        with span("model.head"):
            x = image.to(s.dtype).permute(0, 3, 1, 2)
            if canvas_h is None:
                net_conv = self.head(x, im_info[:, :2])   # [B, C, fh, fw]
            else:
                net_conv = self.spatial.head(self.head, x, hh,
                                             im_info[:, :2])
        fh, fw = net_conv.shape[2], net_conv.shape[3]
        n_anchors = fh * fw * a

        with span("model.rpn"):
            # built by each forward from the feature shape: the module keeps
            # no tensor outside its state_dict, so torch.export traces plain
            # ops
            anchors = anchor_grid_on(fh, fw, image.device, s.feat_stride,
                                     s.anchor_scales, s.anchor_ratios)
            score_pairs, rpn_deltas, fg_prob = self._rpn([net_conv])
            # proposal selection is not differentiated (and K1 has no
            # backward)
            rois, roi_scores, roi_valid = self._proposals(
                anchors, rpn_deltas.detach(), fg_prob.detach(), im_info, fw,
                top_pad)
        out = {
            "rpn_cls_score": score_pairs,    # [B, N, 2]
            "rpn_bbox_pred": rpn_deltas,     # [B, N, 4]
            "anchors": anchors,              # [N, 4]
        }
        dropout = None
        if train:
            with span("model.targets"):
                vgg = s.backbone == "vgg16"
                if noise is None:
                    index, count = shard or (0, 1)
                    n_rois = rois.shape[1] + (gt_boxes.shape[1] if s.use_gt
                                              else 0)
                    noise = draw_noise(
                        generator, b * count, n_anchors, n_rois,
                        image.device,
                        b * count * s.roi_batch_size if vgg else 0)
                    if count > 1:
                        noise = shard_noise(noise, index, count)
                if vgg and noise.dropout is None:
                    raise ValueError("vgg16 TRAIN needs the dropout keep "
                                     "masks in noise.dropout")
                dropout = noise.dropout
                at, pt = self._targets(anchors, rois, roi_valid, im_info,
                                       gt_boxes, gt_valid, noise)
            rois, roi_valid, roi_scores = pt.rois, pt.valid, None
            out["anchor_targets"] = at
            out["proposal_targets"] = pt

        with span("model.roi_heads"):
            cls_score, bbox_pred = self._roi_heads(net_conv, rois, im_info,
                                                   dropout)
            cls_prob = torch.softmax(cls_score, dim=-1)
        out.update({
            "rois": rois,                    # [B, R, 4]
            "roi_valid": roi_valid,          # [B, R]
            "roi_scores": roi_scores,        # [B, R], None in TRAIN
            "cls_score": cls_score,          # [B, R, K]
            "cls_prob": cls_prob,
            "bbox_pred": bbox_pred,          # [B, R, 4K]
        })
        return out


def extract_head(model: FasterRCNN, image, valid_hw=None):
    """The head's feature maps alone (the reference's Network.extract_head),
    for activation-parity checks against converted checkpoints.

    image: [B, H, W, 3], cast to the spec's compute dtype; valid_hw:
    optional [B, 2] per-image pixel extents for the margin masking (None:
    the whole canvas is image). Returns [B, fh, fw, C] in the compute dtype,
    the JAX function's layout. The module holds its parameters, so there is
    no params argument.
    """
    x = image.to(model.spec.dtype).permute(0, 3, 1, 2)
    if valid_hw is not None:
        valid_hw = valid_hw.to(torch.float32)
    return model.head(x, valid_hw).permute(0, 2, 3, 1)
