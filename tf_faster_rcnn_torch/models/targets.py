"""Training targets of the RPN and the RoI head, batched over images.

Port of ``tf_faster_rcnn_tpu/models/targets.py`` (``anchor_target``,
``proposal_target``). Both run on the device in torch ops, with static
shapes, validity masks and no host sync, over a leading batch dim B.

The random subsampling keeps the JAX rules exactly, but its uniform noise
is an argument: the JAX package draws it inside each function from a PRNG
key, and torch cannot reproduce those bits, so a caller (or a test) passes
the noise in. ``FasterRCNN`` draws it from a ``torch.Generator``
(``models/network.py::draw_noise``).

* ``_random_keep``: candidates ranked by noise with a stable descending
  sort, non-candidates keyed -1; the first k are kept (the JAX package's
  uniform choice without replacement).
* ``_cycle_pick``: ``order[slot % max(count, 1)]`` with Python-sign modulo,
  the with-replacement fallback when candidates run short.
* argmax takes the first index on ties, as ``jnp.argmax`` does.

The TPU workarounds are not ported: the one-hot matmul row gathers
(``_take_rows``) are plain gathers, and the rank of each candidate is a
scatter, not a second argsort.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from tf_faster_rcnn_torch.ops.boxes import bbox_overlaps, bbox_transform

__all__ = ["AnchorTargets", "ProposalTargets", "anchor_target",
           "proposal_target"]


class AnchorTargets(NamedTuple):
    labels: torch.Tensor                # [B, N] int64: 1 fg, 0 bg, -1 ignore
    bbox_targets: torch.Tensor          # [B, N, 4]
    bbox_inside_weights: torch.Tensor   # [B, N, 4]
    bbox_outside_weights: torch.Tensor  # [B, N, 4]


class ProposalTargets(NamedTuple):
    rois: torch.Tensor                  # [B, S, 4] sampled rois
    labels: torch.Tensor                # [B, S] int64 class labels (0 bg)
    bbox_targets: torch.Tensor          # [B, S, 4K]
    bbox_inside_weights: torch.Tensor   # [B, S, 4K]
    bbox_outside_weights: torch.Tensor  # [B, S, 4K]
    valid: torch.Tensor                 # [B, S] bool (False: no candidate)


def _full(value, like):
    """A float32 0-d tensor on like's device, made by a fill kernel: a host
    to device copy would synchronise the stream."""
    return torch.full((), float(value), dtype=torch.float32,
                      device=like.device)


def _row(values, like):
    """A float32 [len(values)] tensor on like's device, from fills."""
    return torch.stack([_full(v, like) for v in values])


def _rank_order(mask, noise):
    """Indices [B, N] of mask's entries first, in descending noise order
    (stable), then the rest in index order: argsort(-where(mask, noise, -1))
    along dim 1."""
    key = torch.where(mask, noise, -1.0)
    return torch.argsort(-key, dim=1, stable=True)


def _random_keep(candidate_mask, noise, k):
    """Keep exactly min(k, count) candidates per row, those of highest noise.

    candidate_mask [B, N] bool; noise [B, N] uniform; k an int or a [B, 1]
    tensor. Returns the kept mask [B, N]."""
    order = _rank_order(candidate_mask, noise)
    rank = torch.empty_like(order)
    pos = torch.arange(order.shape[1], device=order.device)
    rank.scatter_(1, order, pos.expand_as(order).contiguous())
    return candidate_mask & (rank < k)


def _gather_rows(table, idx):
    """table [B, G, C] rows picked by idx [B, M] -> [B, M, C]."""
    return torch.gather(table, 1, idx[..., None].expand(-1, -1,
                                                         table.shape[-1]))


def anchor_target(anchors, gt_boxes, gt_valid, im_hw, noise_fg, noise_bg, *,
                  rpn_batchsize=256, rpn_fg_fraction=0.5,
                  positive_overlap=0.7, negative_overlap=0.3,
                  clobber_positives=False, positive_weight=-1.0,
                  inside_weight: Tuple[float, ...] = (1.0, 1.0, 1.0, 1.0)
                  ) -> AnchorTargets:
    """RPN training targets (anchor_target_layer parity) for B images.

    anchors: [N, 4]; gt_boxes: [B, G, 5] padded; gt_valid: [B, G] bool;
    im_hw: [B, 2] true image extents (h, w) inside the padded canvas;
    noise_fg, noise_bg: [B, N] uniform noise that ranks the fg and the bg
    candidates for subsampling.
    """
    w = im_hw[:, 1:2]
    h = im_hw[:, 0:1]
    inside = ((anchors[:, 0] >= 0) & (anchors[:, 1] >= 0))[None, :] \
        & (anchors[None, :, 2] < w) & (anchors[None, :, 3] < h)   # [B, N]

    overlaps = bbox_overlaps(anchors[None], gt_boxes[..., :4])   # [B, N, G]
    ov = torch.where(inside[:, :, None] & gt_valid[:, None, :], overlaps,
                     -1.0)
    max_ov, _ = ov.max(dim=2)                 # [B, N]; -1 if no valid gt
    argmax_g = torch.argmax(ov, dim=2)        # first index on ties
    col_max, _ = ov.max(dim=1)                # [B, G]
    # anchors achieving the per-gt max (with the reference's tie semantics)
    is_gt_best = (gt_valid[:, None, :] & (col_max[:, None, :] > -1.0)
                  & (ov == col_max[:, None, :])).any(dim=2)

    neg = inside & (max_ov < negative_overlap)
    pos = is_gt_best | (inside & (max_ov >= positive_overlap))
    labels = torch.full_like(argmax_g, -1)
    if clobber_positives:
        labels = torch.where(pos, 1, labels)
        labels = torch.where(neg, 0, labels)
    else:
        labels = torch.where(neg, 0, labels)
        labels = torch.where(pos, 1, labels)

    # subsample: cap fg at fg_fraction * batch, then bg at batch - num_fg
    num_fg_cap = int(rpn_fg_fraction * rpn_batchsize)
    fg_keep = _random_keep(labels == 1, noise_fg, num_fg_cap)
    labels = torch.where((labels == 1) & ~fg_keep, -1, labels)
    num_fg = (labels == 1).sum(dim=1, keepdim=True)
    bg_keep = _random_keep(labels == 0, noise_bg, rpn_batchsize - num_fg)
    labels = torch.where((labels == 0) & ~bg_keep, -1, labels)

    gt = _gather_rows(gt_boxes[..., :4].to(torch.float32), argmax_g)
    targets = bbox_transform(anchors[None], gt)
    targets = torch.where(inside[..., None], targets, 0.0)

    fg = (labels == 1)[..., None]
    bg = (labels == 0)[..., None]
    iw = torch.where(fg, _row(inside_weight, targets), 0.0)

    def count(mask):
        return torch.clamp(mask.sum(dim=1), min=1).to(torch.float32)

    if positive_weight < 0:
        pw = _full(1.0, targets) / count(labels >= 0)
        nw = pw
    else:
        pw = _full(positive_weight, targets) / count(labels == 1)
        nw = _full(1.0 - positive_weight, targets) / count(labels == 0)
    ow = torch.where(fg, pw[:, None, None],
                     torch.where(bg, nw[:, None, None], 0.0))
    ow = ow.expand(-1, -1, 4).contiguous()
    return AnchorTargets(labels, targets, iw, ow)


def _cycle_pick(order, count, slot):
    """order[b, slot % max(count, 1)] per row (Python-sign modulo: a
    negative slot wraps from the end, as in the JAX package)."""
    c = torch.clamp(count, min=1)[:, None]
    return torch.gather(order, 1, torch.remainder(slot, c))


def proposal_target(rois, roi_valid, gt_boxes, gt_valid, noise_fg, noise_bg,
                    num_classes, *, batch_size=128, fg_fraction=0.25,
                    fg_thresh=0.5, bg_thresh_hi=0.5, bg_thresh_lo=0.1,
                    use_gt=False,
                    normalize_means: Tuple[float, ...] = (0.0, 0.0, 0.0, 0.0),
                    normalize_stds: Tuple[float, ...] = (0.1, 0.1, 0.2, 0.2),
                    normalize=True,
                    inside_weight: Tuple[float, ...] = (1.0, 1.0, 1.0, 1.0)
                    ) -> ProposalTargets:
    """RoI-head training targets (proposal_target_layer parity) for B images.

    rois: [B, R, 4] RPN proposals (image coords); roi_valid: [B, R] bool;
    gt_boxes: [B, G, 5]; gt_valid: [B, G]; noise_fg, noise_bg: [B, R'] with
    R' = R + G under use_gt, else R. Every image gets S = batch_size slots,
    always full: the reference samples with replacement up to BATCH_SIZE.
    """
    gt_boxes = gt_boxes.to(torch.float32)
    if use_gt:
        rois = torch.cat([rois, gt_boxes[..., :4]], dim=1)
        roi_valid = torch.cat([roi_valid, gt_valid], dim=1)

    overlaps = bbox_overlaps(rois, gt_boxes[..., :4])            # [B, R', G]
    ov = torch.where(roi_valid[:, :, None] & gt_valid[:, None, :], overlaps,
                     -1.0)
    max_ov, _ = ov.max(dim=2)
    gt_assign = torch.argmax(ov, dim=2)
    roi_labels = torch.gather(gt_boxes[..., 4], 1, gt_assign)

    fg_mask = roi_valid & (max_ov >= fg_thresh)
    bg_mask = roi_valid & (max_ov < bg_thresh_hi) & (max_ov >= bg_thresh_lo)
    fg_count = fg_mask.sum(dim=1)
    bg_count = bg_mask.sum(dim=1)

    fg_per_image = int(round(fg_fraction * batch_size))
    # the reference's branches (proposal_target_layer.py:119-132):
    #   both present -> fg = min(cap, fg_count), bg fills the rest
    #   fg only      -> every slot fg (with replacement)
    #   bg only      -> every slot bg, labels 0
    num_fg = torch.where(
        (fg_count > 0) & (bg_count > 0),
        torch.clamp(fg_count, max=fg_per_image),
        torch.where(fg_count > 0, torch.full_like(fg_count, batch_size),
                    torch.zeros_like(fg_count)))[:, None]         # [B, 1]

    fg_order = _rank_order(fg_mask, noise_fg)
    bg_order = _rank_order(bg_mask, noise_bg)
    slots = torch.arange(batch_size, device=rois.device)[None, :]
    is_fg_slot = slots < num_fg
    idx = torch.where(is_fg_slot, _cycle_pick(fg_order, fg_count, slots),
                      _cycle_pick(bg_order, bg_count, slots - num_fg))

    labels = torch.where(is_fg_slot, torch.gather(roi_labels, 1, idx),
                         0.0).to(torch.int64)
    out_rois = _gather_rows(rois, idx)
    valid = ((fg_count + bg_count) > 0)[:, None].expand(-1, batch_size)
    labels = torch.where(valid, labels, torch.zeros_like(labels))

    targets = bbox_transform(
        out_rois, _gather_rows(gt_boxes[..., :4],
                               torch.gather(gt_assign, 1, idx)))
    if normalize:
        targets = ((targets - _row(normalize_means, targets))
                   / _row(normalize_stds, targets))

    # the 4K per-class layout (proposal_target_layer.py:58-80)
    b = rois.shape[0]
    classes = torch.arange(num_classes, device=labels.device)
    onehot = (labels[..., None] == classes).to(torch.float32)    # [B, S, K]
    is_fg = ((labels > 0) & valid)[..., None]
    t4k = (onehot[..., None] * targets[:, :, None, :]).reshape(
        b, batch_size, 4 * num_classes)
    iw4k = (onehot[..., None] * _row(inside_weight, targets)).reshape(
        b, batch_size, 4 * num_classes)
    t4k = torch.where(is_fg, t4k, 0.0)
    iw4k = torch.where(is_fg, iw4k, 0.0)
    ow4k = (iw4k > 0).to(torch.float32)
    return ProposalTargets(out_rois.to(torch.float32), labels, t4k, iw4k,
                           ow4k, valid)
