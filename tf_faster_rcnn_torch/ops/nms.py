"""Fixed-shape greedy non-maximum suppression.

Port of ``tf_faster_rcnn_tpu/ops/nms.py``: a keep mask over N score-sorted
boxes, and helpers that turn it into a fixed ``max_out``-slot result with a
validity mask. Every function takes a leading batch dim, and the keep mask
of all images comes from one call of kernel K1 (``ops/nms_kernels.py``).

Ties break toward the lower index, as ``lax.top_k`` breaks them: every sort
here is a stable descending ``torch.sort``.
"""

from __future__ import annotations

import torch

from tf_faster_rcnn_torch.ops.nms_kernels import nms_keep_mask_batched

__all__ = ["nms_keep_mask", "select_top_k_mask", "sorted_nms",
           "class_aware_nms"]

_NEG = -1.0e10


def nms_keep_mask(boxes, valid, iou_threshold, *, plus_one=False,
                  suppress_eq=False, max_keep=None):
    """Greedy NMS keep mask for boxes sorted by descending score.

    boxes: [N, 4] or [B, N, 4]; valid: [N] or [B, N] bool. Box i is kept iff
    it is valid and no kept j < i has IoU(i, j) over the threshold
    (``>=`` with suppress_eq). plus_one: the +1-width IoU. max_keep: only the
    first max_keep survivors are kept; later bits are False.
    """
    single = boxes.ndim == 2
    if single:
        boxes, valid = boxes[None], valid[None]
    # float32 only: the wrapper raises on another dtype (a bfloat16 box is
    # a caller's bug, not a cast to make here)
    keep = nms_keep_mask_batched(
        boxes.contiguous(), valid.contiguous(),
        float(iou_threshold), plus_one=plus_one, suppress_eq=suppress_eq,
        max_keep=max_keep)
    return keep[0] if single else keep


def select_top_k_mask(mask, k):
    """Indices of the first k True entries of mask [..., N], in index order.

    Returns (indices [..., k] int64, valid [..., k] bool). Slots past the
    number of True entries point at index 0 with valid False. A stable sort
    on the key of ops/nms.py:137-143, with no host sync and no
    data-dependent shape.
    """
    n = mask.shape[-1]
    iota = torch.arange(n, device=mask.device)
    key = torch.where(mask, n - iota, -iota - 1)
    idx = torch.sort(key, dim=-1, descending=True, stable=True)[1][..., :k]
    if k > n:
        idx = torch.cat([idx, idx.new_zeros(idx.shape[:-1] + (k - n,))], -1)
    count = mask.sum(dim=-1, keepdim=True)
    valid = torch.arange(k, device=mask.device) < torch.clamp(count, max=k)
    return torch.where(valid, idx, 0), valid


def sorted_nms(boxes, scores, valid, iou_threshold, max_out, *,
               plus_one=False, suppress_eq=False, pre_sort_k=None):
    """Sort by score, NMS, return the top max_out survivors.

    boxes [..., N, 4], scores [..., N], valid [..., N] -> (indices into the
    input [..., max_out], out_valid [..., max_out]). With pre_sort_k, only
    the top pre_sort_k scores enter NMS.
    """
    n = boxes.shape[-2]
    k = n if pre_sort_k is None else min(int(pre_sort_k), n)
    s = torch.where(valid, scores, torch.full((), _NEG, dtype=scores.dtype,
                                              device=scores.device))
    top_scores, order = torch.sort(s, dim=-1, descending=True, stable=True)
    top_scores, order = top_scores[..., :k], order[..., :k]
    boxes_s = torch.gather(boxes, -2,
                           order[..., None].expand(order.shape + (4,)))
    valid_s = top_scores > _NEG / 2
    keep = nms_keep_mask(boxes_s, valid_s, iou_threshold, plus_one=plus_one,
                         suppress_eq=suppress_eq, max_keep=max_out)
    sel, out_valid = select_top_k_mask(keep, max_out)
    return torch.gather(order, -1, sel), out_valid


def class_aware_nms(boxes, scores, valid, iou_threshold, max_out, *,
                    plus_one=True, suppress_eq=False):
    """Per-class NMS over a leading class axis, every class in one K1 call.

    boxes [C, N, 4], scores [C, N], valid [C, N] -> (indices [C, max_out],
    valid [C, max_out]). The default +1 IoU is the reference's test-time
    per-class nms().
    """
    return sorted_nms(boxes, scores, valid, iou_threshold, max_out,
                      plus_one=plus_one, suppress_eq=suppress_eq)
