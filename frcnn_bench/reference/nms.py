"""Exact greedy non-maximum suppression, written plainly.

Boxes come sorted by descending score. Box i is kept when it is valid and
no kept box before it overlaps it by more than the threshold. The keep mask
is the unique solution of that triangular recursion; it is found here by
iterating ``keep = valid & ~(earlier kept boxes that overlap)`` from
``keep = valid`` until nothing changes, which takes as many rounds as the
longest chain of suppressions, and never more than the box count.
"""

from __future__ import annotations

import torch

__all__ = ["iou", "greedy_keep", "first_kept"]


def iou(a, b, plus_one: bool):
    """IoU [..., N, M] of boxes a [..., N, 4] and b [..., M, 4] as
    (x1, y1, x2, y2); plus_one counts a box's width as x2 - x1 + 1. An
    empty union gives 0."""
    e = 1.0 if plus_one else 0.0
    ax1, ay1, ax2, ay2 = (a[..., :, None, i] for i in range(4))
    bx1, by1, bx2, by2 = (b[..., None, :, i] for i in range(4))
    iw = (torch.minimum(ax2, bx2) - torch.maximum(ax1, bx1) + e).clamp(min=0)
    ih = (torch.minimum(ay2, by2) - torch.maximum(ay1, by1) + e).clamp(min=0)
    inter = iw * ih
    union = ((ax2 - ax1 + e) * (ay2 - ay1 + e)
             + (bx2 - bx1 + e) * (by2 - by1 + e) - inter)
    return torch.where(union > 0, inter / torch.where(union > 0, union, 1.0),
                       torch.zeros_like(inter))


def greedy_keep(boxes, valid, thresh: float, plus_one: bool):
    """Keep mask [G, N] of greedy NMS over G independent sorted instances
    (boxes [G, N, 4], valid [G, N]); suppression at IoU > thresh."""
    out = torch.zeros_like(valid)
    n = boxes.shape[1]
    upper = torch.ones((n, n), dtype=torch.bool,
                       device=boxes.device).triu(diagonal=1)
    for g in range(boxes.shape[0]):
        over = (iou(boxes[g], boxes[g], plus_one) > thresh) & upper
        over = over.to(torch.float32)        # [j, i]: j earlier than i
        keep = valid[g].clone()
        for _ in range(n + 1):
            hit = (keep.to(torch.float32) @ over) > 0
            new = valid[g] & ~hit
            if torch.equal(new, keep):
                break
            keep = new
        out[g] = keep
    return out


def first_kept(keep, k: int):
    """Indices [G, k] of the first k True entries of keep [G, N] in order,
    and their validity [G, k] (slots past the count point at 0)."""
    g, n = keep.shape
    rank = torch.cumsum(keep.to(torch.int64), dim=1) - 1
    idx = torch.zeros((g, k), dtype=torch.int64, device=keep.device)
    ok = torch.zeros((g, k), dtype=torch.bool, device=keep.device)
    rows, cols = torch.nonzero(keep & (rank < k), as_tuple=True)
    idx[rows, rank[rows, cols]] = cols
    ok[rows, rank[rows, cols]] = True
    return idx, ok
