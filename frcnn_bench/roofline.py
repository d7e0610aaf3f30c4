"""The least time an NMS call could take on its inputs: the larger of its
bytes over the HBM rate and the IoU tests greedy NMS needs, at 16 FLOP a
test, over the float32 rate. A copy of the repository's smoke-test
arithmetic (``chip_smoke.py::needed_tests``, ``bound``, ``k1_extent``),
counted here on the reference's own inputs and answer."""

from __future__ import annotations

import torch

from frcnn_bench.reference.nms import iou

__all__ = ["needed_tests", "bound_s", "FLOP_PER_TEST"]

FLOP_PER_TEST = 16


def _extent(keep, max_keep):
    """Per instance, the index of the max_keep-th kept box (the last index
    when fewer are kept): no box past it needs a test."""
    n = keep.shape[1]
    count = torch.cumsum(keep.to(torch.int64), dim=1)
    if max_keep is None:
        return torch.full((keep.shape[0],), n - 1, device=keep.device)
    reached = count[:, -1] >= max_keep
    first = torch.argmax((count >= max_keep).to(torch.uint8), dim=1)
    return torch.where(reached, first, torch.full_like(first, n - 1))


def needed_tests(keep, boxes, valid, thresh, *, plus_one=False,
                 max_keep=None) -> int:
    """The IoU tests greedy NMS needs given its answer keep [G, N]: a kept
    box against every kept box before it, a suppressed one against the kept
    boxes before it up to its first suppressor, none past the extent."""
    g, n = keep.shape
    pos = torch.arange(n, device=keep.device)
    upto = pos[None, :] <= _extent(keep, max_keep)[:, None]
    kept = keep.to(torch.int64)
    tests = int(((torch.cumsum(kept, dim=1) - kept) * (keep & upto)).sum())
    suppressed = valid & ~keep & upto
    for i in range(g):
        k_idx = torch.nonzero(keep[i] & upto[i])[:, 0]
        s_idx = torch.nonzero(suppressed[i])[:, 0]
        if not len(s_idx):
            continue
        for s in range(0, len(s_idx), 4096):
            cols = s_idx[s:s + 4096]
            over = iou(boxes[i][k_idx], boxes[i][cols], plus_one) > thresh
            over &= k_idx[:, None] < cols[None, :]
            if not bool(over.any(dim=0).all()):
                raise AssertionError("a suppressed box has no suppressor")
            tests += int((torch.argmax(over.to(torch.uint8), dim=0) + 1)
                         .sum())
    return tests


def bound_s(keep, boxes, valid, thresh, f32_flop_s, hbm_bytes_s, *,
            plus_one=False, max_keep=None):
    """(seconds, 'bytes' or 'operations', tests) of one call: boxes and
    valid read once, keep written once, or the needed tests."""
    tests = needed_tests(keep, boxes, valid, thresh, plus_one=plus_one,
                         max_keep=max_keep)
    t_bytes = (boxes.numel() * 4 + valid.numel() + keep.numel()) \
        / hbm_bytes_s
    t_ops = tests * FLOP_PER_TEST / f32_flop_s
    if t_bytes >= t_ops:
        return t_bytes, "bytes", tests
    return t_ops, "operations", tests
