"""Wrappers of the CUDA NMS kernels, and their plain PyTorch versions.

Kernel source: ``tf_faster_rcnn_torch/csrc/nms.cu``, built by
``utils/build.py``. Each wrapper checks its inputs and raises on what the
kernel does not take. A tensor on the CPU goes to the plain version; a CUDA
tensor goes to the kernel, launched on the current stream, and a nonzero
``cudaGetLastError()`` raises. Nothing falls back from one to the other.

K1 ``nms_keep_mask_batched`` replaces ``_nms_kernel`` /
``pallas_nms_keep_mask`` (tf_faster_rcnn_tpu/ops/pallas_nms.py); K2
``batched_nms_keep`` replaces ``_batched_nms_kernel`` /
``pallas_batched_nms_keep``. Both launch one engine, ``frcnn_nms_keep``:
one CTA per instance (an image's boxes for K1, a class's for K2), which
walks the boxes in blocks of 64 and tests each block only against the boxes
kept so far, held in shared memory. K1 stops at ``max_keep`` survivors, so
it tests no box past the last one it keeps; K2 runs without a cap. On this
card both are bound by the length of that serial chain, not by operations
or bytes (csrc/nms.cu says why). All B images, or all G instances, go in
one launch, with no host sync.

The engine is bound as two torch operators, ``frcnn::nms_keep_mask`` (K1)
and ``frcnn::batched_nms_keep`` (K2), registered with
``torch.library.custom_op``: a ``cuda`` implementation that launches the
kernel, a ``cpu`` implementation that is the plain version, and a fake one
for tracing. So ``torch.export`` of a path that calls a wrapper records one
node per call, whichever device it runs on, and an exported program
dispatches to the kernel on the card as the live path does. The schema has
no Optional: K1's "no cap" is ``max_keep = N + 1``. The wrappers check shape,
dtype, device and contiguity (on fake tensors too); the 16-byte alignment of
the boxes is checked in the ``cuda`` implementation, on real tensors.

The ``cuda`` implementations count their kernel launches on the port's
counters (``utils/trace.py``) as ``k1.launches`` and ``k2.launches``, so a
launch from an exported program counts too; the plain versions count
nothing. ``launch_counts`` and ``reset_launch_counts`` read and zero them.
"""

from __future__ import annotations

import torch

from tf_faster_rcnn_torch.ops.boxes import bbox_overlaps
from tf_faster_rcnn_torch.utils import trace

__all__ = ["nms_keep_mask_batched", "batched_nms_keep",
           "nms_keep_mask_plain", "batched_nms_keep_plain",
           "reset_launch_counts", "launch_counts"]

_BLOCK = 128    # row block of the plain K1, as in ops/nms.py
# each wrapper's launch counter (utils/trace.py)
_COUNTERS = {"nms_keep_mask_batched": "k1.launches",
             "batched_nms_keep": "k2.launches"}


def _check(boxes, valid, name):
    if boxes.ndim != 3 or boxes.shape[-1] != 4:
        raise ValueError(f"{name}: boxes must be [G, N, 4], got "
                         f"{tuple(boxes.shape)}")
    if valid.shape != boxes.shape[:2]:
        raise ValueError(f"{name}: valid must be {tuple(boxes.shape[:2])}, "
                         f"got {tuple(valid.shape)}")
    if boxes.dtype != torch.float32:
        raise TypeError(f"{name}: boxes must be float32, got {boxes.dtype}")
    if valid.dtype != torch.bool:
        raise TypeError(f"{name}: valid must be bool, got {valid.dtype}")
    if boxes.device != valid.device:
        raise ValueError(f"{name}: boxes on {boxes.device}, valid on "
                         f"{valid.device}")
    if not (boxes.is_contiguous() and valid.is_contiguous()):
        raise ValueError(f"{name}: boxes and valid must be contiguous")
    if boxes.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {boxes.device}")


def _launch_keep(wrapper, boxes, valid, thresh, plus_one, suppress_eq,
                 max_keep):
    """keep [G, N] from one launch of frcnn_nms_keep, at most max_keep boxes
    kept per instance; counts the launch on the wrapper's counter (an empty
    input launches nothing)."""
    from tf_faster_rcnn_torch.utils.build import get_lib
    name = wrapper.__name__
    if boxes.data_ptr() % 16:
        raise ValueError(f"{name}: the kernel reads boxes as float4, so they "
                         "must start on a 16-byte boundary")
    lib = get_lib()
    g, n = valid.shape
    keep = torch.empty((g, n), dtype=torch.bool, device=boxes.device)
    if g == 0 or n == 0:
        return keep
    max_keep = min(max_keep, 2**31 - 1)
    # the kept boxes of an instance sit in shared memory, or, past what it
    # holds, in this scratch (a box and its area: 5 floats each)
    cap = min(max_keep, n)
    spill = None
    if cap > lib.frcnn_nms_max_kept():
        spill = torch.empty((5 * g * cap,), dtype=torch.float32,
                            device=boxes.device)
    with torch.cuda.device(boxes.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.frcnn_nms_keep(boxes.data_ptr(), valid.data_ptr(), g, n,
                                 float(thresh), int(plus_one),
                                 int(suppress_eq), max_keep,
                                 None if spill is None else spill.data_ptr(),
                                 keep.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA kernel launch failed with "
                           f"cudaError {err}")
    trace.count(_COUNTERS[name])
    return keep


def _over(iou, thresh, suppress_eq):
    return iou >= thresh if suppress_eq else iou > thresh


def nms_keep_mask_plain(boxes, valid, thresh, *, plus_one=False,
                        suppress_eq=False, max_keep=None):
    """Plain K1: the block NMS of tf_faster_rcnn_tpu/ops/nms.py:85-112 in
    torch, batched over the leading dim, then capped at ``max_keep``
    survivors exactly as the kernel caps them."""
    g, n = valid.shape
    thresh = torch.tensor(thresh, dtype=torch.float32)
    keep = valid.clone()
    idx = torch.arange(_BLOCK, device=boxes.device)
    for s in range(0, n, _BLOCK):
        e = min(s + _BLOCK, n)
        over_all = _over(bbox_overlaps(boxes[:, s:e], boxes, plus_one),
                         thresh, suppress_eq)              # [G, b, N]
        over_in = over_all[:, :, s:e]
        bk = keep[:, s:e].clone()
        for i in range(e - s):
            sup = bk[:, i:i + 1] & over_in[:, i] & (idx[:e - s] > i)
            bk &= ~sup
        sup_later = (bk[:, :, None] & over_all[:, :, e:]).any(dim=1)
        keep[:, e:] &= ~sup_later
        keep[:, s:e] = bk
    if max_keep is not None:
        keep &= torch.cumsum(keep, dim=1) <= max_keep
    return keep


def nms_keep_mask_batched(boxes, valid, thresh, *, plus_one=False,
                          suppress_eq=False, max_keep=None):
    """K1: greedy NMS keep masks for B images of score-sorted boxes.

    boxes: [B, N, 4] float32; valid: [B, N] bool (invalid boxes are never
    kept and never suppress). Returns keep [B, N] bool: box i is kept iff it
    is valid, no kept j < i has IoU(i, j) over ``thresh``, and fewer than
    ``max_keep`` boxes before it are kept (None: no cap). The first
    ``max_keep`` survivors are the exact greedy ones; later bits are 0.
    """
    _check(boxes, valid, "nms_keep_mask_batched")
    if max_keep is not None and max_keep < 1:
        raise ValueError(f"max_keep must be >= 1, got {max_keep}")
    n = valid.shape[1]
    return torch.ops.frcnn.nms_keep_mask(
        boxes, valid, float(thresh), bool(plus_one), bool(suppress_eq),
        n + 1 if max_keep is None else int(max_keep))


def batched_nms_keep_plain(boxes, valid, thresh, *, plus_one=False,
                           suppress_eq=False):
    """Plain K2: the sequential sweep over i of _batched_nms_kernel,
    vectorized over all [G, N] boxes at each step."""
    n = valid.shape[1]
    thresh = torch.tensor(thresh, dtype=torch.float32)
    alive = valid.clone()
    later = torch.arange(n, device=boxes.device)
    for i in range(n):
        iou = bbox_overlaps(boxes[:, i:i + 1], boxes, plus_one)[:, 0]  # [G, N]
        sup = _over(iou, thresh, suppress_eq) & (later > i) & alive[:, i:i + 1]
        alive &= ~sup
    return alive


def batched_nms_keep(boxes, valid, thresh, *, plus_one=False,
                     suppress_eq=False):
    """K2: exact greedy NMS over G independent score-sorted instances.

    boxes: [G, N, 4] float32; valid: [G, N] bool. Returns keep [G, N] bool,
    each row the greedy keep mask of its instance.
    """
    _check(boxes, valid, "batched_nms_keep")
    return torch.ops.frcnn.batched_nms_keep(boxes, valid, float(thresh),
                                            bool(plus_one), bool(suppress_eq))


# -- the operators ----------------------------------------------------------

@torch.library.custom_op("frcnn::nms_keep_mask", mutates_args=(),
                         device_types="cpu")
def _nms_keep_mask_op(boxes: torch.Tensor, valid: torch.Tensor,
                      thresh: float, plus_one: bool, suppress_eq: bool,
                      max_keep: int) -> torch.Tensor:
    return nms_keep_mask_plain(boxes, valid, thresh, plus_one=plus_one,
                               suppress_eq=suppress_eq, max_keep=max_keep)


@_nms_keep_mask_op.register_kernel("cuda")
def _(boxes, valid, thresh, plus_one, suppress_eq, max_keep):
    return _launch_keep(nms_keep_mask_batched, boxes, valid, thresh,
                        plus_one, suppress_eq, max_keep)


@_nms_keep_mask_op.register_fake
def _(boxes, valid, thresh, plus_one, suppress_eq, max_keep):
    return torch.empty_like(valid)


@torch.library.custom_op("frcnn::batched_nms_keep", mutates_args=(),
                         device_types="cpu")
def _batched_nms_keep_op(boxes: torch.Tensor, valid: torch.Tensor,
                         thresh: float, plus_one: bool,
                         suppress_eq: bool) -> torch.Tensor:
    return batched_nms_keep_plain(boxes, valid, thresh, plus_one=plus_one,
                                  suppress_eq=suppress_eq)


@_batched_nms_keep_op.register_kernel("cuda")
def _(boxes, valid, thresh, plus_one, suppress_eq):
    return _launch_keep(batched_nms_keep, boxes, valid, thresh, plus_one,
                        suppress_eq, valid.shape[1] + 1)


@_batched_nms_keep_op.register_fake
def _(boxes, valid, thresh, plus_one, suppress_eq):
    return torch.empty_like(valid)


def reset_launch_counts():
    trace.zero(*_COUNTERS.values())


def launch_counts() -> dict:
    """Each wrapper's kernel launches since the last reset."""
    counts = trace.counts()
    return {w: counts.get(c, 0) for w, c in _COUNTERS.items()}
