"""The feature pyramid of R-101-FPN (Lin et al., CVPR 2017, as Detectron2's
``Base-RCNN-FPN.yaml`` builds it), and the stages around it that differ
from the single-map detector: anchors on every level, proposals over the
levels, each RoI's level, and the two-fc box head.

* ``FPN``: for each of C2-C5 a lateral 1x1 conv to ``FPN_CHANNELS`` (with
  bias); top-down, Pi = lateral(Ci) + nearest-x2(Pi+1) from P5 down to P2,
  the sum in the lateral's ``frcnn::conv_epilogue`` as its residual; a 3x3
  output conv on each level; P6 = P5 subsampled with stride 2. Every level
  is masked to its image's extent, as the trunk's maps are;
* ``pyramid_anchors``: one anchor size a level, ``generate_anchors`` with
  the level's stride as its window (8 x stride: 32 on P2 up to 512 on P6);
* ``pyramid_proposals``: for each image and level the top ``pre_n`` scores,
  greedy NMS over all B x levels instances in ONE launch of kernel K1, then
  the ``post_n`` highest-scoring survivors over the levels; no host sync;
* ``assign_levels``: level k = floor(4 + log2(sqrt(wh) / 224 + 1e-8)),
  clamped to 2..5, Detectron2's ``assign_boxes_to_levels``;
* ``TwoFCHead``: fc6 and fc7 (``layers.Dense``) with ReLU over the
  flattened [P, P, C] crop;
* ``TrunkGraphs``: the trunk's TEST forward on the card, captured once a
  canvas in a CUDA graph and replayed after.

The levels are fixed by the architecture, so no configuration key names
them. The canvas must be a multiple of the coarsest trunk stride, 32.
"""

from __future__ import annotations

import itertools
import math

import torch
import torch.nn.functional as F
from torch import nn

from tf_faster_rcnn_torch.models.layers import ConvSame, Dense, shrink_valid
from tf_faster_rcnn_torch.ops.anchors import anchor_grid_on
from tf_faster_rcnn_torch.ops.nms import nms_keep_mask
from tf_faster_rcnn_torch.utils import trace

__all__ = ["FPN", "TwoFCHead", "TrunkGraphs", "RPN_LEVELS", "ROI_LEVELS", "FPN_CHANNELS",
           "FC_DIM", "SIZE_DIVISOR", "level_strides", "pyramid_anchors",
           "anchor_inside", "pyramid_proposals", "assign_levels",
           "NMS_INSTANCES"]

RPN_LEVELS = (2, 3, 4, 5, 6)      # P2-P6: the RPN's levels
ROI_LEVELS = (2, 3, 4, 5)         # P2-P5: the levels RoIs are cropped from
FPN_CHANNELS = 256
FC_DIM = 1024
SIZE_DIVISOR = 32                 # C5's stride: the canvas is a multiple
CANONICAL_LEVEL, CANONICAL_SIZE = 4, 224.0
NMS_INSTANCES = "fpn.nms_instances"   # counter: (image, level) NMS instances
_NEG = -1.0e10


def level_strides(levels=RPN_LEVELS):
    return tuple(2 ** k for k in levels)


class FPN(nn.Module):
    """Laterals ``lateral2``-``lateral5`` and output convs ``output2``-
    ``output5`` over the trunk's [C2, C3, C4, C5]."""

    def __init__(self, in_channels, compute_dtype=torch.float32):
        super().__init__()
        dt = compute_dtype
        for k, c in zip(ROI_LEVELS, in_channels):
            self.add_module(f"lateral{k}", ConvSame(c, FPN_CHANNELS, 1,
                                                    compute_dtype=dt))
        for k in ROI_LEVELS:
            self.add_module(f"output{k}", ConvSame(
                FPN_CHANNELS, FPN_CHANNELS, 3, compute_dtype=dt))

    def forward(self, feats, valid_hw=None):
        """feats: [C2, C3, C4, C5] (margins may be dirty); valid_hw: [B, 2]
        PIXEL extents or None. Returns [P2, ..., P6] and each level's cell
        extents (None without valid_hw)."""
        valid = [None] * len(RPN_LEVELS)
        if valid_hw is not None:
            valid = [shrink_valid(valid_hw, s) for s in level_strides()]
        inner, outs = None, [None] * len(ROI_LEVELS)
        for i in reversed(range(len(ROI_LEVELS))):
            k = ROI_LEVELS[i]
            up = None if inner is None else F.interpolate(
                inner, scale_factor=2.0, mode="nearest")
            inner = getattr(self, f"lateral{k}").with_epilogue(
                feats[i], residual=up, valid_hw=valid[i])
            outs[i] = getattr(self, f"output{k}").with_epilogue(
                inner, valid_hw=valid[i])
        # P6: P5 subsampled (max-pool, kernel 1, stride 2), channels-last as
        # every level is on the card
        p6 = outs[-1][:, :, ::2, ::2]
        p6 = (p6.contiguous(memory_format=torch.channels_last) if p6.is_cuda
              else p6.contiguous())
        return outs + [p6], valid


class TwoFCHead(nn.Module):
    """fc6 and fc7 with ReLU over crops [N, P, P, C] flattened in that
    order -> [N, FC_DIM]."""

    out_channels = FC_DIM

    def __init__(self, pool_size: int, channels: int = FPN_CHANNELS,
                 compute_dtype=torch.float32):
        super().__init__()
        self.fc6 = Dense(pool_size * pool_size * channels, FC_DIM,
                         compute_dtype)
        self.fc7 = Dense(FC_DIM, FC_DIM, compute_dtype)

    def forward(self, pooled):
        x = F.relu(self.fc6(pooled.reshape(pooled.shape[0], -1)))
        return F.relu(self.fc7(x))


class TrunkGraphs:
    """The trunk's TEST forward on the card, replayed from a CUDA graph.

    At batch 8 the trunk is ~380 launches that the host enqueues slower
    than the card runs them (PERF.md §5), so the card waits on the host and
    the step follows the host's speed. A graph replays them in one launch.
    The first call on a canvas runs eagerly (cuDNN's choices and the
    kernels' libraries are made then), the second captures the trunk on
    static copies of its inputs, and every later one copies its inputs in
    and replays. The levels returned are the graph's own buffers, which the
    next call on the canvas overwrites. Only inference mode on a CUDA
    device replays; anything else, and a trunk whose parameters moved,
    runs eagerly or captures anew."""

    def __init__(self):
        self.graphs = {}
        self.params = None

    def __deepcopy__(self, memo):
        return TrunkGraphs()

    def __call__(self, trunk, dtype, image, im_info):
        """trunk's levels of image [B, H, W, 3], cast to dtype and viewed
        NCHW, with im_info[:, :2] as the valid pixel extents."""
        def run(image, im_info):
            return trunk(image.to(dtype).permute(0, 3, 1, 2), im_info[:, :2])
        if (image.device.type != "cuda"
                or not torch.is_inference_mode_enabled()
                or torch.cuda.is_current_stream_capturing()):
            return run(image, im_info)
        params = tuple(t.data_ptr() for t in itertools.chain(
            trunk.parameters(), trunk.buffers()))
        if params != self.params:
            self.graphs.clear()
            self.params = params
        key = (tuple(image.shape), image.dtype, tuple(im_info.shape),
               image.device)
        entry = self.graphs.get(key)
        if entry is None:
            self.graphs[key] = ()
            return run(image, im_info)
        if not entry:
            entry = (image.clone(), im_info.clone(), torch.cuda.CUDAGraph())
            with torch.cuda.graph(entry[2], capture_error_mode="thread_local"):
                entry += (list(run(entry[0], entry[1])),)
            self.graphs[key] = entry
        static_image, static_info, graph, levels = entry
        static_image.copy_(image)
        static_info.copy_(im_info)
        graph.replay()
        return list(levels)


_ANCHORS = {}


def pyramid_anchors(shapes, device, scales, ratios):
    """Anchors of every RPN level, [sum_l fh*fw*A, 4], level after level,
    each in (y, x, a) order; shapes: each level's (fh, fw). Made once for
    each set of shapes, device, scales and ratios; callers do not write to
    it."""
    key = (tuple(shapes), torch.device(device), tuple(scales), tuple(ratios))
    if key not in _ANCHORS:
        # a plain tensor, which any mode may read
        with torch.inference_mode(False):
            _ANCHORS[key] = torch.cat([
                anchor_grid_on(fh, fw, device, s, scales, ratios,
                               base_size=s)
                for (fh, fw), s in zip(shapes, level_strides())])
    return _ANCHORS[key]


def anchor_inside(shapes, num_anchors: int, im_info):
    """[B, N] whether each anchor's cell lies inside its image's extent at
    its level (ceil(extent / stride) cells)."""
    out = []
    for (fh, fw), s in zip(shapes, level_strides()):
        cell = torch.arange(fh * fw * num_anchors,
                            device=im_info.device) // num_anchors
        ext = torch.ceil(im_info[:, :2] / float(s))
        out.append(((cell // fw)[None] < ext[:, :1])
                   & ((cell % fw)[None] < ext[:, 1:]))
    return torch.cat(out, dim=1)


def pyramid_proposals(boxes, scores, valid, level_sizes, pre_n: int,
                      post_n: int, thresh: float):
    """Proposals over the levels: for each image and level the top pre_n
    valid scores (a stable sort, ties to the lower index), greedy NMS
    without the +1 over all B x L (image, level) instances in one K1
    launch (each capped at post_n survivors: no level gives more to the
    union), then the post_n highest survivors over the levels, in a stable
    sort of the level-major candidate list.

    boxes [B, N, 4], scores [B, N], valid [B, N] over the concatenated
    levels; level_sizes: each level's anchor count. Returns (indices into
    N [B, post_n], valid [B, post_n])."""
    b = scores.shape[0]
    order, ok, at = [], [], 0
    neg = torch.full((), _NEG, dtype=scores.dtype, device=scores.device)
    for n in level_sizes:
        s = torch.where(valid[:, at:at + n], scores[:, at:at + n], neg)
        top, idx = torch.sort(s, dim=1, descending=True, stable=True)
        k = min(pre_n, n)
        idx, good = idx[:, :k] + at, top[:, :k] > _NEG / 2
        if k < pre_n:
            idx = F.pad(idx, (0, pre_n - k), value=at)
            good = F.pad(good, (0, pre_n - k), value=False)
        order.append(idx)
        ok.append(good)
        at += n
    levels = len(level_sizes)
    order = torch.stack(order, dim=1).reshape(b, levels * pre_n)
    ok = torch.stack(ok, dim=1).reshape(b * levels, pre_n)
    cand = torch.gather(boxes, 1, order[..., None].expand(-1, -1, 4))
    keep = nms_keep_mask(cand.reshape(b * levels, pre_n, 4), ok, thresh,
                         plus_one=False, suppress_eq=False, max_keep=post_n)
    trace.count(NMS_INSTANCES, b * levels)
    kept = torch.where(keep.reshape(b, levels * pre_n),
                       torch.gather(scores, 1, order),
                       torch.full((), -math.inf, dtype=scores.dtype,
                                  device=scores.device))
    top, sel = torch.sort(kept, dim=1, descending=True, stable=True)
    top, sel = top[:, :post_n], sel[:, :post_n]
    if sel.shape[1] < post_n:
        pad = post_n - sel.shape[1]
        sel = F.pad(sel, (0, pad))
        top = F.pad(top, (0, pad), value=-math.inf)
    return torch.gather(order, 1, sel), top > -math.inf


def assign_levels(rois):
    """Each RoI's index into ROI_LEVELS [B, R] int64: level
    floor(4 + log2(sqrt(w * h) / 224 + 1e-8)), w = x2 - x1, h = y2 - y1,
    clamped to P2..P5 (Detectron2's assign_boxes_to_levels)."""
    r = rois.detach()
    size = torch.sqrt((r[..., 2] - r[..., 0]) * (r[..., 3] - r[..., 1]))
    k = torch.floor(CANONICAL_LEVEL + torch.log2(size / CANONICAL_SIZE
                                                 + 1e-8))
    k = torch.clamp(k, min=ROI_LEVELS[0], max=ROI_LEVELS[-1])
    return k.to(torch.int64) - ROI_LEVELS[0]
