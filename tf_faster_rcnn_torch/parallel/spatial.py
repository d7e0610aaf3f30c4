"""Spatial partitioning of the backbone head over the 'model' axis.

In the JAX package ``shard_batch(spatial=True)`` shards the canvas's H over
'model' and GSPMD inserts the halo exchanges of the conv stack and the
all-gather where the spatial sharding ends. Here each model rank runs the
head on its rows of the canvas, and this module does what GSPMD inserted:

* rows: every stage's output rows are split as evenly as possible over the
  model ranks (``row_split``: the first H % m ranks hold one more), so each
  output row is computed by exactly one rank. A rank's input rows follow
  from its output rows, the kernel, the stride and the padding;
* halos (``_Halo``): each rank sends the top and the bottom T rows it
  holds (zero-padded to T where it holds fewer), T being the farthest any
  rank reaches past its own rows at this op, in one all_gather over the
  model group (gloo takes no point-to-point CUDA tensors, so the exchange
  is a collective, the same on NCCL and gloo). Backward, an all_reduce of
  the slabs' gradients returns each halo row's gradient to its owner,
  which adds it. An op whose rows all lie on their owner (T = 0) makes no
  collective;
* edges: only the global top and bottom get the op's padding (zeros for
  ``conv2d_same`` and the res stem's pad, none for vgg16's SAME pool, whose
  odd last window ceil_mode closes); the interior boundaries get halo rows;
* ``mask_valid`` compares global row indices (``models/layers.py``, its
  ``row0``);
* the gather (``_GatherRows``): at the head's end an all_gather along H
  returns the whole feature map to every rank of the group. Its backward
  is this rank's rows of the gradient, not a sum: everything after it runs
  replicated within the group, so every rank holds the whole gradient.

The head's parameters then hold partial gradients (each rank's rows), which
the train step sums over 'model' (``engine/train.py``). It covers every
backbone's head: ``conv2d_same`` at stride 1 and 2 (the depthwise convs of
mobile too), the res stem's zero pad(1) and 3x3/2 VALID max-pool, the
bottlenecks' strided shortcuts, vgg16's 2x2/2 SAME pools. Halos travel in
the compute dtype.
"""

from __future__ import annotations

from typing import List, Tuple

import torch
import torch.distributed as tdist
import torch.nn.functional as F

from tf_faster_rcnn_torch.models import mobilenet_v1, vgg16
from tf_faster_rcnn_torch.models.layers import mask_valid, shrink_valid

__all__ = ["row_split", "SpatialPartition", "partition"]


def row_split(h: int, count: int) -> List[Tuple[int, int]]:
    """The rows [start, stop) of each of count ranks of h rows, as even as
    possible: the first h % count ranks hold one more."""
    per, extra = divmod(h, count)
    out, start = [], 0
    for r in range(count):
        stop = start + per + (1 if r < extra else 0)
        out.append((start, stop))
        start = stop
    return out


class _Halo(torch.autograd.Function):
    """The rows a rank needs of a tensor split by rows (dim 2), from its
    own x and the top and bottom t rows of every rank of the group (one
    all_gather), assembled by plan: runs (source, first, length), source
    'own' or the rank whose slab (its top t rows, then its bottom t, each
    zero-padded to t) holds them. Backward, the gradient of each slab row
    is summed over the group (one all_reduce) and added by its owner; the
    function's output is the only input of the op that follows it on every
    rank, so every rank enters the backward collective."""

    @staticmethod
    def forward(ctx, x, group, count, index, t, plan):
        ctx.group, ctx.index, ctx.t, ctx.plan = group, index, t, plan
        ctx.x_shape = x.shape
        n = x.shape[2]
        top, bottom = x[:, :, :t], x[:, :, max(0, n - t):]
        slab = torch.cat([F.pad(top, (0, 0, 0, t - top.shape[2])),
                          F.pad(bottom, (0, 0, t - bottom.shape[2], 0))],
                         dim=2).contiguous()
        slabs = [torch.empty_like(slab) for _ in range(count)]
        tdist.all_gather(slabs, slab, group=group)
        ctx.slab_shape = (count,) + tuple(slab.shape)
        return torch.cat([(x if key == "own" else slabs[key])
                          [:, :, first:first + length]
                          for key, first, length in plan], dim=2)

    @staticmethod
    def backward(ctx, grad):
        t = ctx.t
        grad_x = grad.new_zeros(ctx.x_shape)
        grad_slabs = grad.new_zeros(ctx.slab_shape)
        offset = 0
        for key, first, length in ctx.plan:
            dest = grad_x if key == "own" else grad_slabs[key]
            dest[:, :, first:first + length] += grad[:, :, offset:
                                                     offset + length]
            offset += length
        tdist.all_reduce(grad_slabs, group=ctx.group)
        mine = grad_slabs[ctx.index]
        m = min(t, grad_x.shape[2])
        grad_x[:, :, :m] += mine[:, :, :m]
        grad_x[:, :, grad_x.shape[2] - m:] += mine[:, :, 2 * t - m:]
        return grad_x, None, None, None, None, None


class _GatherRows(torch.autograd.Function):
    """The whole of a tensor split by rows (dim 2) over the group, on
    every rank; backward, this rank's rows of the gradient."""

    @staticmethod
    def forward(ctx, x, group, rows, index):
        ctx.own = rows[index]
        tallest = max(stop - start for start, stop in rows)
        pad = tallest - x.shape[2]
        x = F.pad(x, (0, 0, 0, pad)) if pad else x.contiguous()
        parts = [torch.empty_like(x) for _ in rows]
        tdist.all_gather(parts, x, group=group)
        return torch.cat([p[:, :, :stop - start]
                          for p, (start, stop) in zip(parts, rows)], dim=2)

    @staticmethod
    def backward(ctx, grad):
        start, stop = ctx.own
        return grad[:, :, start:stop], None, None, None


def _runs(sources):
    """Coalesce per-row sources (key, index) into runs (key, first,
    length) of consecutive indices."""
    runs = []
    for key, i in sources:
        if runs and runs[-1][0] == key and runs[-1][1] + runs[-1][2] == i:
            runs[-1][2] += 1
        else:
            runs.append([key, i, 1])
    return runs


class SpatialPartition:
    """The backbone head of a FasterRCNN on this rank's rows of the canvas
    (module docstring), over a model group of count ranks, this one at
    index."""

    def __init__(self, group, count: int, index: int):
        self.group, self.count, self.index = group, count, index

    # --- rows -------------------------------------------------------------

    def _fetch(self, x, h: int, needed):
        """The rows needed[index] = [lo, hi) (inside [0, h)) of a tensor
        split by row_split(h) of which this rank holds x, given every
        rank's needed rows."""
        owned = row_split(h, self.count)
        reach = max([0] + [max(o - lo, hi - e) for (o, e), (lo, hi)
                           in zip(owned, needed) if hi > lo])
        (o, e), (lo, hi) = owned[self.index], needed[self.index]
        if reach == 0:
            return x[:, :, lo - o:hi - o]
        t = reach
        sources = []
        for y in range(lo, hi):
            r = next(r for r, (a, b) in enumerate(owned) if a <= y < b)
            if r == self.index:
                sources.append(("own", y - o))
            elif r < self.index:        # the owner's bottom slab
                sources.append((r, 2 * t - (owned[r][1] - y)))
            else:                       # the owner's top slab
                sources.append((r, y - owned[r][0]))
        plan = tuple(tuple(run) for run in _runs(sources))
        return _Halo.apply(x, self.group, self.count, self.index, t, plan)

    def _window(self, x, h: int, kernel: int, stride: int, pad: int,
                h_out: int, fill: float = 0.0):
        """The input rows of this rank's output rows of a window op (kernel,
        stride and top padding pad along H; h_out output rows), with fill
        rows where the window passes the global edges."""
        needed = []
        for a, b in row_split(h_out, self.count):
            if b <= a:
                raise ValueError(f"spatial partitioning: {h_out} rows at a "
                                 f"stage leave a rank of {self.count} with "
                                 "none")
            needed.append((a * stride - pad, (b - 1) * stride - pad + kernel))
        lo, hi = needed[self.index]
        rows = self._fetch(x, h, [(max(a, 0), min(b, h)) for a, b in needed])
        top, bottom = max(0, -lo), max(0, hi - h)
        if top or bottom:
            rows = F.pad(rows, (0, 0, top, bottom), value=fill)
        return rows

    def row0(self, h: int) -> int:
        """The first global row that this rank holds of h rows."""
        return row_split(h, self.count)[self.index][0]

    def mask(self, x, h: int, valid_hw):
        return mask_valid(x, valid_hw, row0=self.row0(h))

    # --- ops --------------------------------------------------------------

    def conv(self, module, x, h: int):
        """A ConvSame (conv2d_same, any stride and groups) on this rank's
        rows: (output rows, global output height)."""
        k, s, p = module.kernel_size[0], module.stride[0], module.padding[0]
        h_out = (h + 2 * p - k) // s + 1
        rows = self._window(x, h, k, s, p, h_out)
        dt = module.compute_dtype
        bias = None if module.bias is None else module.bias.to(dt)
        y = F.conv2d(rows.to(dt), module.weight.to(dt), bias, module.stride,
                     (0, module.padding[1]), module.dilation, module.groups)
        return y, h_out

    def subsample(self, x, h: int, stride: int):
        """x[:, :, ::stride, ::stride] on this rank's rows."""
        h_out = (h - 1) // stride + 1
        rows = self._window(x, h, 1, stride, 0, h_out)
        return rows[:, :, ::stride, ::stride], h_out

    def stem_pool(self, x, h: int):
        """The res stem's zero pad(1) and 3x3/2 VALID max-pool."""
        h_out = (h - 1) // 2 + 1
        rows = self._window(x, h, 3, 2, 1, h_out)
        return F.max_pool2d(F.pad(rows, (1, 1)), 3, 2), h_out

    def same_pool(self, x, h: int):
        """vgg16's 2x2/2 SAME max-pool (ceil_mode closes the odd last
        window at the global bottom)."""
        h_out = -(-h // 2)
        rows = self._window(x, h, 2, 2, 0, h_out, fill=-torch.inf)
        return F.max_pool2d(rows, 2, 2, ceil_mode=True), h_out

    def gather(self, x, h: int):
        """The whole feature map from every rank's rows."""
        return _GatherRows.apply(x, self.group, row_split(h, self.count),
                                 self.index)

    # --- the heads --------------------------------------------------------

    def head(self, head, x, canvas_h: int, valid_hw):
        """head (of any backbone) on this rank's rows x [B, C, H / count,
        W] of a canvas of canvas_h rows, valid_hw the per-image pixel
        extents: the whole feature map, as head(canvas, valid_hw) gives
        it."""
        if isinstance(head, vgg16.VGG16Head):
            x, h = self._vgg16(head, x, canvas_h, valid_hw)
        elif isinstance(head, mobilenet_v1.MobileNetV1Head):
            x, h = self._mobile(head.base, x, canvas_h, valid_hw)
        else:
            x, h = self._resnet(head, x, canvas_h, valid_hw)
        return self.gather(x, h)

    def _vgg16(self, head, x, h, valid_hw):
        for i, (reps, _, name) in enumerate(vgg16._CFG):
            for r in range(reps):
                x, h = self.conv(getattr(head, f"{name}_{r + 1}"), x, h)
                x = self.mask(F.relu(x), h, valid_hw)
            if i < len(vgg16._CFG) - 1:
                x, h = self.same_pool(x, h)
                valid_hw = shrink_valid(valid_hw, 2)
                x = self.mask(x, h, valid_hw)
            if name == "conv2":
                x = x.detach()
        return x, h

    def _mobile(self, layers, x, h, valid_hw):
        for i in layers.rows:
            sep, stride, _ = mobilenet_v1.CONV_DEFS[i]
            layer = getattr(layers, f"conv2d_{i}")
            if sep:
                x, h = self.conv(layer.depthwise, x, h)
                x = F.relu6(layer.depthwise_bn(x))
                x = F.relu6(layer.pointwise_bn(layer.pointwise(x)))
            else:
                x, h = self.conv(layer, x, h)
                x = F.relu6(getattr(layers, f"conv2d_{i}_bn")(x))
            valid_hw = shrink_valid(valid_hw, stride)
            x = self.mask(x, h, valid_hw)
            if i == layers.stop_grad_after:
                x = x.detach()
        return x, h

    def _conv_bn(self, unit, x, h):
        x, h = self.conv(unit.conv, x, h)
        x = unit.bn(x)
        return (F.relu(x) if unit.relu else x), h

    def _bottleneck(self, unit, x, h, valid_hw):
        if unit.shortcut is not None:
            shortcut, _ = self._conv_bn(unit.shortcut, x, h)
        elif unit.stride == 1:
            shortcut = x
        else:
            shortcut, _ = self.subsample(x, h, unit.stride)
        r = self.mask(unit.conv1(x), h, valid_hw)
        r, h = self._conv_bn(unit.conv2, r, h)
        return F.relu(shortcut + unit.conv3(r)), h

    def _resnet(self, head, x, h, valid_hw):
        x, h = self.conv(head.conv1, x, h)
        x = F.relu(head.conv1_bn(x))
        valid_hw = shrink_valid(valid_hw, 2)
        x = self.mask(x, h, valid_hw)
        x, h = self.stem_pool(x, h)
        valid_hw = shrink_valid(valid_hw, 2)
        x = self.mask(x, h, valid_hw).detach()
        for b, s in enumerate(head.block_strides):
            block = getattr(head, f"block{b + 1}")
            for u, us in enumerate(block.strides):
                x, h = self._bottleneck(getattr(block, f"unit_{u + 1}"), x,
                                        h, valid_hw)
                valid_hw = shrink_valid(valid_hw, us)
            if b + 1 <= head.fixed_blocks:
                x = x.detach()
        return self.mask(x, h, valid_hw), h


def partition(model, mesh):
    """Install spatial partitioning over the mesh's model group on a
    FasterRCNN (``model.spatial``): its forward then runs the head on a
    batch's rows where the batch says it holds rows (``canvas_h``,
    ``parallel/mesh.py::split_canvas``). Returns the model."""
    from tf_faster_rcnn_torch.parallel.mesh import (MODEL_AXIS,
                                                    model_axis_size,
                                                    model_index)
    model.spatial = SpatialPartition(mesh.get_group(MODEL_AXIS),
                                     model_axis_size(mesh),
                                     model_index(mesh))
    return model
