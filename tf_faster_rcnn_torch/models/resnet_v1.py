"""ResNet-v1 (50/101/152) backbone with the reference's detection layout.

Port of ``tf_faster_rcnn_tpu/models/resnet_v1.py`` in NCHW, with the flax
module names (``conv1``, ``conv1_bn``, ``blockN/unit_M/{conv1,conv2,conv3,
shortcut}/{conv,bn}``) as attribute names, so a state_dict key is the flax
path joined with dots (``utils/weights.py``).

* stem: conv2d_same(64, 7, /2) -> zero pad(1) -> 3x3/2 VALID max-pool;
* head: blocks 1-3 with strides (2, 2, 1), each block's stride on its LAST
  unit, so conv4 ends at stride 16;
* tail: block4 (stride 1) on the RoI crops, then a spatial mean;
* the pyramid layout (``ResNetV1Head(..., pyramid=True)``, R-101-FPN's
  trunk, Detectron2's ``RESNETS.STRIDE_IN_1X1``): blocks 1-4 all in the
  head, blocks 2-4 strided by 2 in the 1x1 ``conv1`` of their FIRST unit
  (and its shortcut), returning C2-C5 at strides 4, 8, 16 and 32;
* every conv computes in the compute dtype (``layers.ConvSame``), and its
  BN, the residual add, the ReLU and the mask run after it as one
  ``frcnn::conv_epilogue`` pass (``ConvSame.with_epilogue``), as do the
  masks after the stem's pool and at the head's end;
* freezing: every BN is frozen (buffers), the stem always and the first
  ``fixed_blocks`` blocks too. The head detaches at that boundary, as the
  JAX head stops the gradient there, so no backward pass runs through the
  frozen prefix; ``trainable_filter`` names what the optimizer updates.

Only the plain 7x7 stem is ported; the space-to-depth stem is a TPU
workaround.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from tf_faster_rcnn_torch.models.layers import (ConvSame, FrozenBatchNorm,
                                                shrink_valid)
from tf_faster_rcnn_torch.ops.epilogue import conv_epilogue

__all__ = ["Bottleneck", "ResNetV1Head", "ResNetV1Tail", "BLOCK_UNITS",
           "trainable_filter"]

BLOCK_UNITS = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3), 152: (3, 8, 36, 3)}
_BASE_DEPTHS = (64, 128, 256, 512)


class _ConvBN(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, kernel: int = 1,
                 stride: int = 1, relu: bool = True,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv = ConvSame(in_ch, out_ch, kernel, stride, bias=False,
                             compute_dtype=compute_dtype)
        self.bn = FrozenBatchNorm(out_ch)
        self.relu = relu

    def forward(self, x, valid_hw=None, residual=None):
        """relu(bn(conv(x))) (relu only if self.relu), or, with a residual,
        relu(residual + bn(conv(x))); then the mask where valid_hw is
        given. One epilogue pass after the conv."""
        return self.conv.with_epilogue(
            x, bn=self.bn, residual=residual,
            relu=self.relu or residual is not None, valid_hw=valid_hw)


class Bottleneck(nn.Module):
    """1x1 reduce -> 3x3 (the unit stride) -> 1x1 expand, each with BN; relu
    after the residual add. The shortcut is a stride subsample when the
    depth is unchanged, else a 1x1/stride conv + BN. stride_in_1x1: the
    stride sits in the 1x1 reduce instead, and the 3x3 runs at stride 1."""

    def __init__(self, in_ch: int, base_depth: int, stride: int,
                 compute_dtype: torch.dtype = torch.float32,
                 stride_in_1x1: bool = False):
        super().__init__()
        out_ch = base_depth * 4
        self.stride = stride
        self.stride_in_1x1 = stride_in_1x1
        s1, s3 = (stride, 1) if stride_in_1x1 else (1, stride)
        dt = compute_dtype
        if in_ch != out_ch:
            self.shortcut = _ConvBN(in_ch, out_ch, 1, stride, relu=False,
                                    compute_dtype=dt)
        else:
            self.shortcut = None
        self.conv1 = _ConvBN(in_ch, base_depth, 1, s1, compute_dtype=dt)
        self.conv2 = _ConvBN(base_depth, base_depth, 3, s3,
                             compute_dtype=dt)
        self.conv3 = _ConvBN(base_depth, out_ch, 1, 1, relu=False,
                             compute_dtype=dt)

    def forward(self, x, valid_hw=None):
        """valid_hw: [B, 2] valid cell extents of x. The margin is re-zeroed
        only before the 3x3; the output margin is left dirty for the next
        unit's mask, as in the JAX unit."""
        if self.shortcut is not None:
            shortcut = self.shortcut(x)
        elif self.stride == 1:
            shortcut = x
        else:
            shortcut = x[:, :, ::self.stride, ::self.stride]
        if self.stride_in_1x1 and valid_hw is not None:
            valid_hw = shrink_valid(valid_hw, self.stride)
        r = self.conv2(self.conv1(x, valid_hw))
        return self.conv3(r, residual=shortcut)


class _Block(nn.Module):
    """num_units bottlenecks; the block's stride on its last unit's 3x3, or
    with stride_in_1x1 on its first unit's 1x1 (the pyramid layout)."""

    def __init__(self, in_ch: int, base_depth: int, num_units: int,
                 stride: int, compute_dtype: torch.dtype = torch.float32,
                 stride_in_1x1: bool = False):
        super().__init__()
        at = 0 if stride_in_1x1 else num_units - 1
        self.strides = [stride if u == at else 1 for u in range(num_units)]
        for u, s in enumerate(self.strides):
            self.add_module(f"unit_{u + 1}", Bottleneck(
                in_ch, base_depth, s, compute_dtype, stride_in_1x1))
            in_ch = base_depth * 4

    def forward(self, x, valid_hw=None):
        for u, s in enumerate(self.strides):
            x = getattr(self, f"unit_{u + 1}")(x, valid_hw)
            if valid_hw is not None:
                valid_hw = shrink_valid(valid_hw, s)
        return x


class ResNetV1Head(nn.Module):
    """Stem + blocks 1-3 -> stride-16, 1024-channel conv4 features. The
    gradient stops after the stem and after each of the first fixed_blocks
    blocks.

    pyramid: the stem and blocks 1-4 in the pyramid layout (module
    docstring), returning [C2, C3, C4, C5] with their margins left dirty
    (the pyramid's 1x1 laterals mask their outputs); out_channels is then
    the four depths."""

    out_channels = 1024

    def __init__(self, num_layers: int = 101, fixed_blocks: int = 0,
                 compute_dtype: torch.dtype = torch.float32,
                 pyramid: bool = False):
        super().__init__()
        units = BLOCK_UNITS[num_layers]
        self.fixed_blocks = fixed_blocks
        self.pyramid = pyramid
        self.conv1 = ConvSame(3, 64, 7, 2, bias=False,
                              compute_dtype=compute_dtype)
        self.conv1_bn = FrozenBatchNorm(64)
        self.block_strides = (1, 2, 2, 2) if pyramid else (2, 2, 1)
        in_ch = 64
        for b, s in enumerate(self.block_strides):
            self.add_module(f"block{b + 1}", _Block(
                in_ch, _BASE_DEPTHS[b], units[b], s, compute_dtype,
                stride_in_1x1=pyramid))
            in_ch = _BASE_DEPTHS[b] * 4
        if pyramid:
            self.out_channels = tuple(d * 4 for d in _BASE_DEPTHS)

    def forward(self, x, valid_hw=None):
        """x: [B, 3, H, W]; valid_hw: [B, 2] per-image PIXEL extents, or None
        for an input that is all image. Returns [B, 1024, H/16, W/16], or
        with pyramid [C2, C3, C4, C5]."""
        if valid_hw is not None:
            valid_hw = shrink_valid(valid_hw, 2)
        x = self.conv1.with_epilogue(x, bn=self.conv1_bn, relu=True,
                                     valid_hw=valid_hw)
        # zero pad then VALID pool: max_pool2d(padding=1) would pad with -inf
        x = F.max_pool2d(F.pad(x, (1, 1, 1, 1)), 3, 2)
        if valid_hw is not None:
            valid_hw = shrink_valid(valid_hw, 2)
            x = conv_epilogue(x, valid_hw=valid_hw)
        x = x.detach()                      # the stem is always frozen
        levels = []
        for b, s in enumerate(self.block_strides):
            x = getattr(self, f"block{b + 1}")(x, valid_hw)
            if valid_hw is not None:
                valid_hw = shrink_valid(valid_hw, s)
            if b + 1 <= self.fixed_blocks:
                x = x.detach()
            levels.append(x)
        if self.pyramid:
            return levels
        if valid_hw is not None:
            x = conv_epilogue(x, valid_hw=valid_hw)
        return x


class ResNetV1Tail(nn.Module):
    """block4 on pooled crops [N, 7, 7, 1024] (NHWC, as roi_crop_pool
    returns them), then the spatial mean -> [N, 2048]."""

    out_channels = 2048

    def __init__(self, num_layers: int = 101,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.block4 = _Block(_BASE_DEPTHS[2] * 4, _BASE_DEPTHS[3],
                             BLOCK_UNITS[num_layers][3], 1, compute_dtype)

    def forward(self, pooled):
        return self.block4(pooled.permute(0, 3, 1, 2)).mean(dim=(2, 3))


def trainable_filter(name: str, fixed_blocks: int) -> bool:
    """Whether the optimizer updates a parameter of the head or the tail,
    named relative to it ("conv1.weight", "block2.unit_1.conv1.conv.weight"):
    not the stem, not blocks 1..fixed_blocks (the reference's freeze rules,
    resnet_v1.py:88-113). FrozenBN holds buffers, not parameters."""
    top = name.split(".")[0]
    if top == "conv1":
        return False
    return not (top.startswith("block") and int(top[5:]) <= fixed_blocks)
