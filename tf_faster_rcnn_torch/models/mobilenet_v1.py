"""MobileNet-v1 backbone with the reference's detection modifications.

Port of ``tf_faster_rcnn_tpu/models/mobilenet_v1.py`` in NCHW, with the flax
module names (``base.conv2d_0``, ``base.conv2d_0_bn``, ``base.conv2d_N.
{depthwise,depthwise_bn,pointwise,pointwise_bn}``):

* the 14-row ``CONV_DEFS`` table with layer 12 at stride 1, so the head
  ends at stride 16;
* head = layers 0-11, tail = layers 12-13 on the RoI crops, then a spatial
  mean;
* a separable layer is a 3x3 depthwise conv (groups = channels) with BN and
  relu6, then a 1x1 pointwise conv with BN and relu6; conv2d_same padding,
  FrozenBN with epsilon 0.001, ``mask_valid`` after every head layer;
* widths ``max(int(d * multiplier), 8)``;
* layers 0 .. FIXED_LAYERS-1 frozen: the head detaches after the last of
  them, as the JAX head stops the gradient there, and
  ``trainable_filter`` leaves them out of the optimizer.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from tf_faster_rcnn_torch.models.layers import (ConvSame, FrozenBatchNorm,
                                                mask_valid, shrink_valid)

__all__ = ["MobileNetV1Head", "MobileNetV1Tail", "CONV_DEFS", "depth",
           "trainable_filter"]

# (is_depthwise_separable, stride, depth); layer 12's stride forced to 1
CONV_DEFS = [
    (False, 2, 32),
    (True, 1, 64),
    (True, 2, 128),
    (True, 1, 128),
    (True, 2, 256),
    (True, 1, 256),
    (True, 2, 512),
    (True, 1, 512),
    (True, 1, 512),
    (True, 1, 512),
    (True, 1, 512),
    (True, 1, 512),
    (True, 1, 1024),
    (True, 1, 1024),
]
_EPS = 0.001


def depth(d: int, multiplier: float, min_depth: int = 8) -> int:
    return max(int(d * multiplier), min_depth)


class _SepConv(nn.Module):
    """3x3 depthwise (+BN+relu6) then 1x1 pointwise (+BN+relu6)."""

    def __init__(self, in_ch: int, out_ch: int, stride: int,
                 compute_dtype: torch.dtype):
        super().__init__()
        self.depthwise = ConvSame(in_ch, in_ch, 3, stride, bias=False,
                                  groups=in_ch, compute_dtype=compute_dtype)
        self.depthwise_bn = FrozenBatchNorm(in_ch, _EPS)
        self.pointwise = ConvSame(in_ch, out_ch, 1, 1, bias=False,
                                  compute_dtype=compute_dtype)
        self.pointwise_bn = FrozenBatchNorm(out_ch, _EPS)

    def forward(self, x):
        x = F.relu6(self.depthwise_bn(self.depthwise(x)))
        return F.relu6(self.pointwise_bn(self.pointwise(x)))


class _Layers(nn.Module):
    """CONV_DEFS rows start .. stop-1; the gradient stops after row
    stop_grad_after (-1: nowhere)."""

    def __init__(self, start: int, stop: int, multiplier: float,
                 compute_dtype: torch.dtype, stop_grad_after: int = -1):
        super().__init__()
        self.rows = range(start, stop)
        self.stop_grad_after = stop_grad_after
        in_ch = 3 if start == 0 else depth(CONV_DEFS[start - 1][2],
                                           multiplier)
        for i in self.rows:
            sep, stride, d = CONV_DEFS[i]
            d = depth(d, multiplier)
            if sep:
                self.add_module(f"conv2d_{i}", _SepConv(in_ch, d, stride,
                                                        compute_dtype))
            else:
                self.add_module(f"conv2d_{i}", ConvSame(
                    in_ch, d, 3, stride, bias=False,
                    compute_dtype=compute_dtype))
                self.add_module(f"conv2d_{i}_bn", FrozenBatchNorm(d, _EPS))
            in_ch = d
        self.out_channels = in_ch

    def forward(self, x, valid_hw=None):
        """valid_hw: [B, 2] valid extents of x: the margin is re-zeroed
        after every row."""
        for i in self.rows:
            x = getattr(self, f"conv2d_{i}")(x)
            if not CONV_DEFS[i][0]:
                x = F.relu6(getattr(self, f"conv2d_{i}_bn")(x))
            if valid_hw is not None:
                valid_hw = shrink_valid(valid_hw, CONV_DEFS[i][1])
                x = mask_valid(x, valid_hw)
            if i == self.stop_grad_after:
                x = x.detach()
        return x


class MobileNetV1Head(nn.Module):
    """Layers 0-11 -> stride-16, 512*m-channel features."""

    def __init__(self, multiplier: float = 1.0, fixed_layers: int = 0,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.base = _Layers(0, 12, multiplier, compute_dtype,
                            stop_grad_after=fixed_layers - 1)
        self.out_channels = self.base.out_channels

    def forward(self, x, valid_hw=None):
        """x: [B, 3, H, W]; valid_hw: [B, 2] per-image pixel extents."""
        return self.base(x, valid_hw)


class MobileNetV1Tail(nn.Module):
    """Layers 12-13 on pooled crops [N, P, P, 512*m] (NHWC), then the
    spatial mean -> [N, 1024*m]."""

    def __init__(self, multiplier: float = 1.0,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.base = _Layers(12, 14, multiplier, compute_dtype)
        self.out_channels = self.base.out_channels

    def forward(self, pooled):
        return self.base(pooled.permute(0, 3, 1, 2)).mean(dim=(2, 3))


def trainable_filter(name: str, fixed_layers: int) -> bool:
    """Whether the optimizer updates a head or tail parameter, named
    relative to it ("base.conv2d_3.pointwise.weight"): not layers
    0 .. fixed_layers-1. FrozenBN holds buffers, not parameters."""
    layer = name.split(".")[1]                  # "conv2d_3"
    return int(layer[len("conv2d_"):]) >= fixed_layers
