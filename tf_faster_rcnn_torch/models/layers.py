"""Shared building blocks for the backbones, in NCHW.

Port of ``tf_faster_rcnn_tpu/models/layers.py``:

* ``ConvSame``: slim's conv2d_same. For stride > 1 an explicit pad of
  (k-1)//2 before and the rest after, then a VALID conv; for stride 1 a SAME
  conv. For the odd kernels of every backbone both are a symmetric pad.
* ``FrozenBatchNorm``: the reference's frozen BN, an affine transform from
  four buffers. The fold runs in float32; the per-element affine in the
  activation's dtype.
* ``mask_valid`` / ``shrink_valid``: per-image extent masking on a padded
  canvas, which makes the features independent of the canvas size.
"""

from __future__ import annotations

import torch
from torch import nn

__all__ = ["same_padding", "ConvSame", "FrozenBatchNorm", "mask_valid",
           "shrink_valid"]


def same_padding(kernel: int, stride: int) -> int:
    """Per-side padding of slim conv2d_same for an odd kernel: (k-1)//2
    explicit padding then VALID for stride > 1, SAME for stride 1; both are
    symmetric for odd k."""
    if kernel % 2 == 0:
        raise ValueError(f"conv2d_same with an even kernel ({kernel}) pads "
                         "asymmetrically; no backbone uses one")
    return (kernel - 1) // 2


class ConvSame(nn.Conv2d):
    """nn.Conv2d with slim conv2d_same padding (NCHW, OIHW weight)."""

    def __init__(self, in_channels: int, out_channels: int, kernel: int = 3,
                 stride: int = 1, bias: bool = True):
        super().__init__(in_channels, out_channels, kernel, stride,
                         padding=same_padding(kernel, stride), bias=bias)


class FrozenBatchNorm(nn.Module):
    """y = scale * (x - mean) / sqrt(var + eps) + bias over channel dim 1,
    with all four arrays frozen buffers."""

    def __init__(self, channels: int, epsilon: float = 1e-5):
        super().__init__()
        self.epsilon = epsilon
        for name, fill in (("mean", 0.0), ("var", 1.0), ("scale", 1.0),
                           ("bias", 0.0)):
            self.register_buffer(name, torch.full((channels,), fill,
                                                  dtype=torch.float32))

    def forward(self, x):
        inv = self.scale / torch.sqrt(self.var + self.epsilon)
        shift = self.bias - self.mean * inv
        shape = (1, -1) + (1,) * (x.ndim - 2)
        return x * inv.to(x.dtype).view(shape) + shift.to(x.dtype).view(shape)


def mask_valid(x, valid_hw):
    """Zero x [B, C, H, W] at cells beyond the per-image extent valid_hw
    [B, 2] (float cell counts at x's resolution). A select, not a multiply:
    the unmasked margin may hold inf in low precision, and 0 * inf is NaN."""
    _, _, h, w = x.shape
    my = torch.arange(h, dtype=torch.float32, device=x.device) < valid_hw[:, :1]
    mx = torch.arange(w, dtype=torch.float32, device=x.device) < valid_hw[:, 1:]
    m = my[:, None, :, None] & mx[:, None, None, :]
    return torch.where(m, x, torch.zeros((), dtype=x.dtype, device=x.device))


def shrink_valid(valid_hw, stride: int):
    """Valid extent after a stride-s SAME conv or pool: ceil(v / s)."""
    if stride == 1:
        return valid_hw
    return torch.ceil(valid_hw / float(stride))
