"""Shared building blocks for the backbones, in NCHW.

Port of ``tf_faster_rcnn_tpu/models/layers.py``:

* ``ConvSame``: slim's conv2d_same. For stride > 1 an explicit pad of
  (k-1)//2 before and the rest after, then a VALID conv; for stride 1 a SAME
  conv. For the odd kernels of every backbone both are a symmetric pad.
  ``groups`` = channels makes it MobileNet's depthwise conv;
* ``ConvSame`` and ``Dense`` (a Linear) compute in their compute dtype, as
  flax's ``dtype=`` does: the input, weight and bias are cast to it at each
  call, so float32 parameters stay the master copy and their gradients
  stay float32;
* ``FrozenBatchNorm``: the reference's frozen BN, an affine transform from
  four buffers. The fold runs in the buffers' dtype (float32, or bfloat16
  under TPU.PARAM_DTYPE as the JAX package casts them); the per-element
  affine in the activation's dtype.
* ``mask_valid`` / ``shrink_valid``: per-image extent masking on a padded
  canvas, which makes the features independent of the canvas size.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["same_padding", "ConvSame", "Dense", "FrozenBatchNorm",
           "mask_valid", "shrink_valid"]


def same_padding(kernel: int, stride: int) -> int:
    """Per-side padding of slim conv2d_same for an odd kernel: (k-1)//2
    explicit padding then VALID for stride > 1, SAME for stride 1; both are
    symmetric for odd k."""
    if kernel % 2 == 0:
        raise ValueError(f"conv2d_same with an even kernel ({kernel}) pads "
                         "asymmetrically; no backbone uses one")
    return (kernel - 1) // 2


class ConvSame(nn.Conv2d):
    """nn.Conv2d with slim conv2d_same padding (NCHW, OIHW weight; a
    depthwise kernel [C, 1, k, k] with groups=C), computing in
    compute_dtype."""

    def __init__(self, in_channels: int, out_channels: int, kernel: int = 3,
                 stride: int = 1, bias: bool = True, groups: int = 1,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__(in_channels, out_channels, kernel, stride,
                         padding=same_padding(kernel, stride), bias=bias,
                         groups=groups)
        self.compute_dtype = compute_dtype

    def forward(self, x):
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return self._conv_forward(x.to(dt), self.weight.to(dt), bias)


class Dense(nn.Linear):
    """nn.Linear computing in compute_dtype (flax Dense with dtype=)."""

    def __init__(self, in_features: int, out_features: int,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__(in_features, out_features)
        self.compute_dtype = compute_dtype

    def forward(self, x):
        dt = self.compute_dtype
        return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))


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
        # in the buffers' dtype, as the JAX fold runs in its params' dtype;
        # epsilon rounded to it first, as JAX rounds a weakly typed scalar
        eps = float(torch.tensor(self.epsilon, dtype=self.var.dtype))
        inv = self.scale / torch.sqrt(self.var + eps)
        shift = self.bias - self.mean * inv
        shape = (1, -1) + (1,) * (x.ndim - 2)
        return x * inv.to(x.dtype).view(shape) + shift.to(x.dtype).view(shape)


def mask_valid(x, valid_hw, row0: int = 0):
    """Zero x [B, C, H, W] at cells beyond the per-image extent valid_hw
    [B, 2] (float cell counts at x's resolution). A select, not a multiply:
    the unmasked margin may hold inf in low precision, and 0 * inf is NaN.
    row0: the global index of x's first row, where x holds a rank's rows of
    a taller map (parallel/spatial.py)."""
    _, _, h, w = x.shape
    my = torch.arange(row0, row0 + h, dtype=torch.float32,
                      device=x.device) < valid_hw[:, :1]
    mx = torch.arange(w, dtype=torch.float32, device=x.device) < valid_hw[:, 1:]
    m = my[:, None, :, None] & mx[:, None, None, :]
    return torch.where(m, x, torch.zeros((), dtype=x.dtype, device=x.device))


def shrink_valid(valid_hw, stride: int):
    """Valid extent after a stride-s SAME conv or pool: ceil(v / s)."""
    if stride == 1:
        return valid_hw
    return torch.ceil(valid_hw / float(stride))
