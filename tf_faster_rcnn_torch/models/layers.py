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
  canvas, which makes the features independent of the canvas size;
* ``ConvSame.with_epilogue``: the conv, then its bias, FrozenBN, residual
  add, ReLU and mask in one ``frcnn::conv_epilogue`` pass
  (``ops/epilogue.py``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from tf_faster_rcnn_torch.ops.epilogue import (conv_epilogue, float32_eps,
                                               frozen_bn_fold, mask_valid)

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

    def with_epilogue(self, x, *, bn: "FrozenBatchNorm" = None,
                      residual=None, relu: bool = False, valid_hw=None):
        """mask(relu(residual + bn(conv(x)))), each term optional, the
        terms after the conv in one frcnn::conv_epilogue pass. valid_hw:
        [B, 2] cell extents at the output's resolution, or None."""
        dt = self.compute_dtype
        x = x.to(dt)
        bias = None if self.bias is None else self.bias.to(dt)
        if bias is not None and bn is not None:
            raise ValueError("with_epilogue: a conv with a bias and a BN")
        # On the card PyTorch adds a conv's bias in a pass of its own after
        # cuDNN's conv; the epilogue takes that add over, bit for bit. On
        # the CPU the conv adds it inside its sums, and there it stays.
        inner = bias if x.device.type == "cpu" else None
        y = self._conv_forward(x, self.weight.to(dt), inner)
        kw = {} if bn is None else bn.epilogue_operands(dt)
        if bias is not None and inner is None:
            kw["shift"] = bias
        return conv_epilogue(y, residual=residual, relu=relu,
                             valid_hw=valid_hw, **kw)


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
        inv, shift = frozen_bn_fold(self.mean, self.var, self.scale,
                                    self.bias, self.epsilon)
        shape = (1, -1) + (1,) * (x.ndim - 2)
        return x * inv.to(x.dtype).view(shape) + shift.to(x.dtype).view(shape)

    def epilogue_operands(self, dtype: torch.dtype) -> dict:
        """conv_epilogue's operands for activations of dtype: float32
        buffers as they are, folded in the kernel; buffers of another dtype
        folded here in their dtype (TPU.PARAM_DTYPE bfloat16)."""
        if self.var.dtype == torch.float32:
            return {"scale": self.scale, "shift": self.bias,
                    "mean": self.mean, "var": self.var,
                    "eps": float32_eps(self.epsilon)}
        inv, shift = frozen_bn_fold(self.mean, self.var, self.scale,
                                    self.bias, self.epsilon)
        return {"scale": inv.to(dtype), "shift": shift.to(dtype)}


def shrink_valid(valid_hw, stride: int):
    """Valid extent after a stride-s SAME conv or pool: ceil(v / s)."""
    if stride == 1:
        return valid_hw
    return torch.ceil(valid_hw / float(stride))
