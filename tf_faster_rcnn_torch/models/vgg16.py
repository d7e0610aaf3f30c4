"""VGG16 backbone with the reference's detection layout.

Port of ``tf_faster_rcnn_tpu/models/vgg16.py`` in NCHW, with the flax
module names (``conv1_1`` .. ``conv5_3``, ``fc6``, ``fc7``):

* head: 13 SAME 3x3 convs with relu, each followed by ``mask_valid``, and
  a 2x2/2 SAME max-pool after conv1-conv4 (stride 16 at conv5_3). SAME
  pads an odd size at the end with -inf, which is ``ceil_mode=True``. A
  conv's bias, relu and mask run as one ``frcnn::conv_epilogue`` pass
  (``ConvSame.with_epilogue``), and so does the mask after a pool;
* conv1 and conv2 are always frozen: the head detaches after conv2's pool,
  as the JAX head stops the gradient there, and ``trainable_filter`` leaves
  them out of the optimizer;
* tail: fc6 on the pooled crop flattened in (h, w, c) order, as slim's
  flatten (so the flax fc6 kernel bridges unchanged), fc7, each with relu
  and, in TRAIN, dropout 0.5. The keep masks are inputs (the noise seam of
  ``models/network.py``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from tf_faster_rcnn_torch.models.layers import ConvSame, Dense, shrink_valid
from tf_faster_rcnn_torch.ops.epilogue import conv_epilogue

__all__ = ["VGG16Head", "VGG16Tail", "FC_WIDTH", "KEEP_PROB",
           "trainable_filter"]

_CFG = ((2, 64, "conv1"), (2, 128, "conv2"), (3, 256, "conv3"),
        (3, 512, "conv4"), (3, 512, "conv5"))
FC_WIDTH = 4096
KEEP_PROB = 0.5


class VGG16Head(nn.Module):
    """conv1_1 .. conv5_3 -> stride-16, 512-channel features."""

    out_channels = 512

    def __init__(self, compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        in_ch = 3
        for reps, width, name in _CFG:
            for r in range(reps):
                self.add_module(f"{name}_{r + 1}", ConvSame(
                    in_ch, width, 3, 1, compute_dtype=compute_dtype))
                in_ch = width

    def forward(self, x, valid_hw=None):
        """x: [B, 3, H, W]; valid_hw: [B, 2] per-image pixel extents, or
        None. Returns [B, 512, ceil(H/16), ceil(W/16)]."""
        for i, (reps, _, name) in enumerate(_CFG):
            for r in range(reps):
                x = getattr(self, f"{name}_{r + 1}").with_epilogue(
                    x, relu=True, valid_hw=valid_hw)
            if i < len(_CFG) - 1:           # no pool after conv5
                x = F.max_pool2d(x, 2, 2, ceil_mode=True)
                if valid_hw is not None:
                    valid_hw = shrink_valid(valid_hw, 2)
                    x = conv_epilogue(x, valid_hw=valid_hw)
            if name == "conv2":
                x = x.detach()              # conv1 and conv2 are frozen
        return x


def dropout(x, keep):
    """flax Dropout at rate 1 - KEEP_PROB with the keep mask given."""
    return torch.where(keep, x / KEEP_PROB, torch.zeros((), dtype=x.dtype,
                                                        device=x.device))


class VGG16Tail(nn.Module):
    """fc6 and fc7 on pooled crops [N, P, P, 512] (NHWC) -> [N, 4096]."""

    out_channels = FC_WIDTH

    def __init__(self, pool_size: int = 7,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.fc6 = Dense(pool_size * pool_size * VGG16Head.out_channels,
                         FC_WIDTH, compute_dtype)
        self.fc7 = Dense(FC_WIDTH, FC_WIDTH, compute_dtype)

    def forward(self, pooled,
                keep: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
        """keep: the TRAIN dropout keep masks of fc6 and fc7, each bool
        [N, 4096], or None for no dropout (TEST)."""
        x = F.relu(self.fc6(pooled.reshape(pooled.shape[0], -1)))
        if keep is not None:
            x = dropout(x, keep[0])
        x = F.relu(self.fc7(x))
        if keep is not None:
            x = dropout(x, keep[1])
        return x


def trainable_filter(name: str) -> bool:
    """Whether the optimizer updates a head or tail parameter, named
    relative to it ("conv3_1.weight", "fc6.bias"): not conv1 or conv2."""
    return not name.startswith(("conv1_", "conv2_"))
