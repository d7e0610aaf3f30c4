"""Seeded weights, made on the device in one draw.

Every parameter and frozen-BN buffer of a configuration (the reference's
``param_table``) is a slice of one standard-normal draw from a generator on
the device, scaled by its kind:

* convolutions and fully connected layers: He's sqrt(2 / fan_in), the first
  convolution also divided by ``init.stem_divisor`` (the pixels are about
  a hundred times larger than unit scale), so activations stay near unit
  scale through every layer;
* frozen BN: mean 0.1 n, var 1 + 0.1 |n|, scale 1 + 0.1 n, bias 0.1 n; the
  last BN of a bottleneck has its scale times ``init.residual_scale``, so
  the residual stream grows slowly over 33 units;
* the RPN and the class head: the reference's normal(0, 0.01), the box
  deltas normal(0, 0.001); the other biases 0.01 n, the heads' 0. For a
  training cell (mode 'TRAIN') the RPN's and the class head's draws are
  times ``init.train_head_scale`` (1 where the configuration has none), so
  that their losses start where the source's training starts on a
  pretrained backbone, and no seed draws a classifier already sure of one
  class, whose small gradient bfloat16's rounding moves the most.

The same seed gives the same tensors on any device of one kind.
"""

from __future__ import annotations

import math

import torch

from frcnn_bench.reference.model import param_table

__all__ = ["make_weights"]

_STD = {"rpn": 0.01, "cls": 0.01, "rpn_box": 0.001, "box": 0.001,
        "bias": 0.01}


def make_weights(config, seed: int, device, mode: str = "TEST") -> dict:
    """name -> float32 tensor on device, for every entry of the
    configuration's parameter table, drawn for mode ('TEST' or 'TRAIN')."""
    table = param_table(config)
    init = config["init"]
    head = init.get("train_head_scale", 1.0) if mode == "TRAIN" else 1.0
    total = sum(math.prod(shape) for shape, _ in table.values())
    gen = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.randn(total, generator=gen, device=device)
    out, at = {}, 0
    for name, (shape, kind) in table.items():
        n = math.prod(shape)
        x = flat[at:at + n].view(shape)
        at += n
        group, _, leaf = kind.partition(".")
        if kind in ("conv", "fc", "stem"):
            fan_in = math.prod(shape[1:])
            x = x * math.sqrt(2.0 / fan_in)
            if kind == "stem":
                x = x / init["stem_divisor"]
        elif group in ("bn", "last_bn"):
            if leaf == "var":
                x = 1.0 + 0.1 * x.abs()
            elif leaf == "scale":
                x = 1.0 + 0.1 * x
                if group == "last_bn":
                    x = x * init["residual_scale"]
            else:
                x = 0.1 * x
        elif kind == "zero":
            x = torch.zeros_like(x)
        else:
            x = x * _STD[kind]
            if kind in ("rpn", "cls"):
                x = x * head
        out[name] = x
    return out
