"""The weight bridge: the JAX package's flax params -> the port's state_dict.

The port's modules carry the flax names, so a key is the flax path joined
with dots: ``head/block1/unit_1/conv1/conv/kernel`` becomes
``head.block1.unit_1.conv1.conv.weight``. Layouts change on the way:

* conv kernels HWIO -> OIHW;
* Dense kernels [in, out] -> Linear weights [out, in];
* biases and the FrozenBN arrays (mean, var, scale, bias) as they are.

The input is a nested dict of arrays (numpy, or anything ``np.asarray``
takes): the output of ``FasterRCNN.init`` or ``utils/checkpoint.py::
load_params``, with or without the top-level ``params`` key. Nothing here
imports JAX.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["state_dict_from_flax"]


def _flatten(tree, prefix=()):
    for key in sorted(tree):
        sub = tree[key]
        if isinstance(sub, dict):
            yield from _flatten(sub, prefix + (key,))
        else:
            yield prefix + (key,), sub


def state_dict_from_flax(params) -> dict:
    """Map a flax param tree onto torch state_dict tensors (float32, CPU)."""
    if set(params) == {"params"}:
        params = params["params"]
    out = {}
    for path, leaf in _flatten(params):
        x = np.asarray(leaf, dtype=np.float32)
        name = path[-1]
        if name == "kernel":
            name = "weight"
            if x.ndim == 4:
                x = x.transpose(3, 2, 0, 1)        # HWIO -> OIHW
            elif x.ndim == 2:
                x = x.T                            # [in, out] -> [out, in]
            else:
                raise ValueError(f"kernel {'/'.join(path)} of rank {x.ndim}")
        out[".".join(path[:-1] + (name,))] = torch.from_numpy(
            np.ascontiguousarray(x))
    return out
