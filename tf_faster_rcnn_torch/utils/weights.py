"""The weight bridge: the JAX package's flax params -> the port's state_dict.

The port's modules carry the flax names, so a key is the flax path joined
with dots: ``head/block1/unit_1/conv1/conv/kernel`` becomes
``head.block1.unit_1.conv1.conv.weight``. Layouts change on the way:

* conv kernels HWIO -> OIHW;
* Dense kernels [in, out] -> Linear weights [out, in];
* biases and the FrozenBN arrays (mean, var, scale, bias) as they are.

The input is a nested dict of arrays (numpy, or anything ``np.asarray``
takes): the output of ``FasterRCNN.init`` or ``utils/checkpoint.py::
load_params``, with or without the top-level ``params`` key.
``train_state_from_flax`` bridges a whole JAX ``TrainState`` the same way.
Nothing here imports JAX.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["state_dict_from_flax", "train_state_from_flax"]


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
        out[".".join(path[:-1] + (name,))] = torch.from_numpy(np.array(x))
    return out


def _optax_states(tree):
    """Every optax state NamedTuple in a (nested) chain state."""
    if hasattr(tree, "_fields"):
        yield tree
    if isinstance(tree, (tuple, list)):
        for sub in tree:
            yield from _optax_states(sub)


def train_state_from_flax(state) -> dict:
    """The JAX package's TrainState (anything with ``step``, ``params`` and
    ``opt_state``) as the dict ``engine/train.py::TrainState.
    load_state_dict`` takes: ``params`` (the model's state_dict), ``trace``
    (the momentum trace of optax.trace, in the same layout, by the same
    names), ``step`` and ``count`` (scale_by_schedule's count, which the NaN
    guard holds back on a skipped step)."""
    found = {}
    for sub in _optax_states(state.opt_state):
        for field in ("trace", "count"):
            if field in sub._fields:
                if field in found:
                    raise ValueError(f"opt_state holds two '{field}' states")
                found[field] = getattr(sub, field)
    missing = {"trace", "count"} - set(found)
    if missing:
        raise ValueError(f"opt_state has no {sorted(missing)} state: not "
                         "the JAX package's make_optimizer chain")
    return {"params": state_dict_from_flax(state.params),
            "trace": state_dict_from_flax(found["trace"]),
            "step": int(np.asarray(state.step)),
            "count": int(np.asarray(found["count"]))}
