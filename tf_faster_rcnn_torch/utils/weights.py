"""The weight bridge: the JAX package's flax params -> the port's state_dict.

The port's modules carry the flax names, so a key is the flax path joined
with dots: ``head/block1/unit_1/conv1/conv/kernel`` becomes
``head.block1.unit_1.conv1.conv.weight``. Layouts change on the way:

* conv kernels HWIO -> OIHW;
* Dense kernels [in, out] -> Linear weights [out, in];
* biases and the FrozenBN arrays (mean, var, scale, bias) as they are;
* the space-to-depth stem's ``head/conv1/kernel`` [4, 4, 4C, O], which the
  JAX package writes under ``TPU.SPACE_TO_DEPTH``
  (``models/resnet_v1.py::s2d_conv1_kernel``), back to the 7x7 kernel
  [O, C, 7, 7] the port runs. Each 7x7 tap sits in exactly one place of the
  4x4 kernel, so the inverse is exact; the places outside the 7x7 support
  must hold zeros, as ``s2d_conv1_kernel`` writes them and a frozen stem
  keeps them, and a nonzero there raises (it has no 7x7 counterpart).

``flax_from_state_dict`` is the inverse bridge: a state_dict as the flax
tree of the same names and layouts, the template that
``utils/slim_import.py`` writes into and the tags of the loop's parameter
histograms.

The input is a nested dict of arrays (numpy, or anything ``np.asarray``
takes): the output of ``FasterRCNN.init`` or ``utils/checkpoint.py::
load_params``, with or without the top-level ``params`` key.
``train_state_from_flax`` bridges a whole JAX ``TrainState`` the same way.
Nothing here imports JAX.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["flatten_tree", "flax_from_state_dict", "s2d_conv1_kernel_inverse",
           "state_dict_from_flax", "train_state_from_flax"]

_S2D_STEM = ("head", "conv1", "kernel")


def flatten_tree(tree, prefix=()):
    """(path tuple, leaf) of a tree of dicts, in sorted key order (the
    order of jax.tree_util's flatten)."""
    for key in sorted(tree):
        sub = tree[key]
        if isinstance(sub, dict):
            yield from flatten_tree(sub, prefix + (key,))
        else:
            yield prefix + (key,), sub


def _s2d_tap(d: int):
    """Where tap d (0..6) of a 7x7 stride-2 kernel sits in the 4x4 kernel of
    the space-to-depth stem: (index in the 4x4 kernel, sub-pixel offset),
    from d = 2 (m - 2) + a + 3."""
    return (d - 3 - (d + 1) % 2) // 2 + 2, (d + 1) % 2


def s2d_conv1_kernel_inverse(k2: np.ndarray) -> np.ndarray:
    """The 7x7 HWIO kernel [7, 7, C, O] of a space-to-depth stem kernel
    [4, 4, 4C, O] (inverse of the JAX package's ``s2d_conv1_kernel``).
    Raises ValueError where a place outside the 7x7 support is nonzero."""
    k2 = np.asarray(k2)
    c, o = k2.shape[2] // 4, k2.shape[3]
    k7 = np.zeros((7, 7, c, o), k2.dtype)
    used = np.zeros(k2.shape, bool)
    for dy in range(7):
        m, a = _s2d_tap(dy)
        for dx in range(7):
            n, b = _s2d_tap(dx)
            ch = (a * 2 + b) * c
            k7[dy, dx] = k2[m, n, ch:ch + c]
            used[m, n, ch:ch + c] = True
    outside = np.abs(k2[~used])
    if outside.size and float(outside.max()) != 0.0:
        raise ValueError(
            "space-to-depth conv1 kernel has nonzero taps outside the 7x7 "
            f"support ({int(np.count_nonzero(outside))} of {outside.size}, "
            f"max |w| {float(outside.max()):.3g}); it has no 7x7 form")
    return k7


def _is_s2d_stem(path, x) -> bool:
    return (tuple(path) == _S2D_STEM and x.ndim == 4
            and x.shape[:2] == (4, 4) and x.shape[2] % 4 == 0)


def state_dict_from_flax(params) -> dict:
    """Map a flax param tree onto torch state_dict tensors (float32, CPU)."""
    if set(params) == {"params"}:
        params = params["params"]
    out = {}
    for path, leaf in flatten_tree(params):
        x = np.asarray(leaf, dtype=np.float32)
        if _is_s2d_stem(path, x):
            x = s2d_conv1_kernel_inverse(x)
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


def flax_from_state_dict(state_dict) -> dict:
    """A state_dict (tensors of any dtype and device) as the flax variables
    dict ``{"params": tree}`` of float32 numpy arrays that
    ``state_dict_from_flax`` maps back onto it: weights renamed ``kernel``,
    conv weights OIHW -> HWIO, Linear weights [out, in] -> [in, out]."""
    tree = {}
    for key, t in state_dict.items():
        x = t.detach().to("cpu", torch.float32).numpy()
        path = key.split(".")
        if path[-1] == "weight":
            path[-1] = "kernel"
            if x.ndim == 4:
                x = x.transpose(2, 3, 1, 0)        # OIHW -> HWIO
            elif x.ndim == 2:
                x = x.T                            # [out, in] -> [in, out]
            else:
                raise ValueError(f"weight {key} of rank {x.ndim}")
        node = tree
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = np.ascontiguousarray(x)
    return {"params": tree}


def _optax_fields(tree, name):
    """Every value named name in a (nested) optax chain state: a field of an
    optax state NamedTuple, or a key of a dict (the same state as flax's
    msgpack writes it, field by field)."""
    if isinstance(tree, dict):
        for key, sub in tree.items():
            if key == name:
                yield sub
            else:
                yield from _optax_fields(sub, name)
    elif isinstance(tree, (tuple, list)):
        if name in getattr(tree, "_fields", ()):
            yield getattr(tree, name)
        for sub in tree:
            yield from _optax_fields(sub, name)


def train_state_from_flax(state) -> dict:
    """The JAX package's TrainState (anything with ``step``, ``params`` and
    ``opt_state``, or a dict of them, as a snapshot's msgpack holds it) as
    the dict ``engine/train.py::TrainState.load_state_dict`` takes:
    ``params`` (the model's state_dict), ``trace`` (the momentum trace of
    optax.trace, in the same layout, by the same names), ``step`` and
    ``count`` (scale_by_schedule's count, which the NaN guard holds back on
    a skipped step)."""
    if isinstance(state, dict):
        missing = {"params", "opt_state", "step"} - set(state)
        if missing:
            raise ValueError(f"not a JAX TrainState: no {sorted(missing)}")
        get = state.__getitem__
    else:
        def get(name):
            return getattr(state, name)
    found = {}
    for field in ("trace", "count"):
        values = list(_optax_fields(get("opt_state"), field))
        if len(values) != 1:
            raise ValueError(f"opt_state holds {len(values)} '{field}' "
                             "states, not one: not the JAX package's "
                             "make_optimizer chain")
        found[field] = values[0]
    return {"params": state_dict_from_flax(get("params")),
            "trace": state_dict_from_flax(found["trace"]),
            "step": int(np.asarray(get("step"))),
            "count": int(np.asarray(found["count"]))}
