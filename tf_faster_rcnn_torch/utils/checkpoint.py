"""Parameter files: the port's own, and the JAX package's msgpack exports.

The counterpart of ``save_params`` and ``load_params`` in
``tf_faster_rcnn_tpu/utils/checkpoint.py``. ``save_params`` writes a model's
state_dict with ``torch.save`` (a ``.pt`` file). ``load_params`` reads that,
or a ``.msgpack`` file that the JAX package wrote: its ``save_params``
export, or a training snapshot, of which it takes the ``params`` subtree.
Either way it returns a state_dict of CPU tensors for ``load_state_dict``.

The msgpack is decoded here, with ``msgpack`` imported when called and
without flax: flax writes each array as an extension record (type 1, or 3
for a numpy scalar) holding (shape, dtype name, C-order bytes), bfloat16 by
name, and splits an array over 2**30 bytes into a dict of chunks marked
``__msgpack_chunked_array__``. The tree then goes through
``utils/weights.py::state_dict_from_flax``, as the JAX params do.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from tf_faster_rcnn_torch.utils.weights import state_dict_from_flax

__all__ = ["save_params", "load_params"]

_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3
_CHUNKED = "__msgpack_chunked_array__"


def save_params(path, params):
    """Write a model's parameters (a module or its state_dict) to path with
    torch.save, as CPU tensors."""
    if isinstance(params, torch.nn.Module):
        params = params.state_dict()
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.save({k: v.detach().cpu() for k, v in params.items()}, path)


def load_params(path) -> dict:
    """The state_dict in path: a ``.msgpack`` of the JAX package (bare
    params or a training snapshot), bridged; any other file as
    ``save_params`` wrote it."""
    if str(path).endswith(".msgpack"):
        with open(path, "rb") as f:
            tree = _flax_msgpack_restore(f.read())
        if isinstance(tree, dict) and {"params", "opt_state",
                                       "step"} <= set(tree):
            tree = tree["params"]
        return state_dict_from_flax(tree)
    return torch.load(path, map_location="cpu", weights_only=True)


def _array(shape, dtype_name: str, buf: bytes) -> np.ndarray:
    if dtype_name == "bfloat16":
        # a bfloat16 is the top half of the float32 of the same value
        bits = np.frombuffer(buf, np.uint16).astype(np.uint32) << 16
        return bits.view(np.float32).reshape(shape)
    return np.frombuffer(buf, np.dtype(dtype_name)).reshape(shape)


def _unchunk(tree):
    if not isinstance(tree, dict):
        return tree
    if _CHUNKED in tree:
        shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
        chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        return np.concatenate(chunks).reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def _flax_msgpack_restore(data: bytes):
    """The tree of a flax ``to_bytes`` / ``msgpack_serialize`` payload, with
    numpy leaves (bfloat16 widened to float32)."""
    try:
        import msgpack
    except ImportError as e:
        raise ImportError("loading a .msgpack parameter file needs the "
                          "msgpack package") from e

    def ext_hook(code, payload):
        if code not in (_EXT_NDARRAY, _EXT_NPSCALAR):
            raise ValueError(f"msgpack extension type {code} is not a flax "
                             "array")
        shape, dtype_name, buf = msgpack.unpackb(payload, raw=True)
        arr = _array(tuple(shape), dtype_name.decode(), buf)
        return arr[()] if code == _EXT_NPSCALAR else arr

    return _unchunk(msgpack.unpackb(data, ext_hook=ext_hook, raw=False))
