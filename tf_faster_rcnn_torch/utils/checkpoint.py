"""Snapshots and parameter files: the port's own, and the JAX package's.

The counterpart of ``tf_faster_rcnn_tpu/utils/checkpoint.py``.

A training snapshot is a pair beside each other in the run's output dir:

* ``{prefix}_iter_{step}.pt``: ``torch.save`` of ``{"state":
  TrainState.state_dict(), "generator": the train state's generator
  state}``, CPU tensors only, read back with ``weights_only=True``;
* ``{prefix}_iter_{step}.pkl``: the host meta, plain Python types and numpy
  arrays only (the data layers' states, ``np.random``'s state, the step,
  ``best_map``), as the JAX package writes it.

Neither file imports either package when read back. ``find_previous`` also
finds a JAX ``.msgpack`` snapshot pair, and ``restore`` bridges it: the
optimizer state is decoded from msgpack as a tree of dicts (flax writes
optax's NamedTuples field by field), its momentum trace and schedule count
found by name; a space-to-depth stem is inverted to the 7x7 kernel
(``utils/weights.py``). A JAX snapshot carries a PRNG key, not a torch
generator, so the port then draws fresh noise from a generator seeded with
``RNG_SEED + step`` and says so. The orbax backend and asynchronous saves
(``TPU.CHECKPOINT_BACKEND 'orbax'``, ``TPU.ASYNC_CHECKPOINT``) are the JAX
package's and raise here. The reference keeps the last SNAPSHOT_KEPT
snapshots (train_val.py:221-240) and resumes from the newest (:155-175).

Parameter files: ``save_params`` writes a model's
state_dict with ``torch.save`` (a ``.pt`` file). ``load_params`` reads that,
a training snapshot's ``.pt`` (its ``state["params"]``), or a ``.msgpack``
file that the JAX package wrote: its ``save_params`` export, or a training
snapshot, of which it takes the ``params`` subtree. Either way it returns a
state_dict of CPU tensors for ``load_state_dict``.

The msgpack is decoded here, with ``msgpack`` imported when called and
without flax: flax writes each array as an extension record (type 1, or 3
for a numpy scalar) holding (shape, dtype name, C-order bytes), bfloat16 by
name, and splits an array over 2**30 bytes into a dict of chunks marked
``__msgpack_chunked_array__``. The tree then goes through
``utils/weights.py::state_dict_from_flax``, as the JAX params do.
"""

from __future__ import annotations

import glob
import os
import pickle
import re
from typing import Optional, Tuple

import numpy as np
import torch

from tf_faster_rcnn_torch.utils.weights import (state_dict_from_flax,
                                                train_state_from_flax)

__all__ = ["check_backend", "find_previous", "load_params",
           "remove_old_snapshots", "restore", "restore_meta", "save_params",
           "snapshot"]

_SNAPSHOT = re.compile(r"_iter_(\d+)\.(pt|msgpack)$")

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
    params or a training snapshot), bridged; a training snapshot of the
    port (``snapshot``'s ``.pt``), its parameters; any other file as
    ``save_params`` wrote it."""
    if str(path).endswith(".msgpack"):
        with open(path, "rb") as f:
            tree = _flax_msgpack_restore(f.read())
        if isinstance(tree, dict) and {"params", "opt_state",
                                       "step"} <= set(tree):
            tree = tree["params"]
        return state_dict_from_flax(tree)
    saved = torch.load(path, map_location="cpu", weights_only=True)
    if set(saved) == {"state", "generator"}:
        return saved["state"]["params"]
    return saved


def check_backend():
    """Raise where the port's cfg asks for a checkpoint format that only the
    JAX package writes."""
    from tf_faster_rcnn_torch.config import cfg
    if str(cfg.TPU.CHECKPOINT_BACKEND) != "msgpack":
        raise NotImplementedError(
            f"TPU.CHECKPOINT_BACKEND {cfg.TPU.CHECKPOINT_BACKEND!r}: orbax "
            "is the JAX package's backend; the port writes one .pt snapshot "
            "per save (leave the key at 'msgpack')")
    if bool(cfg.TPU.ASYNC_CHECKPOINT):
        raise NotImplementedError(
            "TPU.ASYNC_CHECKPOINT: asynchronous orbax saves are the JAX "
            "package's; the port saves synchronously")


def _meta_path(output_dir, prefix, step):
    return os.path.join(output_dir, f"{prefix}_iter_{step}.pkl")


def snapshot(output_dir, prefix, state, data_state: dict,
             extra_meta: Optional[dict] = None) -> Tuple[str, str]:
    """Write a (state .pt, host-meta .pkl) snapshot pair of a TrainState;
    returns the two paths."""
    check_backend()
    os.makedirs(output_dir, exist_ok=True)
    saved = state.state_dict()
    step = saved["step"]
    for key in ("params", "trace"):
        saved[key] = {k: v.cpu() for k, v in saved[key].items()}
    sp = os.path.join(output_dir, f"{prefix}_iter_{step}.pt")
    torch.save({"state": saved, "generator": state.generator.get_state()},
               sp)
    mp = _meta_path(output_dir, prefix, step)
    meta = {"data_state": data_state, "np_rng_state": np.random.get_state(),
            "step": step}
    if extra_meta:
        meta.update(extra_meta)
    with open(mp, "wb") as f:
        pickle.dump(meta, f, pickle.HIGHEST_PROTOCOL)
    print(f"Wrote snapshot to: {sp}")
    return sp, mp


def _train_state_from_msgpack(path) -> dict:
    """A JAX snapshot as TrainState.load_state_dict's dict."""
    with open(path, "rb") as f:
        return train_state_from_flax(_flax_msgpack_restore(f.read()))


def restore(state, path: str):
    """Load a snapshot into a TrainState in place and return it. A ``.pt``
    restores the generator too; a JAX ``.msgpack`` reseeds it with
    RNG_SEED + step."""
    if str(path).endswith(".msgpack"):
        from tf_faster_rcnn_torch.config import cfg
        loaded = _train_state_from_msgpack(path)
        state.load_state_dict(loaded)
        seed = int(cfg.RNG_SEED) + loaded["step"]
        state.generator.manual_seed(seed)
        print(f"{path} is a JAX snapshot: its PRNG key has no torch "
              f"counterpart, so the sampling noise is drawn afresh from "
              f"RNG_SEED + step = {seed}")
        return state
    saved = torch.load(path, map_location="cpu", weights_only=True)
    state.load_state_dict(saved["state"])
    state.generator.set_state(saved["generator"])
    return state


def restore_meta(path: str) -> dict:
    """The host meta of a snapshot (a pickle of plain types and numpy
    arrays, this program's own or the JAX package's)."""
    with open(path, "rb") as f:
        return pickle.load(f)


def _snapshots(output_dir, prefix):
    """{step: path} of the snapshots in output_dir; a .pt wins over a
    .msgpack of the same step."""
    entries = {}
    for p in sorted(glob.glob(os.path.join(output_dir, f"{prefix}_iter_*"))):
        m = _SNAPSHOT.search(p)
        if m and (m.group(2) == "pt" or int(m.group(1)) not in entries):
            entries[int(m.group(1))] = p
    return entries


def find_previous(output_dir, prefix):
    """The newest snapshot pair, by step: (step, state path, meta path), or
    None. Snapshots on an LR boundary are valid (the LR is a function of the
    step), unlike the reference's (train_val.py:160-164)."""
    entries = _snapshots(output_dir, prefix)
    if not entries:
        return None
    s = max(entries)
    return s, entries[s], _meta_path(output_dir, prefix, s)


def remove_old_snapshots(output_dir, prefix, keep: int):
    """Delete all but the newest keep snapshot pairs; keep <= 0 deletes
    nothing."""
    if keep <= 0:
        return
    entries = _snapshots(output_dir, prefix)
    for step in sorted(entries)[:-keep]:
        for ext in ("pt", "msgpack", "pkl"):
            path = os.path.join(output_dir, f"{prefix}_iter_{step}.{ext}")
            if os.path.exists(path):
                os.remove(path)


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
