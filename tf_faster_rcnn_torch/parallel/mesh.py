"""The data axis of the device mesh, as a ``DeviceMesh``.

Port of ``tf_faster_rcnn_tpu/parallel/mesh.py``, its 'data' axis. Under
GSPMD the JAX step shards the batch over 'data', replicates the state, and
XLA inserts the gradient all-reduce. Here each rank of the process group
(``parallel/dist.py``) is one position on a 1-D ``DeviceMesh`` named
'data', and the code does what XLA inserted:

* the batch: each rank holds its rows of the global batch
  (``shard_batch``, and the data layer's process slicing);
* the state: every rank holds the same full parameters and momentum
  (``replicate``, ``shard_params``);
* the reduce: the train step sums the losses' normalizers and every
  gradient over the axis (``psum``, ``all_reduce_buckets``;
  ``engine/train.py``).

The 'model' axis (Megatron tensor parallelism of the RoI head, spatial
partitioning of the backbone) is not ported: ``make_hybrid_mesh`` raises for
model > 1, naming ROADMAP.md.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, List

import torch
import torch.distributed as tdist

from tf_faster_rcnn_torch.parallel import dist

__all__ = ["DATA_AXIS", "MODEL_AXIS", "MODEL_AXIS_NOT_PORTED", "make_mesh",
           "make_hybrid_mesh", "data_axis_size", "model_axis_size",
           "data_index", "psum", "all_reduce_buckets", "shard_batch",
           "replicate", "shard_params"]

DATA_AXIS = "data"
MODEL_AXIS = "model"
BUCKET_BYTES = 25 * 2 ** 20
MODEL_AXIS_NOT_PORTED = (
    "the 'model' axis of the mesh (TPU.MODEL_DEVICES > 1: tensor "
    "parallelism of the RoI head, spatial partitioning of the backbone) is "
    "not ported yet (ROADMAP.md, Queue A)")


def make_mesh():
    """The 1-D 'data' mesh over the ranks of the process group
    (``parallel.dist.initialize`` first), a rank a device."""
    from torch.distributed.device_mesh import init_device_mesh
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs the process group: call "
                           "parallel.dist.initialize first")
    return init_device_mesh(dist.device().type, (dist.process_count(),),
                            mesh_dim_names=(DATA_AXIS,))


def make_hybrid_mesh(model: int = 1):
    """The ('data', 'model') mesh of the JAX package; model <= 1 is the
    data mesh, and model > 1 raises."""
    if model > 1:
        raise NotImplementedError(f"make_hybrid_mesh(model={model}): "
                                  + MODEL_AXIS_NOT_PORTED)
    return make_mesh()


def _axis_size(mesh, axis) -> int:
    if mesh is None:
        return 1
    names = tuple(mesh.mesh_dim_names or ())
    return mesh.size(names.index(axis)) if axis in names else 1


def data_axis_size(mesh) -> int:
    """The ranks on the data axis (1 for no mesh)."""
    return _axis_size(mesh, DATA_AXIS)


def model_axis_size(mesh) -> int:
    return _axis_size(mesh, MODEL_AXIS)


def data_index(mesh) -> int:
    """This rank's position on the data axis (0 for no mesh)."""
    return 0 if mesh is None else mesh.get_local_rank(DATA_AXIS)


def _one_rank(t: torch.Tensor) -> torch.Tensor:
    return t


def psum(mesh) -> Callable[[torch.Tensor], torch.Tensor]:
    """The sum of a tensor over the data axis, as a function of the tensor
    returning a new one (outside autograd); the identity for no mesh."""
    if mesh is None:
        return _one_rank
    group = mesh.get_group(DATA_AXIS)

    def reduce(t: torch.Tensor) -> torch.Tensor:
        t = t.detach().clone()
        tdist.all_reduce(t, group=group)
        return t

    return reduce


def _buckets(tensors: Iterable[torch.Tensor], limit: int):
    bucket, size = [], 0
    for t in tensors:
        nbytes = t.numel() * t.element_size()
        if bucket and (t.dtype != bucket[0].dtype or size + nbytes > limit):
            yield bucket
            bucket, size = [], 0
        bucket.append(t)
        size += nbytes
    if bucket:
        yield bucket


@torch.no_grad()
def all_reduce_buckets(tensors: List[torch.Tensor], mesh) -> None:
    """Sum each tensor over the data axis, in place: the tensors packed in
    order into flat buffers of one dtype and at most BUCKET_BYTES (one
    tensor may exceed it alone), one all_reduce a buffer."""
    group = mesh.get_group(DATA_AXIS)
    for bucket in _buckets(tensors, BUCKET_BYTES):
        flat = torch.cat([t.reshape(-1) for t in bucket])
        tdist.all_reduce(flat, group=group)
        offset = 0
        for t in bucket:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()


def shard_batch(mesh, batch: Dict) -> Dict:
    """This rank's rows of a global batch: every entry's leading dim split
    into equal parts over the data axis; raises where it does not
    divide."""
    n, i = data_axis_size(mesh), data_index(mesh)
    return {key: value[dist.local_slice(value.shape[0], i, n)]
            for key, value in batch.items()}


@torch.no_grad()
def replicate(mesh, state):
    """The same full state on every rank: each tensor of the model's
    state_dict, the momentum trace, the step and the schedule's count are
    broadcast in place from the data axis's first rank. Returns state."""
    if data_axis_size(mesh) == 1:
        return state
    group = mesh.get_group(DATA_AXIS)
    src = tdist.get_global_rank(group, 0)
    tensors = (list(state.model.state_dict().values())
               + [state.trace[k] for k in sorted(state.trace)]
               + [state.step, state.count])
    for t in tensors:
        tdist.broadcast(t, src=src, group=group)
    return state


def shard_params(mesh, state):
    """The parameters' layout: replicated over the data axis
    (``replicate``); a 'model' axis would split them and raises."""
    if model_axis_size(mesh) > 1:
        raise NotImplementedError(MODEL_AXIS_NOT_PORTED)
    return replicate(mesh, state)
