"""The ('data', 'model') device mesh and its layouts, as a ``DeviceMesh``.

Port of ``tf_faster_rcnn_tpu/parallel/mesh.py``. Under GSPMD the JAX step
lays out the batch and the parameters and XLA inserts the collectives.
Here each rank of the process group (``parallel/dist.py``) is one position
on a ``DeviceMesh`` of shape (ranks / model, model) named ('data',
'model'), with the model ranks of a data group adjacent (rank = d * model +
m, as the JAX grid's ``reshape(data, model)``), and the code does what XLA
inserted:

* the batch: each data group holds its rows of the global batch
  (``shard_batch``, and the data layer's slicing by data index); with
  spatial partitioning, each model rank of the group also holds its rows of
  the canvas (``split_canvas``, JAX's ``shard_batch(spatial=True)``);
* the state: replicated over 'data' (``replicate``); over 'model' the RoI
  head's Megatron layout (``tp_dim``, the counterpart of JAX's ``_VGG_TP``,
  ``_RES_TP`` and ``tp_pspec``) keeps each rank's slice of the matched
  parameters, FrozenBN buffers and momentum entries (``shard_params``,
  ``shard_model``; ``gather_params`` is the inverse), the rest replicated;
* the reduce: the train step sums the losses' normalizers and every
  gradient over 'data', and the spatially split head's gradients over
  'model' too (``psum``, ``all_reduce_buckets``; ``engine/train.py``); the
  collectives of the forward are in ``parallel/tensor_parallel.py`` and
  ``parallel/spatial.py``.

Every collective takes its group from ``mesh.get_group(axis)``.
``make_hybrid_mesh(model <= 1)`` is the 1-D 'data' mesh of ``make_mesh``.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, List, Optional

import torch
import torch.distributed as tdist

from tf_faster_rcnn_torch.parallel import dist

__all__ = ["DATA_AXIS", "MODEL_AXIS", "make_mesh", "make_hybrid_mesh",
           "data_axis_size", "model_axis_size", "data_index", "model_index",
           "psum", "all_reduce_buckets", "shard_batch", "split_canvas",
           "replicate", "tp_dim", "shard_model", "shard_params",
           "gather_params", "layout_name"]

DATA_AXIS = "data"
MODEL_AXIS = "model"
BUCKET_BYTES = 25 * 2 ** 20

# The Megatron layout of the RoI head, keyed by the port's state_dict names
# (the momentum trace uses the parameters' names, so one table places
# both): the split dim of each matched tensor. JAX's tables through the
# weight bridge (utils/weights.py): a flax HWIO kernel's cout (axis 3) is
# an OIHW weight's dim 0 and its cin (axis 2) dim 1; a Dense kernel [in,
# out] is a Linear weight [out, in].
#
# vgg16: fc6 split by columns (its weight's rows and its bias), fc7 by rows
# (its weight's input features), fc7's bias replicated.
_VGG_TP = (("tail.fc6.weight", 0), ("tail.fc6.bias", 0),
           ("tail.fc7.weight", 1))
# res tail (block4, every unit): conv1 by output channels with its FrozenBN,
# conv2 by input channels; conv3 and the shortcut replicated.
_RES_TP = ((".conv1.conv.weight", 0), (".conv1.bn.scale", 0),
           (".conv1.bn.bias", 0), (".conv1.bn.mean", 0),
           (".conv1.bn.var", 0), (".conv2.conv.weight", 1))
# mobile: replicated (its tail's pointwise conv is too small for TP to beat
# its own collective, as in JAX)


def make_mesh():
    """The 1-D 'data' mesh over the ranks of the process group
    (``parallel.dist.initialize`` first), a rank a device."""
    return make_hybrid_mesh(1)


def make_hybrid_mesh(model: int = 1):
    """The ('data', 'model') mesh of the JAX package over the ranks of the
    process group: (ranks / model, model), rank d * model + m at (d, m);
    model <= 1 is the 1-D 'data' mesh. Raises where model does not divide
    the ranks."""
    from torch.distributed.device_mesh import init_device_mesh
    if not dist.is_initialized():
        raise RuntimeError("make_hybrid_mesh needs the process group: call "
                           "parallel.dist.initialize first")
    n, model = dist.process_count(), max(1, int(model))
    if n % model:
        raise ValueError(f"hybrid mesh: TPU.MODEL_DEVICES {model} does not "
                         f"divide the {n} ranks")
    if model == 1:
        return init_device_mesh(dist.device().type, (n,),
                                mesh_dim_names=(DATA_AXIS,))
    return init_device_mesh(dist.device().type, (n // model, model),
                            mesh_dim_names=(DATA_AXIS, MODEL_AXIS))


def _has_axis(mesh, axis) -> bool:
    return mesh is not None and axis in tuple(mesh.mesh_dim_names or ())


def _axis_size(mesh, axis) -> int:
    if not _has_axis(mesh, axis):
        return 1
    return mesh.size(mesh.mesh_dim_names.index(axis))


def data_axis_size(mesh) -> int:
    """The positions on the data axis (1 for no mesh)."""
    return _axis_size(mesh, DATA_AXIS)


def model_axis_size(mesh) -> int:
    """The positions on the model axis (1 for no mesh or a 1-D mesh)."""
    return _axis_size(mesh, MODEL_AXIS)


def data_index(mesh) -> int:
    """This rank's position on the data axis (0 for no mesh)."""
    return 0 if mesh is None else mesh.get_local_rank(DATA_AXIS)


def model_index(mesh) -> int:
    """This rank's position on the model axis (0 without one)."""
    return mesh.get_local_rank(MODEL_AXIS) if model_axis_size(mesh) > 1 \
        else 0


def layout_name(n_data: int, n_model: int) -> str:
    """A layout of n_data x n_model ranks as the JAX CLIs print it."""
    if n_model > 1:
        return f"{n_data} data x {n_model} model"
    return "data-parallel"


def _one_rank(t: torch.Tensor) -> torch.Tensor:
    return t


def psum(mesh, axis: str = DATA_AXIS) -> Callable[[torch.Tensor],
                                                  torch.Tensor]:
    """The sum of a tensor over an axis of the mesh, as a function of the
    tensor returning a new one (outside autograd); the identity for no
    mesh or a mesh without that axis (over a group of one rank, a
    collective all the same)."""
    if not _has_axis(mesh, axis):
        return _one_rank
    group = mesh.get_group(axis)

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
def all_reduce_buckets(tensors: List[torch.Tensor], mesh,
                       axis: str = DATA_AXIS) -> None:
    """Sum each tensor over an axis of the mesh, in place: the tensors
    packed in order into flat buffers of one dtype and at most BUCKET_BYTES
    (one tensor may exceed it alone), one all_reduce a buffer; nothing
    where the mesh has no such axis."""
    if not _has_axis(mesh, axis):
        return
    group = mesh.get_group(axis)
    for bucket in _buckets(tensors, BUCKET_BYTES):
        flat = torch.cat([t.reshape(-1) for t in bucket])
        tdist.all_reduce(flat, group=group)
        offset = 0
        for t in bucket:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()


_GATE_SAID = set()


def split_canvas(mesh, batch: Dict, spatial: bool = True) -> Dict:
    """Spatial partitioning of a data group's batch: with spatial on, a
    'model' axis and a canvas height H that it divides (JAX's own gate),
    this model rank's rows of the image (H / model of them, in rank order)
    and ``canvas_h`` = H, which tells ``FasterRCNN.forward`` that the image
    holds rows; otherwise the batch as it is. A canvas that the gate refuses
    is said once per height."""
    n = model_axis_size(mesh)
    if not spatial or n == 1:
        return batch
    h = int(batch["image"].shape[1])
    if h % n:
        if h not in _GATE_SAID:
            _GATE_SAID.add(h)
            print(f"spatial partitioning off for canvas height {h}: not "
                  f"divisible by the {n} model ranks; the head runs "
                  f"replicated on them")
        return batch
    out = dict(batch)
    out["image"] = batch["image"][:, dist.local_slice(h, model_index(mesh),
                                                      n)]
    out["canvas_h"] = h
    return out


def shard_batch(mesh, batch: Dict, spatial: bool = False) -> Dict:
    """This data group's rows of a global batch: every entry's leading dim
    split into equal parts over the data axis (raises where it does not
    divide); with spatial, also this model rank's rows of the canvas
    (``split_canvas``)."""
    n, i = data_axis_size(mesh), data_index(mesh)
    out = {key: value[dist.local_slice(value.shape[0], i, n)]
           for key, value in batch.items()}
    return split_canvas(mesh, out, spatial)


@torch.no_grad()
def replicate(mesh, state):
    """The same full state on every rank of a data group's column: each
    tensor of the model's state_dict, the momentum trace, the step and the
    schedule's count are broadcast in place from the data axis's first
    rank. Returns state."""
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


def tp_dim(name: str, backbone: str) -> Optional[int]:
    """The dim of the tensor called name (a state_dict or momentum key)
    that the 'model' axis splits, or None where it is replicated."""
    if backbone == "vgg16":
        for pattern, d in _VGG_TP:
            if pattern in name:
                return d
    elif backbone.startswith("res") and name.startswith("tail.block4."):
        for pattern, d in _RES_TP:
            if name.endswith(pattern):
                return d
    return None


def _part(t: torch.Tensor, d: int, index: int, count: int) -> torch.Tensor:
    if t.shape[d] % count:
        raise ValueError(f"a tensor of shape {tuple(t.shape)} does not "
                         f"split over {count} model ranks along dim {d}")
    return t.narrow(d, index * (t.shape[d] // count),
                    t.shape[d] // count).clone()


@torch.no_grad()
def shard_model(mesh, model, backbone: str):
    """Lay a built FasterRCNN out for the mesh's 'model' axis, in place,
    keeping the state_dict names: this rank's slice of each tensor that
    tp_dim matches, the tail's forward made tensor parallel
    (``parallel/tensor_parallel.py``), and spatial partitioning installed
    (``parallel/spatial.py``; used where a batch holds rows). A no-op
    without a model axis. Returns the model."""
    from tf_faster_rcnn_torch.parallel import spatial, tensor_parallel
    n = model_axis_size(mesh)
    if n == 1:
        return model
    i = model_index(mesh)
    for name, t in model.state_dict(keep_vars=True).items():
        d = tp_dim(name, backbone)
        if d is not None:
            t.data = _part(t.data, d, i, n)
    tensor_parallel.parallelize(model, mesh)
    spatial.partition(model, mesh)
    return model


@torch.no_grad()
def shard_params(mesh, state, backbone: Optional[str] = None):
    """The TrainState's layout: replicated over the data axis
    (``replicate``); over the model axis, the parameters, FrozenBN buffers
    and momentum entries that tp_dim matches keep this rank's slice
    (``shard_model``). Every rank must hold the same full state before.
    Returns state."""
    replicate(mesh, state)
    n = model_axis_size(mesh)
    if n == 1:
        return state
    backbone = backbone or state.model.spec.backbone
    shard_model(mesh, state.model, backbone)
    i = model_index(mesh)
    for name, t in state.trace.items():
        d = tp_dim(name, backbone)
        if d is not None:
            state.trace[name] = _part(t, d, i, n)
    return state


def _gather(t: torch.Tensor, d: int, group, n: int) -> torch.Tensor:
    parts = [torch.empty_like(t) for _ in range(n)]
    tdist.all_gather(parts, t.detach().contiguous(), group=group)
    return torch.cat(parts, dim=d)


@torch.no_grad()
def gather_params(mesh, state) -> dict:
    """The layout-free state (``TrainState.state_dict``'s format: params,
    trace, step, count) of a TrainState laid out by shard_params: each TP
    slice gathered over the model axis, a collective every rank of the
    model group enters; the state's own copy without a model axis."""
    n = model_axis_size(mesh)
    if n == 1:
        return state.state_dict()
    backbone = state.model.spec.backbone
    group = mesh.get_group(MODEL_AXIS)

    def full(name, t):
        d = tp_dim(name, backbone)
        return t.detach().clone() if d is None else _gather(t, d, group, n)

    return {"params": {k: full(k, v)
                       for k, v in state.model.state_dict().items()},
            "trace": {k: full(k, v) for k, v in state.trace.items()},
            "step": int(state.step), "count": int(state.count)}
