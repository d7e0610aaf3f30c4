"""Training engine: the optimizer, the train state and the train step.

Port of ``tf_faster_rcnn_tpu/engine/train.py``:

* ``lr_schedule``: gamma decay at each stepsize boundary, with an optional
  linear warmup; ``scale_recipe`` maps the reference's 1-image schedule
  onto a global batch (the linear-scaling rule);
* the optimizer is SGD with momentum in TensorFlow's form, as
  ``optax.trace`` computes it: ``v = g + m * v``, ``p -= lr * v``, with
  the biases' gradients doubled first under ``DOUBLE_BIAS``. Frozen
  parameters (``requires_grad`` False) are never touched;
* ``TPU.PARAM_DTYPE='bfloat16'`` casts the parameters and FrozenBN's
  buffers to bfloat16, as the JAX package casts its params tree, and the
  momentum trace follows them; every step of the update then runs in the
  parameter's dtype, as optax 0.2's chain does (see ``Optimizer``), so an
  update below about 1/256 of a weight rounds away;
* the schedule's counter is the optimizer's own, as optax's
  ``scale_by_schedule`` count: it advances only on updates that are
  applied, so a step that the NaN guard skips advances ``state.step`` but
  not the learning rate;
* ``make_train_step`` returns ``step(state, batch, noise=None) -> (state,
  metrics)``: forward, losses, weight decay, gradients and the update, with
  no host sync. The NaN guard keeps parameters and momentum by a select,
  never by a multiply (NaN * 0 is NaN), and ``step_skipped`` stays a device
  tensor in the metrics.

The parameters live in the model; the state holds the rest of what the JAX
``TrainState`` holds: the step, the momentum trace, the schedule's count,
and a ``torch.Generator`` that draws each step's sampling noise (the JAX
state's key).

Data parallelism (``make_train_step(..., mesh=)``, ``parallel/mesh.py``):
each rank takes its rows of the global batch and of the global batch's
noise, and minimizes its share of the global objective: its share of each
detection loss over the global normalizers (``engine/losses.py``), plus the
weight decay on the first rank alone, so that it counts once. The gradients
are then summed over the ranks in a few flat buffers, which is the JAX
step's single psum: every rank applies the same update, and the NaN guard
reads the reduced gradients and the global loss, so every rank skips or
applies alike. ``torch.autograd.grad`` bypasses DDP's reducer hooks, so the
step reduces the gradients itself.

The 'model' axis (``make_hybrid_mesh``; ``parallel/tensor_parallel.py``,
``parallel/spatial.py``): the model ranks of a data group run the same
images and noise, so the normalizers are summed over 'data' only. The
weight decay: a replicated tensor's counts once over the whole mesh, a TP
slice's on each model rank for its own slice, and the reported
regularization loss is the one-rank value. The gradients: all summed over
'data'; the spatially split head's also over 'model', each rank holding
the share of its rows; the replicated parameters after the gather and the
TP slices are not summed over 'model'. The NaN guard's verdict is agreed
over the whole mesh, so a non-finite slice skips the step on every rank.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Dict, Optional, Sequence

import torch
from torch import nn

from tf_faster_rcnn_torch.engine.losses import (detection_losses,
                                                global_losses,
                                                weight_decay_loss)
from tf_faster_rcnn_torch.models.network import (DTYPES, ModelSpec,
                                                 TrainNoise)
from tf_faster_rcnn_torch.parallel.mesh import (MODEL_AXIS,
                                                all_reduce_buckets,
                                                data_axis_size, data_index,
                                                model_axis_size, model_index,
                                                psum, tp_dim)
from tf_faster_rcnn_torch.utils.trace import span

__all__ = ["Optimizer", "TrainState", "all_finite", "create_train_state",
           "lr_schedule", "make_train_step", "scale_recipe", "train_loss"]


def lr_schedule(base_lr: float, gamma: float, stepsizes: Sequence[int],
                warmup_steps: int = 0,
                warmup_factor: float = 1.0) -> Callable:
    """step (an integer tensor, or an int) -> learning rate (a float32
    tensor on the step's device): base_lr * gamma ** (boundaries passed),
    ramped linearly from warmup_factor times that over the first
    warmup_steps steps. The arithmetic is the JAX package's, in float32."""
    boundaries = sorted(int(s) for s in stepsizes)

    def lr(step):
        step = torch.as_tensor(step)
        n = torch.zeros_like(step)
        for bound in boundaries:
            n = n + (step >= bound).to(step.dtype)
        # constants by fill kernels: a copy to the card would synchronise
        gamma_t, warmup_t = (torch.full((), float(v), device=step.device)
                             for v in (gamma, warmup_steps))
        value = base_lr * torch.pow(gamma_t, n.to(torch.float32))
        if warmup_steps > 0:
            frac = torch.clamp(step.to(torch.float32) / warmup_t, max=1.0)
            value = value * (warmup_factor + (1.0 - warmup_factor) * frac)
        return value

    return lr


def scale_recipe(batch_size: int) -> dict:
    """Map the reference's 1-image/step schedule onto a global batch by the
    linear-scaling rule: the learning rate times B, the STEPSIZE boundaries
    and the warmup in batched steps, and ``iters(n)`` converting reference
    iteration counts (images) to batched steps. Identity at B = 1 or when
    TPU.AUTO_SCALE_SCHEDULE is off. Reads the port's cfg."""
    from tf_faster_rcnn_torch.config import cfg
    b = max(1, int(batch_size))
    scale = b if bool(cfg.TPU.AUTO_SCALE_SCHEDULE) else 1

    def iters(n):
        return max(1, -(-int(n) // scale))

    warmup = 0
    if scale > 1 and int(cfg.TPU.WARMUP_ITERS) > 0:
        warmup = iters(cfg.TPU.WARMUP_ITERS)
    return {
        "learning_rate": float(cfg.TRAIN.LEARNING_RATE) * scale,
        "stepsizes": [iters(s) for s in cfg.TRAIN.STEPSIZE],
        "warmup_steps": warmup,
        "warmup_factor": float(cfg.TPU.WARMUP_FACTOR) if warmup else 1.0,
        "iters": iters,
        "scale": scale,
    }


@dataclasses.dataclass(frozen=True)
class Optimizer:
    """SGD with TF-form momentum on a schedule: for each trainable
    parameter, g doubled if it is a bias under double_bias, then
    ``v = g + momentum * v`` and ``p = p + (-lr(count)) * v``.

    Each operation rounds to the parameter's dtype, as the optax chain
    does: the momentum and the learning rate are rounded to it first
    (optax.trace multiplies by a weakly typed Python float;
    scale_by_schedule casts the step size to the update's dtype), and
    apply_updates adds in it. At float32 this is plain float32 SGD."""
    lr_fn: Callable
    momentum: float
    double_bias: bool

    @torch.no_grad()
    def apply(self, params: Dict[str, torch.Tensor],
              grads: Dict[str, torch.Tensor], trace: Dict[str, torch.Tensor],
              count: torch.Tensor, finite: Optional[torch.Tensor] = None):
        """Update params and trace in place and advance count, all on the
        device. With finite (a 0-d bool tensor), the update is selected:
        where it is False, every tensor keeps its value and count stays."""
        neg_lr = -self.lr_fn(count)
        scalars = {}
        for name, p in params.items():
            if p.dtype not in scalars:
                scalars[p.dtype] = (
                    torch.full((), self.momentum, dtype=p.dtype,
                               device=p.device), neg_lr.to(p.dtype))
            momentum, step = scalars[p.dtype]
            g = grads[name]
            if self.double_bias and name.endswith(".bias"):
                g = g * 2.0
            v = g + momentum * trace[name]
            new_p = p + step * v
            if finite is not None:
                v = torch.where(finite, v, trace[name])
                new_p = torch.where(finite, new_p, p)
            trace[name].copy_(v)
            p.copy_(new_p)
        count.add_(1 if finite is None else finite.to(count.dtype))


@dataclasses.dataclass
class TrainState:
    """What a training run carries from step to step, beside the model's
    parameters: the step, the schedule's count (the optimizer's own,
    advanced only by applied updates), the momentum trace of each trainable
    parameter, and the generator of the sampling noise."""
    model: nn.Module
    tx: Optimizer
    generator: torch.Generator
    step: torch.Tensor
    count: torch.Tensor
    trace: Dict[str, torch.Tensor]

    def params(self) -> Dict[str, torch.Tensor]:
        """The trainable parameters, by name."""
        return {name: p for name, p in self.model.named_parameters()
                if p.requires_grad}

    def state_dict(self) -> dict:
        """A copy of everything the state and the model hold, but the
        generator (whose state torch keeps apart: ``get_state``)."""
        return {
            "params": {k: v.detach().clone()
                       for k, v in self.model.state_dict().items()},
            "trace": {k: v.clone() for k, v in self.trace.items()},
            "step": int(self.step), "count": int(self.count)}

    @torch.no_grad()
    def load_state_dict(self, state: dict):
        """Load params (a full model state_dict), trace (entries for every
        trainable parameter; others are ignored), step and count, e.g. from
        ``utils/weights.py::train_state_from_flax``."""
        self.model.load_state_dict(state["params"], strict=True)
        for name, t in self.trace.items():
            t.copy_(state["trace"][name])
        self.step.fill_(int(state["step"]))
        self.count.fill_(int(state["count"]))


def create_train_state(spec: ModelSpec, model: nn.Module,
                       generator: torch.Generator,
                       batch_size: int = 1) -> TrainState:
    """Build the state from the port's cfg (TRAIN.LEARNING_RATE, MOMENTUM,
    GAMMA, STEPSIZE, DOUBLE_BIAS and the TPU schedule keys). batch_size is
    the global images per step; > 1 applies scale_recipe. Under
    TPU.PARAM_DTYPE the model's parameters and buffers are cast to that
    dtype in place. The momentum trace starts at zero, on the model's
    device, in the parameters' dtype."""
    from tf_faster_rcnn_torch.config import cfg
    model.to(DTYPES[str(cfg.TPU.PARAM_DTYPE)])
    if model.spec != spec:
        raise ValueError("the model was built from another spec")
    recipe = scale_recipe(batch_size)
    tx = Optimizer(
        lr_schedule(recipe["learning_rate"], float(cfg.TRAIN.GAMMA),
                    recipe["stepsizes"], recipe["warmup_steps"],
                    recipe["warmup_factor"]),
        momentum=float(cfg.TRAIN.MOMENTUM),
        double_bias=bool(cfg.TRAIN.DOUBLE_BIAS))
    dev = next(model.parameters()).device
    return TrainState(
        model=model, tx=tx, generator=generator,
        step=torch.zeros((), dtype=torch.int64, device=dev),
        count=torch.zeros((), dtype=torch.int64, device=dev),
        trace={name: torch.zeros_like(p)
               for name, p in model.named_parameters() if p.requires_grad})


def all_finite(total: torch.Tensor, grads) -> torch.Tensor:
    """A 0-d bool device tensor: the loss and every gradient are finite."""
    return torch.stack([torch.isfinite(total)] + [
        torch.isfinite(g).all() for g in grads]).all()


def train_loss(model: nn.Module, batch: Dict[str, torch.Tensor],
               weight_decay: float, bias_decay: bool = False,
               noise: Optional[TrainNoise] = None,
               generator: Optional[torch.Generator] = None,
               mobile_weight_decay: Optional[float] = None,
               regu_depth: bool = False, mesh=None):
    """The TRAIN forward and its loss: (total, metrics), total with its
    graph, metrics detached (the four losses, regularization_loss and
    total_loss). The decay arguments are weight_decay_loss's.

    mesh: the mesh (parallel/mesh.py), None for one process. batch is this
    data group's rows of the global batch (FasterRCNN.forward's shard;
    with ``canvas_h``, this model rank's rows of the canvas), total is this
    rank's share of the global objective (module docstring), and the
    metrics are the global batch's values."""
    index = data_index(mesh)
    canvas_h = batch.get("canvas_h")
    out = model(batch["image"], batch["im_info"], batch["gt_boxes"],
                batch["gt_valid"], noise=noise, generator=generator,
                shard=(index, data_axis_size(mesh)), canvas_h=canvas_h)
    reduce = psum(mesh)
    losses = detection_losses(out, reduce)
    decay = functools.partial(weight_decay_loss, model, weight_decay,
                              bias_decay, mobile_weight_decay, regu_depth)
    if model_axis_size(mesh) == 1:
        own = reg = decay()
    else:
        own, reg = _hybrid_decay(decay, model, mesh, canvas_h is not None)
    total = losses["total_loss"] + own if index == 0 else \
        losses["total_loss"]
    metrics = global_losses(losses, reduce)
    metrics["regularization_loss"] = reg.detach()
    metrics["total_loss"] = metrics["total_loss"] + reg.detach()
    return total, metrics


def _hybrid_decay(decay, model: nn.Module, mesh, spatial: bool):
    """(this rank's share of the weight decay, the whole decay) on a mesh
    with a model axis, for a data group's rank of index 0: the replicated
    tensors' decay and this rank's TP slices' on every model rank, the
    spatially split head's (summed over 'model' with its gradients) on
    model rank 0 alone; the whole is the one-rank value."""
    backbone = model.spec.backbone

    def role(name):
        if tp_dim(name, backbone) is not None:
            return "tp"
        return "summed" if spatial and name.startswith("head.") else \
            "replicated"

    rep, tp, summed = (decay(keep=lambda n, r=r: role(n) == r)
                       for r in ("replicated", "tp", "summed"))
    own = rep + tp + summed if model_index(mesh) == 0 else rep + tp
    return own, rep + psum(mesh, MODEL_AXIS)(tp) + summed.detach()


def make_train_step(model: nn.Module, spec: ModelSpec, *,
                    weight_decay: float, bias_decay: bool = False,
                    mobile_weight_decay: Optional[float] = None,
                    regu_depth: bool = False,
                    lr_fn: Optional[Callable] = None,
                    nan_guard: bool = False, mesh=None) -> Callable:
    """Returns ``step(state, batch, noise=None) -> (state, metrics)``.

    batch: dict of tensors on the model's device: 'image' [B, H, W, 3],
    'im_info' [B, 3], 'gt_boxes' [B, G, 5], 'gt_valid' [B, G]. noise: the
    step's TrainNoise, or None to draw it from state.generator.
    mobile_weight_decay and regu_depth: MobileNet's decay
    (engine/losses.py::weight_decay_loss). The state
    is updated in place and returned; metrics are 0-d device tensors: the
    four losses, regularization_loss, total_loss, step_skipped under
    nan_guard and learning_rate (lr_fn at the step) if lr_fn is given.

    nan_guard: when the loss or any gradient is not finite, the update is
    skipped whole (the step still advances, the generator still draws) and
    step_skipped is 1; over a model axis, where it is so on any rank.

    mesh: the data-parallel step (module docstring; parallel/mesh.py::
    make_mesh, make_hybrid_mesh), even over one rank. batch is then this
    data group's rows of the global batch (with this model rank's rows of
    the canvas where it holds ``canvas_h``: parallel/mesh.py::shard_batch),
    noise (if given) this data group's rows of the global batch's noise
    (models/network.py::shard_noise), and the metrics are the global
    batch's. The state must be laid out for the mesh (parallel/mesh.py::
    shard_params), its generator seeded alike on every rank.
    """
    if model.spec != spec or spec.mode != "TRAIN":
        raise ValueError("make_train_step needs a model built from this "
                         "spec, in TRAIN mode")

    def step(state: TrainState, batch: Dict[str, torch.Tensor],
             noise: Optional[TrainNoise] = None):
        with span("train.step", step=True):
            with span("train.forward"):
                total, metrics = train_loss(
                    model, batch, weight_decay, bias_decay, noise,
                    state.generator, mobile_weight_decay, regu_depth, mesh)
            with span("train.backward"):
                params = state.params()
                grads = list(torch.autograd.grad(total,
                                                 list(params.values())))
                if mesh is not None:
                    if batch.get("canvas_h") is not None:
                        all_reduce_buckets(
                            [g for name, g in zip(params, grads)
                             if name.startswith("head.")], mesh, MODEL_AXIS)
                    all_reduce_buckets(grads, mesh)
                grads = dict(zip(params, grads))
            with span("train.update"):
                finite = None
                if nan_guard:
                    finite = all_finite(metrics["total_loss"], grads.values())
                    if model_axis_size(mesh) > 1:
                        bad = psum(mesh, MODEL_AXIS)(
                            (~finite).to(torch.float32))
                        finite = psum(mesh)(bad) == 0
                    metrics["step_skipped"] = 1.0 - finite.to(torch.float32)
                if lr_fn is not None:
                    metrics["learning_rate"] = lr_fn(state.step)
                state.tx.apply(params, grads, state.trace, state.count,
                               finite)
                state.step.add_(1)
            return state, metrics

    return step
