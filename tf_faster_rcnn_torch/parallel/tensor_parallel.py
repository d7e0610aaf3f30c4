"""Megatron tensor parallelism of the RoI head over the 'model' axis.

In the JAX package GSPMD inserts these collectives from the kernels'
layouts alone (``tf_faster_rcnn_tpu/parallel/mesh.py``, ``_VGG_TP`` and
``_RES_TP``); here the tail's forward does what it inserted. Two autograd
functions over the model group:

* ``copy``: the identity forward, an all_reduce of the gradient backward
  (the input of a split layer: each rank's gradient is a partial sum);
* ``reduce``: an all_reduce forward (the partial sums of a layer split by
  its input features), the identity backward.

Layouts (``parallel/mesh.py::tp_dim`` slices the tensors):

* vgg16: fc6 by columns; ReLU and dropout on the sharded activation, fc6's
  keep mask being this rank's columns of the global mask; fc7 by rows; one
  reduce, then fc7's bias, which is replicated;
* the res tail, every unit of block4: conv1 by output channels with its
  FrozenBN, conv2 by input channels, the reduce after conv2's convolution
  and before its FrozenBN; conv3 and the shortcut replicated;
* mobile: replicated, as in JAX.

The reduce sums in float32 (a bfloat16 partial is widened first), as the
one-rank layer accumulates. ``parallelize`` switches a built model's tail
modules to the subclasses below in place, so the state_dict names stay
and ``utils/checkpoint.py`` and ``utils/weights.py`` find every tensor.
"""

from __future__ import annotations

import torch
import torch.distributed as tdist
import torch.nn.functional as F

from tf_faster_rcnn_torch.models.layers import mask_valid
from tf_faster_rcnn_torch.models.resnet_v1 import Bottleneck
from tf_faster_rcnn_torch.models.vgg16 import VGG16Tail, dropout

__all__ = ["copy", "reduce", "parallelize", "TPVGG16Tail", "TPBottleneck"]


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        tdist.all_reduce(grad, group=ctx.group)
        return grad, None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        total = x.to(torch.float32).contiguous().clone()
        tdist.all_reduce(total, group=group)
        return total.to(x.dtype)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy(x, group):
    """x, whose gradient is summed over the group."""
    return _Copy.apply(x, group)


def reduce(x, group):
    """The sum of x over the group (in float32), whose gradient each rank
    takes as it is."""
    return _Reduce.apply(x, group)


class TPVGG16Tail(VGG16Tail):
    """VGG16Tail with fc6 split by columns and fc7 by rows over tp_group;
    tp_index is this rank's position in it."""

    def forward(self, pooled, keep=None):
        group = self.tp_group
        x = copy(pooled.reshape(pooled.shape[0], -1), group)
        x = F.relu(self.fc6(x))
        if keep is not None:
            width = self.fc6.weight.shape[0]
            cols = keep[0][:, self.tp_index * width:
                           (self.tp_index + 1) * width]
            x = dropout(x, cols)
        dt = self.fc7.compute_dtype
        y = reduce(F.linear(x.to(dt), self.fc7.weight.to(dt)), group)
        y = F.relu(y + self.fc7.bias.to(dt))
        if keep is not None:
            y = dropout(y, keep[1])
        return y


class TPBottleneck(Bottleneck):
    """A block4 unit with conv1 split by output channels and conv2 by
    input channels over tp_group."""

    def forward(self, x, valid_hw=None):
        if self.shortcut is not None:
            shortcut = self.shortcut(x)
        elif self.stride == 1:
            shortcut = x
        else:
            shortcut = x[:, :, ::self.stride, ::self.stride]
        r = self.conv1(copy(x, self.tp_group))
        if valid_hw is not None:
            r = mask_valid(r, valid_hw)
        r = reduce(self.conv2.conv(r), self.tp_group)
        r = F.relu(self.conv2.bn(r))
        r = self.conv3(r)
        return F.relu(shortcut + r)


def parallelize(model, mesh):
    """Make a FasterRCNN's tail tensor parallel over the mesh's model
    group, in place (its tensors sliced by ``mesh.shard_model``): vgg16's
    tail and the res tail's block4 units; mobile stays replicated.
    Returns the model."""
    from tf_faster_rcnn_torch.parallel.mesh import MODEL_AXIS, model_index
    group, index = mesh.get_group(MODEL_AXIS), model_index(mesh)
    backbone = model.spec.backbone
    if backbone == "vgg16":
        modules = [(model.tail, TPVGG16Tail)]
    elif backbone.startswith("res"):
        modules = [(unit, TPBottleneck)
                   for unit in model.tail.block4.children()]
    else:
        modules = []
    for module, cls in modules:
        module.__class__ = cls
        module.tp_group, module.tp_index = group, index
    return model
