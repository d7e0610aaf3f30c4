"""Seeded random parameters: two recipes.

``reference_init`` draws what the JAX package's ``model.init`` draws where
no checkpoint is loaded, tensor by tensor in distribution (flax's
initializers; torch cannot draw JAX's bits). The training loop, test_net
and convert_weights start from it, and a checkpoint then overwrites what it
holds: a run fine-tuned from an ImageNet checkpoint starts its detection
heads as the JAX package's do, and a run from scratch starts in the regime
the JAX package's from-scratch inits were built for.

The smoke recipe, drawn two ways: ``init_model`` fills a torch
``FasterRCNN`` from a ``torch.Generator``; ``numpy_params`` fills a
flax-layout tree of the JAX package's params from a numpy seed, which
``utils/weights.py`` then bridges into the port, so a test feeds both
frameworks the same numbers.

Every tensor of the smoke recipe is drawn nonzero, unlike the from-scratch
init, which zeroes the expand conv of each unit (that leaves every residual
branch dead in a smoke run) and the BN shifts (which hides a canvas-masking
fault). The scales keep activations O(1): the first conv of each backbone
(res ``conv1``, vgg16 ``conv1_1``, mobile ``conv2d_0``) is He / 128 for
raw-pixel inputs, each ResNet unit's expand conv (``conv3``) a tenth of He,
every other backbone kernel He (a depthwise kernel's fan-in is its 3x3),
the RPN and class heads 0.01 and the box head 0.001, as in the reference's
initializers.
"""

from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["recipe", "init_model", "numpy_params", "reference_dist",
           "reference_init"]

_STEMS = (["head", "conv1"], ["head", "conv1_1"], ["head", "base", "conv2d_0"])
# flax's variance_scaling(..., "truncated_normal") draws a normal truncated
# at +-2 and divides by its std, so the tensor's std is sqrt(scale / fan_in)
TRUNC_STD = 0.87962566103423978
PIXEL_STD = 128.0           # layers.stem_init: the stem of raw-pixel inputs


def recipe(path: str, leaf: str, fan_in: int):
    """Distribution of one tensor: ("normal", std) or ("uniform", lo, hi).

    path: module path with "/" or "." separators, flax names
    ("head/block1/unit_1/conv3/conv"); leaf: "kernel" or "weight", "bias",
    or a FrozenBN buffer ("mean", "var", "scale"); fan_in of a kernel.
    """
    parts = path.replace(".", "/").split("/")
    if parts[-1].endswith("bn"):
        if leaf in ("var", "scale"):
            return ("uniform", 0.5, 1.5)
        return ("normal", 0.1)                     # mean, bias
    if leaf == "bias":
        return ("normal", 0.01)
    he = math.sqrt(2.0 / fan_in)
    top = parts[0]
    if top in ("head", "tail", "fpn"):
        if parts in _STEMS:
            return ("normal", he / 128.0)          # raw-pixel stem input
        if parts[-2:] == ["conv3", "conv"]:
            return ("normal", 0.1 * he)            # expand conv of a unit
        return ("normal", he)
    if top == "bbox_pred":
        return ("normal", 0.001)
    return ("normal", 0.01)                        # rpn_*, cls_score


def _torch_fan_in(t: torch.Tensor) -> int:
    return int(np.prod(t.shape[1:])) if t.ndim > 1 else 1


@torch.no_grad()
def init_model(model: torch.nn.Module, generator: torch.Generator):
    """Redraw every parameter and FrozenBN buffer of model in place, in
    state_dict order, from generator (a CPU generator: the draw is the same
    whatever the model's device)."""
    for name, t in model.state_dict().items():
        path, leaf = name.rsplit(".", 1)
        dist = recipe(path, leaf, _torch_fan_in(t))
        if dist[0] == "normal":
            x = torch.randn(t.shape, generator=generator) * dist[1]
        else:
            x = torch.rand(t.shape, generator=generator)
            x = dist[1] + (dist[2] - dist[1]) * x
        t.copy_(x.to(t.dtype))


def numpy_params(shapes, seed: int):
    """A flax-layout param tree (nested dicts; leaves anything with a
    ``.shape``, e.g. jax.eval_shape output) redrawn with numpy by the same
    recipe. Conv kernels are HWIO and Dense kernels [in, out], so a
    kernel's fan_in is the product of all but its last dim."""
    rng = np.random.RandomState(seed)

    def walk(tree, path):
        out = {}
        for key in sorted(tree):
            sub = tree[key]
            if isinstance(sub, dict):
                out[key] = walk(sub, path + (key,))
                continue
            shape = tuple(sub.shape)
            fan_in = int(np.prod(shape[:-1])) if len(shape) > 1 else 1
            dist = recipe("/".join(path), key, fan_in)
            if dist[0] == "normal":
                x = rng.randn(*shape) * dist[1]
            else:
                x = rng.uniform(dist[1], dist[2], shape)
            out[key] = x.astype(np.float32)
        return out

    if set(shapes) == {"params"}:  # a full variables dict
        return {"params": walk(shapes["params"], ())}
    return walk(shapes, ())


def reference_dist(backbone: str, path: str, leaf: str,
                   truncated: bool = False):
    """The JAX package's initializer of one tensor, as ("zeros",),
    ("ones",), ("scaled", scale) for variance_scaling(scale, "fan_in",
    "truncated_normal"), ("normal", std) or ("truncated", std) for
    truncated_normal(std) (truncated at +-2 std, not rescaled).

    path: the port's module path ("head.block1.unit_1.conv3.conv"); leaf:
    "weight", "bias" or a FrozenBN buffer. The fan-in of a weight in torch
    layout (OIHW or [out, in]) is all but its first dim, so a depthwise
    kernel's is its 3x3 (``_draw``).
    """
    parts = path.split(".")
    if parts[-1].endswith("bn"):            # FrozenBatchNorm's four arrays
        return ("ones",) if leaf in ("var", "scale") else ("zeros",)
    if leaf == "bias":
        return ("zeros",)                    # flax's default bias init
    if parts[0] == "fpn":
        return ("scaled", 1.0)               # the pyramid's convs: Xavier
    if parts[0] in ("head", "tail"):
        if backbone == "vgg16":
            return ("scaled", 1.0)           # lecun_normal, vgg16.py:24-60
        if parts in _STEMS:
            return ("scaled", 2.0 / PIXEL_STD ** 2)      # layers.stem_init
        if parts[-2:] == ["conv3", "conv"]:
            return ("zeros",)                # resnet's zero-init expand conv
        return ("scaled", 2.0)               # He: ConvSame's default
    std = 0.001 if parts[0] == "bbox_pred" else 0.01
    return ("truncated" if truncated else "normal", std)


def _truncated_normal(shape, generator):
    """A standard normal truncated at +-2: the draws beyond are redrawn."""
    x = torch.randn(shape, generator=generator)
    out = (x.abs() > 2.0).nonzero(as_tuple=True)
    while out[0].numel():
        x[out] = torch.randn(out[0].numel(), generator=generator)
        out = tuple(i[x[out].abs() > 2.0] for i in out)
    return x


def _draw(dist, shape, generator):
    if dist[0] == "zeros":
        return torch.zeros(shape)
    if dist[0] == "ones":
        return torch.ones(shape)
    if dist[0] == "normal":
        return torch.randn(shape, generator=generator) * dist[1]
    x = _truncated_normal(shape, generator)
    if dist[0] == "truncated":
        return x * dist[1]
    fan_in = int(np.prod(shape[1:]))
    return x * (math.sqrt(dist[1] / fan_in) / TRUNC_STD)


@torch.no_grad()
def reference_init(model: torch.nn.Module, generator: torch.Generator):
    """Redraw every parameter and FrozenBN buffer of a FasterRCNN in place
    by the JAX package's initializers (``reference_dist``; under
    ``model.spec.truncated``, TRAIN.TRUNCATED, the RPN and class heads draw
    truncated normals), in state_dict order, from generator: a CPU
    generator, so the draw is the same whatever the model's device."""
    spec = model.spec
    for name, t in model.state_dict().items():
        path, leaf = name.rsplit(".", 1)
        dist = reference_dist(spec.backbone, path, leaf, spec.truncated)
        t.copy_(_draw(dist, tuple(t.shape), generator).to(t.dtype))
