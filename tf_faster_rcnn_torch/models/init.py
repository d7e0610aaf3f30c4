"""Seeded random parameters for runs without a checkpoint.

One recipe, drawn two ways: ``init_model`` fills a torch ``FasterRCNN`` from
a ``torch.Generator``; ``numpy_params`` fills a flax-layout tree of the JAX
package's params from a numpy seed, which ``utils/weights.py`` then bridges
into the port, so a test feeds both frameworks the same numbers.

Every tensor is drawn nonzero, unlike the JAX package's from-scratch init,
which zeroes the expand conv of each unit (that leaves every residual branch
dead in a smoke run) and the BN shifts (which hides a canvas-masking fault).
The scales keep activations O(1): the first conv of each backbone (res
``conv1``, vgg16 ``conv1_1``, mobile ``conv2d_0``) is He / 128 for
raw-pixel inputs, each ResNet unit's expand conv (``conv3``) a tenth of He,
every other backbone kernel He (a depthwise kernel's fan-in is its 3x3),
the RPN and class heads 0.01 and the box head 0.001, as in the reference's
initializers.
"""

from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["recipe", "init_model", "numpy_params"]

_STEMS = (["head", "conv1"], ["head", "conv1_1"], ["head", "base", "conv2d_0"])


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
    if top in ("head", "tail"):
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
