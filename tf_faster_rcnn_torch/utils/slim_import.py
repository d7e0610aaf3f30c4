"""Pretrained-weight import: slim/TF variable dicts into the port's model.

A copy of ``tf_faster_rcnn_tpu/utils/slim_import.py`` without JAX. The
reference fixes its variables when it restores them (vgg16.py:62-100,
resnet_v1.py:154-178, mobilenet_v1.py:252-278); here the same surgery is one
functional conversion of a dict of slim variable names -> numpy arrays (an
``.npz`` or pickle export, or a real TF ``.ckpt`` bundle read by
``utils/tf_bundle.py``; TensorFlow is not needed):

* every first-layer conv kernel flipped RGB -> BGR (the input-channel axis
  reversed), because the data pipeline feeds BGR (PIXEL_MEANS order);
* VGG16 fc6 [7, 7, 512, 4096] and fc7 [1, 1, 4096, 4096] conv kernels
  reshaped to dense [25088, 4096] / [4096, 4096] (vgg16.py:95-98);
* MobileNet's first conv divided by 255 / 2 as well (mobilenet_v1.py:278):
  slim MobileNet was trained on [-1, 1] inputs, the port's are pixel-mean
  centred;
* slim BatchNorm {gamma, beta, moving_mean, moving_variance} ->
  FrozenBatchNorm {scale, bias, mean, var};
* TF depthwise kernels [k, k, C, 1] -> the grouped-conv layout [k, k, 1, C].

The detection heads (rpn_conv/3x3, rpn_cls_score, rpn_bbox_pred, cls_score,
bbox_pred) are mapped when present, so a trained reference checkpoint
converts whole; an ImageNet checkpoint lacks them and they keep their
values.

``convert_slim_weights`` writes into a flax-layout tree of numpy arrays, as
the JAX converter does (``tests/test_torch_weights_import.py`` holds the two
equal); ``load_pretrained_into`` takes that template from a torch model
(``utils/weights.py::flax_from_state_dict``) and loads the result back
through ``state_dict_from_flax``, in float32.
"""

from __future__ import annotations

import pickle
from typing import Dict

import numpy as np

from tf_faster_rcnn_torch.utils.tf_bundle import (is_tf_checkpoint,
                                                  read_tf_checkpoint)
from tf_faster_rcnn_torch.utils.weights import (flax_from_state_dict,
                                                state_dict_from_flax)

__all__ = ["convert_slim_weights", "load_pretrained_into", "load_var_dict"]

_SCOPES = {"vgg16": "vgg_16", "res50": "resnet_v1_50",
           "res101": "resnet_v1_101", "res152": "resnet_v1_152",
           "mobile": "MobilenetV1"}


def load_var_dict(path: str) -> Dict[str, np.ndarray]:
    """A slim var dict from an .npz or .pkl export, or from a TF ``.ckpt``
    TensorBundle prefix."""
    path = str(path)
    if is_tf_checkpoint(path):
        return read_tf_checkpoint(path)
    if path.endswith(".npz"):
        with np.load(path, allow_pickle=False) as f:
            return dict(f)
    with open(path, "rb") as f:
        return pickle.load(f)


def _bgr_flip(kernel):
    return kernel[:, :, ::-1, :]


def _set(tree, path, value, strict_shape=True):
    node = tree
    for k in path[:-1]:
        node = node[k]
    old = node[path[-1]]
    if strict_shape and tuple(old.shape) != tuple(value.shape):
        raise ValueError(
            f"shape mismatch at {'/'.join(path)}: "
            f"{old.shape} vs {value.shape}")
    node[path[-1]] = value.astype(np.float32)


def _bn(out, dst_prefix, var, src_prefix, missing):
    pairs = [("scale", "gamma"), ("bias", "beta"), ("mean", "moving_mean"),
             ("var", "moving_variance")]
    for ours, theirs in pairs:
        name = f"{src_prefix}/BatchNorm/{theirs}"
        if name in var:
            _set(out, dst_prefix + [ours], var[name])
        else:
            missing.append(name)


def _convert_resnet(out, var, scope, missing):
    """scope e.g. resnet_v1_101. The port's stem is the plain 7x7 one."""
    name = f"{scope}/conv1/weights"
    if name in var:
        _set(out, ["head", "conv1", "kernel"], _bgr_flip(var[name]))
    else:
        missing.append(name)
    _bn(out, ["head", "conv1_bn"], var, f"{scope}/conv1", missing)

    for bi in range(1, 5):
        where = "tail" if bi == 4 else "head"
        block = out[where][f"block{bi}"]
        for unit_name in block.keys():
            base = f"{scope}/block{bi}/{unit_name}/bottleneck_v1"
            unit = block[unit_name]
            for conv in ("conv1", "conv2", "conv3"):
                name = f"{base}/{conv}/weights"
                if name in var:
                    _set(out, [where, f"block{bi}", unit_name, conv, "conv",
                               "kernel"], var[name])
                else:
                    missing.append(name)
                _bn(out, [where, f"block{bi}", unit_name, conv, "bn"], var,
                    f"{base}/{conv}", missing)
            if "shortcut" in unit:
                name = f"{base}/shortcut/weights"
                if name in var:
                    _set(out, [where, f"block{bi}", unit_name, "shortcut",
                               "conv", "kernel"], var[name])
                else:
                    missing.append(name)
                _bn(out, [where, f"block{bi}", unit_name, "shortcut", "bn"],
                    var, f"{base}/shortcut", missing)


def _convert_vgg16(out, var, missing):
    scope = "vgg_16"
    for reps, conv in ((2, "conv1"), (2, "conv2"), (3, "conv3"),
                       (3, "conv4"), (3, "conv5")):
        for r in range(1, reps + 1):
            base = f"{scope}/{conv}/{conv}_{r}"
            for theirs, ours in (("weights", "kernel"), ("biases", "bias")):
                name = f"{base}/{theirs}"
                if name not in var:
                    missing.append(name)
                    continue
                v = var[name]
                if conv == "conv1" and r == 1 and ours == "kernel":
                    v = _bgr_flip(v)
                _set(out, ["head", f"{conv}_{r}", ours], v)
    # fc6/fc7: conv-shaped kernels reshape to dense
    for fc, in_dim in (("fc6", 7 * 7 * 512), ("fc7", 4096)):
        wname, bname = f"{scope}/{fc}/weights", f"{scope}/{fc}/biases"
        if wname in var:
            _set(out, ["tail", fc, "kernel"], var[wname].reshape(in_dim, 4096))
        else:
            missing.append(wname)
        if bname in var:
            _set(out, ["tail", fc, "bias"], var[bname])
        else:
            missing.append(bname)


def _convert_mobilenet(out, var, missing):
    scope = "MobilenetV1"
    for where, layers in (("head", range(0, 12)), ("tail", range(12, 14))):
        base_tree = out[where]["base"]
        for i in layers:
            key = f"conv2d_{i}"
            if key not in base_tree:
                continue
            if i == 0:
                name = f"{scope}/Conv2d_0/weights"
                if name in var:
                    v = _bgr_flip(var[name]) / (255.0 / 2.0)
                    _set(out, [where, "base", key, "kernel"], v)
                else:
                    missing.append(name)
                _bn(out, [where, "base", key + "_bn"], var,
                    f"{scope}/Conv2d_0", missing)
            else:
                dw = f"{scope}/Conv2d_{i}_depthwise/depthwise_weights"
                if dw in var:
                    # [k,k,C,1] -> [k,k,1,C]
                    _set(out, [where, "base", key, "depthwise", "kernel"],
                         np.transpose(var[dw], (0, 1, 3, 2)))
                else:
                    missing.append(dw)
                _bn(out, [where, "base", key, "depthwise_bn"], var,
                    f"{scope}/Conv2d_{i}_depthwise", missing)
                pw = f"{scope}/Conv2d_{i}_pointwise/weights"
                if pw in var:
                    _set(out, [where, "base", key, "pointwise", "kernel"],
                         var[pw])
                else:
                    missing.append(pw)
                _bn(out, [where, "base", key, "pointwise_bn"], var,
                    f"{scope}/Conv2d_{i}_pointwise", missing)


def _convert_heads(out, var, scope):
    """Detection heads from a trained reference checkpoint (optional)."""
    mapping = [
        (f"{scope}/rpn_conv/3x3", ["rpn_conv"]),
        (f"{scope}/rpn_cls_score", ["rpn_cls_score"]),
        (f"{scope}/rpn_bbox_pred", ["rpn_bbox_pred"]),
        (f"{scope}/cls_score", ["cls_score"]),
        (f"{scope}/bbox_pred", ["bbox_pred"]),
    ]
    for src, dst in mapping:
        for theirs, ours in (("weights", "kernel"), ("biases", "bias")):
            name = f"{src}/{theirs}"
            if name in var:
                v = var[name]
                target = out
                for k in dst:
                    target = target[k]
                if v.shape != tuple(np.shape(target[ours])):
                    v = v.reshape(np.shape(target[ours]))
                _set(out, dst + [ours], v)


def _copy_tree(tree):
    """A copy of a tree of dicts, its leaves copied as numpy arrays."""
    if isinstance(tree, dict):
        return {k: _copy_tree(v) for k, v in tree.items()}
    return np.array(tree)


def convert_slim_weights(params, var_dict: Dict[str, np.ndarray],
                         backbone: str):
    """A new flax-layout params tree with the slim weights written in.

    params: a variables dict ({'params': {...}}) or the inner tree, leaves
    anything numpy takes. A variable missing from var_dict keeps the value
    in params, with a printed note (an ImageNet checkpoint lacks the
    detection heads, which is normal)."""
    if backbone not in _SCOPES:
        raise ValueError(f"backbone {backbone!r}: one of {tuple(_SCOPES)}")
    wrapped = "params" in params and isinstance(params["params"], dict)
    tree = _copy_tree(params["params"] if wrapped else params)
    var = {k: np.asarray(v) for k, v in var_dict.items()}
    missing = []
    scope = _SCOPES[backbone]
    if backbone == "vgg16":
        _convert_vgg16(tree, var, missing)
    elif backbone in ("res50", "res101", "res152"):
        _convert_resnet(tree, var, scope, missing)
    else:
        _convert_mobilenet(tree, var, missing)
    _convert_heads(tree, var, scope)
    if missing:
        print(f"convert_slim_weights: {len(missing)} variables not found in "
              f"the checkpoint (heads are expected to be missing for "
              f"ImageNet weights); e.g. {missing[:3]}")
    return {"params": tree} if wrapped else tree


def load_pretrained_into(model, path: str, backbone: str):
    """Write the slim weights at path (``load_var_dict``) into model, a
    ``FasterRCNN`` of that backbone, in place; returns model."""
    tree = convert_slim_weights(flax_from_state_dict(model.state_dict()),
                                load_var_dict(path), backbone)
    model.load_state_dict(state_dict_from_flax(tree), strict=True)
    return model
