"""Portable serving artifacts for the detect program (torch.export).

The counterpart of ``tf_faster_rcnn_tpu/utils/serving.py``. The whole
batched detect program of ``engine/test_engine.py::make_detect_fn``
(backbone, proposals with kernel K1, postprocess with kernel K2) is
exported with ``torch.export``, one artifact per TEST canvas bucket, beside
the model's parameters. A serving process loads the directory and calls the
programs with torch and the port's operator registrations
(``ops/nms_kernels.py``, ``ops/epilogue.py``) alone: no model code, no
engine, no config.

The parameters and buffers travel as an INPUT of each program, a dict in
state_dict order, never as constants baked into it: they are written once,
to ``params.pt``, and bound at load. That is the JAX bundle's design, for the
same reason: a constant-folding compiler would fold literal weights with
another association than the live program uses. The exported graph holds
K1 and K2 as one node each (``frcnn::nms_keep_mask`` and
``frcnn::batched_nms_keep``), which dispatch, as the live path does, to the
CUDA kernels for tensors on the card and to the plain versions on the CPU.

A program is exported on the device it serves on, and runs only there: the
device of the traced constants (the box-normalization stds, the 'top'
mode's pad indices) is part of the graph. ``load_detect`` raises for a
``cuda`` bundle where torch finds no CUDA device; it does not fall back to
the CPU.

Layout of an export directory:

    manifest.json        net, class count, batch, io contract, device
    params.pt            utils/checkpoint.py::save_params of the model
    detect_<H>x<W>.pt2   torch.export.save of the program, per bucket

Inputs per artifact (shapes fixed at export): image [B, H, W, 3] float32
(the mean-subtracted canvases of data/blob.py::prep_batch); im_info [B, 3]
(h_scaled, w_scaled, scale); orig_hw [B, 2]. Outputs: detections
[B, max_per_image, 6] as (cls, score, x1, y1, x2, y2) in original-image
coordinates, and valid [B, max_per_image], as make_detect_fn returns them.

TEST.MODE 'top' draws pad indices when an image has fewer anchors than
TEST.RPN_TOP_N (network.py::draw_top_pad); they depend on the shapes alone,
so ``export_detect`` draws them once per canvas, as the live path does, and
the program takes them as a constant.
"""

from __future__ import annotations

import functools
import json
import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from tf_faster_rcnn_torch.ops import epilogue, nms_kernels  # noqa: F401

__all__ = ["MANIFEST", "PARAMS", "export_detect", "load_detect"]

MANIFEST = "manifest.json"
PARAMS = "params.pt"
_FORMAT = "tf_faster_rcnn_torch.detect/1"
# the port's image batches are float32 canvases whatever the compute dtype
# (data/blob.py::prep_batch); the model casts them at its first op
_TRANSFER_DTYPE = "float32"


class _DetectProgram(torch.nn.Module):
    """make_detect_fn's step with the model's state dict as its first
    input. The model is held outside the module tree, so export lifts none
    of its tensors as parameters: they enter through ``params``."""

    def __init__(self, model, spec, max_per_image, score_thresh,
                 top_pad=None):
        super().__init__()
        self._model = [model]
        self._spec = spec
        self._mpi = max_per_image
        self._score_thresh = score_thresh
        self._top_pad = top_pad

    def forward(self, params, image, im_info, orig_hw):
        from tf_faster_rcnn_torch.engine.test_engine import detect_step

        def model(image, im_info, top_pad=None):
            return torch.func.functional_call(
                self._model[0], params, (image, im_info),
                {"top_pad": top_pad})
        return detect_step(model, self._spec, self._mpi, self._score_thresh,
                           image, im_info, orig_hw, top_pad=self._top_pad)


def _top_pad(spec, batch, canvas, device):
    """The 'top' mode's pad indices of a canvas, or None where the image
    has at least TEST.RPN_TOP_N anchors (or the mode is 'nms')."""
    from tf_faster_rcnn_torch.models.network import draw_top_pad
    n = (canvas[0] // spec.feat_stride) * (canvas[1] // spec.feat_stride) \
        * spec.num_anchors
    if spec.test_mode != "top" or n >= spec.rpn_top_n:
        return None
    return draw_top_pad(batch, n, spec.rpn_top_n, device)


def export_detect(model, spec, out_dir: str, batch: int, *,
                  max_per_image: Optional[int] = None,
                  score_thresh: float = 0.0) -> dict:
    """Export the detect program of model (in TEST mode, on its device) for
    every TEST canvas bucket into out_dir; returns the manifest dict.
    Buckets, scales, max size and pixel means come from the port's cfg; the
    postprocess settings from spec, as make_detect_fn takes them."""
    from tf_faster_rcnn_torch.config import canvas_buckets, cfg
    from tf_faster_rcnn_torch.data.blob import batch_image_shape
    from tf_faster_rcnn_torch.utils.checkpoint import save_params

    if spec.mode != "TEST":
        raise ValueError(f"export_detect needs a TEST-mode model, got "
                         f"{spec.mode!r}")
    device = next(model.parameters()).device
    mpi = int(max_per_image or spec.max_per_image)
    params = dict(model.state_dict())
    os.makedirs(out_dir, exist_ok=True)
    save_params(os.path.join(out_dir, PARAMS), params)

    entries = []
    for canvas in canvas_buckets(cfg.TEST):
        image_shape = batch_image_shape(batch, canvas)
        program = _DetectProgram(model, spec, mpi, float(score_thresh),
                                 _top_pad(spec, batch, canvas, device))
        args = (params,
                torch.zeros(image_shape, dtype=torch.float32, device=device),
                torch.ones((batch, 3), dtype=torch.float32, device=device),
                torch.ones((batch, 2), dtype=torch.float32, device=device))
        with torch.no_grad():
            exported = torch.export.export(program, args)
        # the example inputs hold the parameters: params.pt has them once
        exported.example_inputs = None
        name = f"detect_{canvas[0]}x{canvas[1]}.pt2"
        torch.export.save(exported, os.path.join(out_dir, name))
        entries.append({
            "canvas": [int(canvas[0]), int(canvas[1])],
            "file": name,
            "image_shape": list(image_shape),
            "space_to_depth": False,
        })

    manifest = {
        "format": _FORMAT,
        "net": spec.backbone,
        "device": device.type,
        # which implementation the programs' K1 and K2 nodes dispatch to:
        # the CUDA kernels on the card, their plain versions on the CPU
        "nms_kernels": device.type == "cuda",
        "num_classes": int(spec.num_classes),
        "batch": int(batch),
        "max_per_image": mpi,
        "nms_thresh": float(spec.nms_thresh),
        "transfer_dtype": _TRANSFER_DTYPE,
        "scales": [int(s) for s in cfg.TEST.SCALES],
        "max_size": int(cfg.TEST.MAX_SIZE),
        "pixel_means": np.asarray(cfg.PIXEL_MEANS).reshape(3).tolist(),
        "artifacts": entries,
    }
    with open(os.path.join(out_dir, MANIFEST), "w") as f:
        json.dump(manifest, f, indent=2)
    return manifest


def load_detect(out_dir: str) -> Tuple[dict, Dict[tuple, object]]:
    """Load an export directory -> (manifest, {(H, W): callable}).

    Each callable takes (image, im_info, orig_hw), tensors on the bundle's
    device, and returns (detections, valid); the shipped parameters are
    bound at load, on that device."""
    path = os.path.join(out_dir, MANIFEST)
    manifest = None
    if os.path.isfile(path):
        with open(path) as f:
            manifest = json.load(f)
    if not isinstance(manifest, dict) or manifest.get("format") != _FORMAT:
        raise ValueError(f"not a detect export dir: {out_dir!r}")
    device = torch.device(manifest["device"])
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{out_dir!r} holds a cuda detect bundle and torch "
                           "finds no CUDA device; export it again on the "
                           "device that serves it")
    params = torch.load(os.path.join(out_dir, PARAMS), map_location=device,
                        weights_only=True)
    fns = {}
    for entry in manifest["artifacts"]:
        program = torch.export.load(
            os.path.join(out_dir, entry["file"])).module()
        fns[tuple(entry["canvas"])] = functools.partial(_call, program,
                                                        params)
    return manifest, fns


def _call(program, params, image, im_info, orig_hw):
    with torch.inference_mode():
        return program(params, image, im_info, orig_hw)
