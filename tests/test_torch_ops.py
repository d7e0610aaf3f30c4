"""The port's anchors, box math and RoI crop against the JAX package.

Tolerances: the anchors copy and BBOX_XFORM_CLIP are exactly equal; the box
functions agree at rtol 1e-6, and the decode also at an atol of 1e-6 times
its largest output (torch's and XLA's float32 exp differ by an ulp at some
inputs, and x1 = cx - w/2 cancels); the crop agrees with method='einsum'
at 1e-5 relative to the largest magnitude (a bilinear blend of four samples
against a one-hot matmul pair).
Also: the port's detect path imports neither jax, flax, cv2 nor the JAX
package.
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tf_faster_rcnn_tpu.ops import anchors as janchors
from tf_faster_rcnn_tpu.ops import boxes as jboxes
from tf_faster_rcnn_tpu.ops import roi_align as jroi
from tf_faster_rcnn_torch.ops import anchors as tanchors
from tf_faster_rcnn_torch.ops import boxes as tboxes
from tf_faster_rcnn_torch.ops import roi_align as troi

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _rel_close(got, want, tol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max()) / scale
    assert err <= tol, f"max error {err:.3g} relative to max > {tol}"


@pytest.mark.parametrize("h,w,stride,scales,ratios", [
    (38, 64, 16, (8, 16, 32), (0.5, 1, 2)),
    (8, 8, 16, (2, 4), (0.5, 1, 2)),
    (5, 7, 8, (1, 3), (0.25, 1, 4)),
])
def test_anchors_copy_equals_original(h, w, stride, scales, ratios):
    np.testing.assert_array_equal(
        tanchors.generate_anchors(ratios=ratios, scales=scales),
        janchors.generate_anchors(ratios=ratios, scales=scales))
    got = tanchors.anchor_grid(h, w, stride, scales, ratios)
    want = janchors.anchor_grid(h, w, stride, scales, ratios)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("h,w,stride,scales,ratios", [
    (38, 64, 16, (8, 16, 32), (0.5, 1, 2)),
    (64, 38, 16, (8, 16, 32), (0.5, 1, 2)),
    (8, 8, 16, (2, 4), (0.5, 1, 2)),
    (5, 7, 8, (1, 3), (0.25, 1, 4)),
])
def test_anchor_grid_on_device_equals_original(h, w, stride, scales, ratios):
    """The grid the model builds in each forward (torch ops, no host copy)
    is the JAX package's, bit for bit."""
    got = tanchors.anchor_grid_on(h, w, "cpu", stride, scales, ratios)
    want = janchors.anchor_grid(h, w, stride, scales, ratios)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  want.view(np.uint32))


def test_model_keeps_no_tensor_outside_its_state_dict():
    """The forward builds the anchors from the feature shape: the module
    holds no tensor cache that torch.export would see assigned while
    tracing, and its state_dict keys are its parameters and buffers."""
    from tf_faster_rcnn_torch.models import network as tnet
    spec = tnet.ModelSpec("mobile", 21, anchor_scales=(2, 4),
                          depth_multiplier=0.25)
    model = tnet.FasterRCNN(spec, device="cpu").eval()
    keys = list(model.state_dict())
    with torch.no_grad():
        model(torch.zeros(1, 64, 96, 3), torch.tensor([[64.0, 96.0, 1.0]]))
    assert list(model.state_dict()) == keys
    named = [k for k, _ in model.named_parameters()] + \
        [k for k, _ in model.named_buffers()]
    assert sorted(named) == sorted(keys)
    tensors = [k for m in model.modules() for k, v in vars(m).items()
               if k not in ("_parameters", "_buffers") and (
                   torch.is_tensor(v) or (isinstance(v, dict) and any(
                       torch.is_tensor(x) for x in v.values())))]
    assert tensors == []


def test_bbox_xform_clip_is_bit_identical():
    assert tboxes.BBOX_XFORM_CLIP == jboxes.BBOX_XFORM_CLIP


@pytest.mark.parametrize("k,clip", [(1, None), (1, "clip"), (5, "clip")])
def test_bbox_transform_inv_matches(rng, k, clip):
    n = 200
    boxes = rng.uniform(0, 400, (2, n, 4)).astype(np.float32)
    boxes[..., 2:] = boxes[..., :2] + rng.uniform(1, 200, (2, n, 2))
    deltas = (rng.randn(2, n, 4 * k) * 2).astype(np.float32)
    deltas[0, :10, 2::4] = 9.0                       # past the clamp
    xc = jboxes.BBOX_XFORM_CLIP if clip else None
    for anchors in (boxes, boxes[0]):  # per image, or shared as in the RPN
        want = np.asarray(jboxes.bbox_transform_inv(anchors, deltas,
                                                    xform_clip=xc))
        got = tboxes.bbox_transform_inv(_t(anchors), _t(deltas),
                                        xform_clip=xc)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6,
                                   atol=1e-6 * np.abs(want).max())


def test_clip_boxes_matches(rng):
    boxes = rng.uniform(-100, 700, (3, 40, 8)).astype(np.float32)
    hw = np.array([[300, 500], [480, 640], [100, 90]], np.float32)
    np.testing.assert_allclose(
        tboxes.clip_boxes(_t(boxes), _t(hw)).numpy(),
        np.asarray(jboxes.clip_boxes(boxes, hw)), rtol=1e-6)
    np.testing.assert_allclose(
        tboxes.clip_boxes(_t(boxes[0]), (300.0, 500.0)).numpy(),
        np.asarray(jboxes.clip_boxes(boxes[0], (300.0, 500.0))), rtol=1e-6)


@pytest.mark.parametrize("plus_one", [True, False])
def test_bbox_overlaps_matches(rng, plus_one):
    a = rng.uniform(0, 100, (2, 30, 4)).astype(np.float32)
    a[..., 2:] = a[..., :2] + rng.uniform(0, 50, (2, 30, 2))
    q = rng.uniform(0, 100, (2, 20, 4)).astype(np.float32)
    q[..., 2:] = q[..., :2] + rng.uniform(0, 50, (2, 20, 2))
    a[0, 0] = [5, 5, 5, 5]                           # zero-area box
    want = jboxes.bbox_overlaps(a, q, plus_one=plus_one)
    got = tboxes.bbox_overlaps(_t(a), _t(q), plus_one=plus_one)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=0)


def _crop_boxes(rng, r):
    """Normalized (y1, x1, y2, x2) boxes, some past the image, some with an
    edge exactly on the S-1 border (normalized coordinate 1.0)."""
    b = rng.uniform(-0.2, 1.2, (r, 4)).astype(np.float32)
    b[:, 2:] = b[:, :2] + rng.uniform(0.05, 0.8, (r, 2))
    b[0] = [0.0, 0.0, 1.0, 1.0]
    b[1] = [0.5, 0.25, 1.0, 1.0]
    b[2] = [1.0, 1.0, 1.0, 1.0]
    b[3] = [0.2, 0.3, 0.2, 0.9]                      # zero-height box
    return b


@pytest.mark.parametrize("crop", [(7, 7), (14, 14), (1, 3)])
@pytest.mark.parametrize("valid_hw", [None, (9.0, 11.0)])
def test_crop_and_resize_matches_einsum(rng, crop, valid_hw):
    image = rng.randn(13, 17, 6).astype(np.float32)
    boxes = _crop_boxes(rng, 24)
    want = jroi.crop_and_resize(
        image, boxes, crop, method="einsum",
        valid_hw=None if valid_hw is None else jnp.asarray(valid_hw))
    got = troi.crop_and_resize(_t(image), _t(boxes), crop, valid_hw=valid_hw)
    _rel_close(got.numpy(), want, 1e-5)


@pytest.mark.parametrize("max_pool", [False, True])
def test_roi_crop_pool_matches(rng, max_pool):
    feats = rng.randn(2, 8, 12, 5).astype(np.float32)
    rois = rng.uniform(0, 180, (2, 10, 4)).astype(np.float32)
    rois[..., 2:] = rois[..., :2] + rng.uniform(4, 90, (2, 10, 2))
    rois[0, 0] = [0, 0, 11 * 16, 7 * 16]             # the whole map
    valid = np.array([[6.0, 12.0], [8.0, 9.0]], np.float32)
    want = jroi.roi_crop_pool(feats, rois, 16, 7, max_pool, valid_hw=valid)
    got = troi.roi_crop_pool(_t(feats), _t(rois), 16, 7, max_pool,
                             valid_hw=_t(valid))
    _rel_close(got.numpy(), want, 1e-5)


def test_port_imports_no_jax_flax_or_cv2():
    """Importing the port, snapshotting its cfg in both modes and running a
    CPU detect step of res50, of vgg16 in bf16 with TEST.MODE 'top' and of
    mobile in bf16 leaves jax, flax, cv2 and the JAX package out of
    sys.modules."""
    code = r"""
import sys
import torch
import tf_faster_rcnn_torch
from tf_faster_rcnn_torch.engine import losses, train
from tf_faster_rcnn_torch.engine.test_engine import make_detect_fn
from tf_faster_rcnn_torch.models import targets
from tf_faster_rcnn_torch.models.init import init_model
from tf_faster_rcnn_torch.models import mobilenet_v1, vgg16
from tf_faster_rcnn_torch.models.network import (FasterRCNN, ModelSpec,
                                                 spec_from_cfg)
from tf_faster_rcnn_torch.utils import build, weights
assert spec_from_cfg("res101", 21, "TEST") == ModelSpec("res101", 21)
assert spec_from_cfg("res101", 21, "TRAIN").mode == "TRAIN"
for backbone, dtype, mode in (("res50", "float32", "nms"),
                              ("vgg16", "bfloat16", "top"),
                              ("mobile", "bfloat16", "nms")):
    spec = ModelSpec(backbone, 4, anchor_scales=(2,), anchor_ratios=(1.0,),
                     rpn_pre_nms_top_n=32, rpn_post_nms_top_n=8,
                     max_per_image=5, pooling_size=2, compute_dtype=dtype,
                     test_mode=mode, rpn_top_n=8, depth_multiplier=0.25)
    model = FasterRCNN(spec, device="cpu").eval()
    init_model(model, torch.Generator().manual_seed(0))
    det, dv = make_detect_fn(model, spec)(
        torch.zeros(1, 32, 32, 3), torch.tensor([[32.0, 32.0, 1.0]]),
        torch.tensor([[32.0, 32.0]]))
    assert det.shape == (1, 5, 6)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "cv2",
                                    "tf_faster_rcnn_tpu"))
print("LOADED", bad)
"""
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "LOADED []" in out.stdout, out.stdout
