"""The port's training-target samplers and box encode against the JAX
package.

The JAX samplers draw their uniform noise inside, from a PRNG key; the
port's take it as an argument. Each test draws the JAX noise from the same
key splits as ``tf_faster_rcnn_tpu/models/targets.py`` (``split(key)`` into
the fg and the bg key, ``uniform(k, (n,))`` each) and passes it to the
port, so the two subsample the same candidates.

Tolerances: labels, sampled rois (gathered, not computed) and the valid
masks exactly equal; bbox targets and the inside and outside weights to
1e-6 relative to the largest magnitude (float32, the same operations in the
same order; XLA's and torch's log may differ by an ulp).
"""

import jax
import numpy as np
import pytest
import torch

from tf_faster_rcnn_tpu.models import targets as jtargets
from tf_faster_rcnn_tpu.ops import boxes as jboxes
from tf_faster_rcnn_tpu.ops.anchors import anchor_grid
from tf_faster_rcnn_torch.models import targets as ttargets
from tf_faster_rcnn_torch.ops import boxes as tboxes


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two intra-op threads: the suite runs several workers on the host's
    cores; these small tensors gain little from more threads, and more
    spin-waiting threads slow every worker."""
    before = torch.get_num_threads()
    torch.set_num_threads(min(before, 2))
    yield
    torch.set_num_threads(before)


def _t(x):
    return torch.from_numpy(np.array(x))


def _rel_close(got, want, tol=1e-6):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max()) / scale
    assert err <= tol, f"max error {err:.3g} relative to max > {tol}"


def _first(targets):
    """The first image's row of each field of a batched NamedTuple."""
    return type(targets)(*(x[0] for x in targets))


def _noise(key, n):
    """The (fg, bg) uniform noise a JAX sampler draws from key."""
    k_fg, k_bg = jax.random.split(key)
    return (np.asarray(jax.random.uniform(k_fg, (n,))),
            np.asarray(jax.random.uniform(k_bg, (n,))))


def test_bbox_transform_matches(rng):
    ex = rng.uniform(0, 400, (3, 50, 4)).astype(np.float32)
    ex[..., 2:] = ex[..., :2] + rng.uniform(0, 200, (3, 50, 2))
    gt = rng.uniform(0, 400, (3, 50, 4)).astype(np.float32)
    gt[..., 2:] = gt[..., :2] + rng.uniform(0, 200, (3, 50, 2))
    want = np.asarray(jboxes.bbox_transform(ex, gt))
    got = tboxes.bbox_transform(_t(ex), _t(gt)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


# --- anchor_target ---------------------------------------------------------

def _scene_gt(rng, g, n_valid, h, w, min_side=20):
    gt = np.zeros((g, 5), np.float32)
    for i in range(n_valid):
        x1, y1 = rng.uniform(0, w - min_side), rng.uniform(0, h - min_side)
        x2 = min(w - 1, x1 + rng.uniform(min_side, w / 2))
        y2 = min(h - 1, y1 + rng.uniform(min_side, h / 2))
        gt[i] = [x1, y1, x2, y2, rng.randint(1, 21)]
    valid = np.zeros(g, bool)
    valid[:n_valid] = True
    return gt, valid


ANCHOR_CASES = {
    # name: (grid h, w, scales, im_hw, kwargs)
    "no subsampling": ((8, 8), (2, 4), (120.0, 124.0),
                       dict(rpn_batchsize=100000)),
    "subsampled": ((16, 16), (1, 2, 4), (256.0, 250.0),
                   dict(rpn_batchsize=64, rpn_fg_fraction=0.5)),
    "fg capped": ((16, 16), (1, 2, 4), (256.0, 256.0),
                  dict(rpn_batchsize=16, rpn_fg_fraction=0.25,
                       positive_overlap=0.3)),
    "clobber positives": ((8, 8), (2, 4), (128.0, 128.0),
                          dict(rpn_batchsize=64, clobber_positives=True,
                               negative_overlap=0.6)),
    "positive weight": ((8, 8), (2, 4), (128.0, 100.0),
                        dict(rpn_batchsize=48, positive_weight=0.3,
                             inside_weight=(1.0, 0.5, 2.0, 1.0))),
}


def _anchor_case(rng, name, n_valid=3):
    (gh, gw), scales, im_hw, kw = ANCHOR_CASES[name]
    anchors = anchor_grid(gh, gw, 16, anchor_scales=scales,
                          anchor_ratios=(0.5, 1, 2))
    gt, gv = _scene_gt(rng, 5, n_valid, *im_hw)
    return anchors, gt, gv, im_hw, kw


def _compare_anchor_targets(got, want):
    np.testing.assert_array_equal(got.labels.numpy(),
                                  np.asarray(want.labels))
    for field in ("bbox_targets", "bbox_inside_weights",
                  "bbox_outside_weights"):
        _rel_close(getattr(got, field).numpy(),
                   np.asarray(getattr(want, field)))


@pytest.mark.parametrize("name", sorted(ANCHOR_CASES) + ["all gt invalid"])
def test_anchor_target_matches_per_image(rng, name):
    """One image: the JAX function on its key, the port on that key's
    noise."""
    if name == "all gt invalid":
        anchors, gt, gv, im_hw, kw = _anchor_case(rng, "subsampled", 0)
    else:
        anchors, gt, gv, im_hw, kw = _anchor_case(rng, name)
    key = jax.random.PRNGKey(7)
    want = jtargets.anchor_target(anchors, gt, gv, im_hw, key, **kw)
    fg, bg = _noise(key, len(anchors))
    got = ttargets.anchor_target(
        _t(anchors), _t(gt[None]), _t(gv[None]), _t(np.float32([im_hw])),
        _t(fg[None]), _t(bg[None]), **kw)
    _compare_anchor_targets(_first(got), want)
    labels = got.labels[0].numpy()
    if name == "all gt invalid":
        assert (labels != 1).all() and (labels == 0).sum() > 0
    elif name != "no subsampling":
        assert (labels >= 0).sum() == kw["rpn_batchsize"]
        assert (labels == 1).sum() <= kw["rpn_batchsize"] * kw.get(
            "rpn_fg_fraction", 0.5)


def test_anchor_target_matches_batched_at_the_train_canvas(rng):
    """B = 3 images of different extents and gt counts on the 608x1024
    canvas's 21888 anchors, at the res101 VOC config (256 anchors, half
    fg), as FasterRCNN calls it: one key per image, as vmap splits them."""
    anchors = anchor_grid(38, 64, 16)
    im_hw = np.float32([[600, 1000], [608, 1024], [480, 640]])
    gts, gvs = zip(*[_scene_gt(rng, 100, n, h, w)
                     for n, (h, w) in zip((6, 1, 40), im_hw)])
    gt, gv = np.stack(gts), np.stack(gvs)
    keys = jax.random.split(jax.random.PRNGKey(11), 3)
    want = jax.vmap(lambda g, v, hw, k: jtargets.anchor_target(
        anchors, g, v, (hw[0], hw[1]), k))(gt, gv, im_hw, keys)
    fg, bg = zip(*[_noise(k, len(anchors)) for k in keys])
    got = ttargets.anchor_target(_t(anchors), _t(gt), _t(gv), _t(im_hw),
                                 _t(np.stack(fg)), _t(np.stack(bg)))
    _compare_anchor_targets(got, want)
    assert ((got.labels >= 0).sum(dim=1) == 256).all()


# --- proposal_target -------------------------------------------------------

def _mix_inputs():
    """tests/test_targets.py's mix: 3 rois on gt, 5 partial overlaps, 2
    invalid."""
    gt = np.array([[10, 10, 50, 50, 3], [60, 60, 100, 100, 7]], np.float32)
    rois = np.array([
        [10, 10, 50, 50], [60, 60, 100, 100], [12, 12, 52, 52],
        [10, 40, 50, 80], [55, 20, 95, 55], [30, 60, 70, 95],
        [0, 60, 45, 105], [60, 0, 100, 42],
        [0, 0, 0, 0], [0, 0, 0, 0]], np.float32)
    rv = np.array([True] * 8 + [False, False])
    return rois, rv, gt, np.array([True, True])


def _proposal_case(name):
    """(rois, roi_valid, gt, gt_valid, num_classes, kwargs)."""
    if name == "mix":
        return _mix_inputs() + (21, dict(batch_size=8, bg_thresh_lo=0.0))
    if name == "cycling":            # fewer candidates than slots
        return _mix_inputs() + (21, dict(batch_size=32, fg_fraction=0.5,
                                         bg_thresh_lo=0.0))
    if name == "use_gt":
        return _mix_inputs() + (21, dict(batch_size=16, use_gt=True))
    if name == "normalization":
        gt = np.array([[10, 10, 50, 50, 1]], np.float32)
        rois = np.array([[12, 8, 48, 54]], np.float32)
        return rois, np.array([True]), gt, np.array([True]), 2, dict(
            batch_size=1, fg_fraction=1.0)
    if name == "unnormalized":
        return _mix_inputs() + (21, dict(
            batch_size=8, normalize=False, inside_weight=(1, 2, 3, 4)))
    if name == "bg only":
        gt = np.array([[10, 10, 30, 30, 5]], np.float32)
        rois = np.tile(np.array([[100, 100, 140, 140]], np.float32), (6, 1))
        return rois, np.ones(6, bool), gt, np.array([True]), 21, dict(
            batch_size=4, bg_thresh_lo=0.0)
    if name == "fg only":
        gt = np.array([[10, 10, 50, 50, 5]], np.float32)
        rois = np.tile(np.array([[11, 11, 51, 51]], np.float32), (3, 1))
        return rois, np.ones(3, bool), gt, np.array([True]), 21, dict(
            batch_size=4, bg_thresh_lo=0.1)
    if name == "all gt invalid":
        rois, rv, gt, _ = _mix_inputs()
        return rois, rv, gt, np.array([False, False]), 21, dict(batch_size=8)
    raise KeyError(name)


PROPOSAL_CASES = ["mix", "cycling", "use_gt", "normalization",
                  "unnormalized", "bg only", "fg only", "all gt invalid"]


def _compare_proposal_targets(got, want):
    for field in ("labels", "valid", "rois"):
        np.testing.assert_array_equal(getattr(got, field).numpy(),
                                      np.asarray(getattr(want, field)),
                                      err_msg=field)
    for field in ("bbox_targets", "bbox_inside_weights",
                  "bbox_outside_weights"):
        want_f = np.asarray(getattr(want, field))
        if np.abs(want_f).max() == 0:
            np.testing.assert_array_equal(getattr(got, field).numpy(),
                                          want_f, err_msg=field)
        else:
            _rel_close(getattr(got, field).numpy(), want_f)


@pytest.mark.parametrize("name", PROPOSAL_CASES)
def test_proposal_target_matches_per_image(name):
    rois, rv, gt, gv, k, kw = _proposal_case(name)
    key = jax.random.PRNGKey(5)
    want = jtargets.proposal_target(rois, rv, gt, gv, key, k, **kw)
    fg, bg = _noise(key, len(rois) + (len(gt) if kw.get("use_gt") else 0))
    got = ttargets.proposal_target(
        _t(rois[None]), _t(rv[None]), _t(gt[None]), _t(gv[None]),
        _t(fg[None]), _t(bg[None]), k, **kw)
    _compare_proposal_targets(_first(got), want)
    labels, valid = got.labels[0].numpy(), got.valid[0].numpy()
    if name == "bg only":
        assert valid.all() and (labels == 0).all()
    elif name == "fg only":
        assert valid.all() and (labels == 5).all()
    elif name == "all gt invalid":
        assert not valid.any() and (labels == 0).all()


def test_proposal_target_matches_batched_at_the_train_config(rng):
    """B = 3 images, 2000 proposals each, 256 slots, BG_THRESH_LO 0.0 (the
    res101 VOC config), one image with no valid proposal."""
    b, r = 3, 2000
    gts, gvs = zip(*[_scene_gt(rng, 100, n, 600, 1000) for n in (5, 1, 30)])
    gt, gv = np.stack(gts), np.stack(gvs)
    rois = np.zeros((b, r, 4), np.float32)
    for i in range(b):
        # half jittered around the gt boxes, half anywhere
        src = gt[i, rng.randint(0, max(1, gv[i].sum()), r // 2), :4]
        jit = src + rng.randn(r // 2, 4).astype(np.float32) * 15
        anywhere = rng.uniform(0, 900, (r - r // 2, 4)).astype(np.float32)
        anywhere[:, 2:] = anywhere[:, :2] + rng.uniform(5, 300, (r - r // 2, 2))
        rois[i] = np.concatenate([jit, anywhere])
    rois[..., 2:] = np.maximum(rois[..., 2:], rois[..., :2])
    rv = rng.rand(b, r) > 0.1
    rv[2] = False
    kw = dict(batch_size=256, bg_thresh_lo=0.0)
    keys = jax.random.split(jax.random.PRNGKey(3), b)
    want = jax.vmap(lambda ro, v, g, gvv, k: jtargets.proposal_target(
        ro, v, g, gvv, k, 21, **kw))(rois, rv, gt, gv, keys)
    fg, bg = zip(*[_noise(k, r) for k in keys])
    got = ttargets.proposal_target(_t(rois), _t(rv), _t(gt), _t(gv),
                                   _t(np.stack(fg)), _t(np.stack(bg)), 21,
                                   **kw)
    _compare_proposal_targets(got, want)
    assert (got.labels[:2] > 0).sum() > 0 and not got.valid[2].any()
