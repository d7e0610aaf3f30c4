"""The port's NMS API beyond the main path, and the NMS route of its detect
and train paths, against the JAX package.

* ``ops/nms.py::class_aware_nms``, ``engine/detect.py::multiclass_nms`` and
  ``utils/native.py::py_cpu_nms`` equal the JAX functions on the inputs of
  tests/test_nms.py (the py_cpu_nms oracle test's 200 clustered boxes, the
  class-aware test's 4 x 80) and on a hypothesis fuzz like its property
  fuzz (40 examples of adversarial integer boxes, padded to one shape with
  invalid boxes so that each JAX function compiles once).
* The route: a tiny detect step on the CPU enters each of
  ``torch.ops.frcnn.*`` once and a tiny TRAIN forward enters K1's once
  (each operator wrapped to count), with outputs equal to the unwrapped
  run's. A YAML with ``TPU.USE_PALLAS_NMS`` False is refused before a model
  is built, by spec_from_cfg and by the profiler's flags alike.
* ``models/network.py::extract_head`` equals the JAX one on a tiny
  backbone with the weights bridged, with and without ``valid_hw``.

Tolerance: masks, indices and detections exactly equal; extract_head's
float32 features within 1e-4 of their largest magnitude.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tf_faster_rcnn_tpu.engine import detect as jdetect
from tf_faster_rcnn_tpu.models import network as jnet
from tf_faster_rcnn_tpu.ops import nms as jnms
from tf_faster_rcnn_tpu.utils import native as jnative
from tf_faster_rcnn_torch import config as tcfg
from tf_faster_rcnn_torch.engine import detect as tdetect
from tf_faster_rcnn_torch.engine.losses import detection_losses
from tf_faster_rcnn_torch.engine.test_engine import make_detect_fn
from tf_faster_rcnn_torch.models import network as tnet
from tf_faster_rcnn_torch.models.init import init_model, numpy_params
from tf_faster_rcnn_torch.ops import nms as tnms
from tf_faster_rcnn_torch.utils import native as tnative
from tf_faster_rcnn_torch.tools import train_profile
from tf_faster_rcnn_torch.utils.weights import state_dict_from_flax

FUZZ_N = 48          # the fuzz's largest box count: every example is padded
FUZZ_OUT = 16        # class_aware_nms slots in the fuzz (a max_keep prefix)
SMALL = dict(anchor_scales=(2, 4), rpn_pre_nms_top_n=256,
             rpn_post_nms_top_n=16, depth_multiplier=0.25)
CANVAS = (96, 128)


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(min(before, 2))
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def _reset_port_cfg():
    tcfg.reset_cfg()
    yield
    tcfg.reset_cfg()


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _rand_dets(rng, n, hw=(400, 600)):
    """tests/test_nms.py's clustered generator: [n, 5] (x1, y1, x2, y2,
    score)."""
    h, w = hw
    centers = rng.uniform(50, min(h, w) - 50, size=(max(n // 8, 1), 2))
    c = centers[rng.randint(0, len(centers), n)] + rng.randn(n, 2) * 12
    wh = rng.uniform(10, 80, size=(n, 2))
    x1 = np.clip(c[:, 0] - wh[:, 0] / 2, 0, w - 2)
    y1 = np.clip(c[:, 1] - wh[:, 1] / 2, 0, h - 2)
    x2 = np.clip(x1 + wh[:, 0], x1 + 1, w - 1)
    y2 = np.clip(y1 + wh[:, 1], y1 + 1, h - 1)
    scores = rng.uniform(0.01, 1.0, n)
    return np.stack([x1, y1, x2, y2, scores], axis=1).astype(np.float32)


def _numpy(fn, *args, **kw):
    """fn's output (a tensor or a tuple of them) as a tuple of arrays."""
    out = fn(*args, **kw)
    return tuple(x.numpy() for x in (out if isinstance(out, tuple) else
                                     (out,)))


def _assert_class_aware(boxes, scores, valid, thresh, max_out):
    want_idx, want_valid = jnms.class_aware_nms(boxes, scores, valid, thresh,
                                                max_out)
    idx, ok = _numpy(tnms.class_aware_nms, _t(boxes), _t(scores),
                           _t(valid), thresh, max_out)
    np.testing.assert_array_equal(ok, np.asarray(want_valid))
    np.testing.assert_array_equal(idx, np.asarray(want_idx))


def _assert_multiclass(boxes, scores, valid, thresh, score_thresh):
    want = jdetect.multiclass_nms(boxes, scores, valid, thresh,
                                  score_thresh=score_thresh)
    (keep,) = _numpy(tdetect.multiclass_nms, _t(boxes), _t(scores),
                           _t(valid), thresh, score_thresh=score_thresh)
    np.testing.assert_array_equal(keep, np.asarray(want))
    return keep


def test_py_cpu_nms_matches(rng):
    """tests/test_nms.py:54's input: 200 clustered boxes at 0.3."""
    dets = _rand_dets(rng, 200)
    got = tnative.py_cpu_nms(dets, 0.3)
    assert got == jnative.py_cpu_nms(dets, 0.3)
    assert len(got) < 200


def test_class_aware_nms_matches(rng):
    """tests/test_nms.py:127-132's input: 4 classes of 80 boxes -> 16."""
    c, n = 4, 80
    boxes = np.stack([_rand_dets(rng, n)[:, :4] for _ in range(c)])
    scores = rng.rand(c, n).astype(np.float32)
    valid = np.ones((c, n), bool)
    _assert_class_aware(boxes, scores, valid, 0.3, 16)
    valid[:, ::5] = False
    _assert_class_aware(boxes, scores, valid, 0.3, 16)


def test_class_aware_nms_is_one_kernel_call(rng, monkeypatch):
    """Every class goes through one K1 call, at the class-stacked shape."""
    calls = []
    real = tnms.nms_keep_mask_batched

    def record(boxes, *args, **kw):
        calls.append((tuple(boxes.shape), kw["max_keep"]))
        return real(boxes, *args, **kw)

    monkeypatch.setattr(tnms, "nms_keep_mask_batched", record)
    boxes = np.stack([_rand_dets(rng, 80)[:, :4] for _ in range(4)])
    tnms.class_aware_nms(_t(boxes), _t(rng.rand(4, 80).astype(np.float32)),
                         torch.ones(4, 80, dtype=torch.bool), 0.3, 16)
    tdetect.multiclass_nms(_t(boxes), _t(rng.rand(4, 80).astype(np.float32)),
                           torch.ones(4, 80, dtype=torch.bool), 0.3)
    assert calls == [((4, 80, 4), 16), ((4, 80, 4), 80)]


def test_multiclass_nms_matches(rng):
    """The same 4 x 80 boxes, a random valid mask and a score threshold
    above 0; the keep mask is in the boxes' original order."""
    c, n = 4, 80
    boxes = np.stack([_rand_dets(rng, n)[:, :4] for _ in range(c)])
    scores = rng.rand(c, n).astype(np.float32)
    valid = rng.rand(c, n) > 0.2
    keep = _assert_multiclass(boxes, scores, valid, 0.3, 0.25)
    assert not keep[~valid].any() and not keep[scores <= 0.25].any()
    for k in range(c):
        live = np.flatnonzero(valid[k] & (scores[k] > 0.25))
        dets = np.concatenate([boxes[k, live], scores[k, live, None]], 1)
        want = sorted(live[i] for i in jnative.py_cpu_nms(dets, 0.3))
        assert np.flatnonzero(keep[k]).tolist() == want
    _assert_multiclass(boxes, scores, valid, 0.3, 0.0)


@pytest.fixture(scope="module")
def jax_fns():
    """The three JAX functions, jitted once at the fuzz's padded shape (the
    thresholds traced)."""
    class_aware = jax.jit(
        lambda b, s, v, t: jnms.class_aware_nms(b, s, v, t, FUZZ_OUT))
    multiclass = jax.jit(
        lambda b, s, v, t: jdetect.multiclass_nms(b, s, v, t,
                                                  score_thresh=0.3))
    return class_aware, multiclass


def test_nms_api_property_fuzz(jax_fns):
    """Hypothesis (40 examples), as tests/test_nms.py:142-174: integer boxes
    with exact duplicates, containment chains and zero extents, distinct
    scores, two classes, padded to FUZZ_N with invalid boxes. class_aware
    _nms, multiclass_nms (score_thresh 0.3) and py_cpu_nms (the first
    class's real boxes) equal the JAX functions."""
    from hypothesis import given, settings, strategies as st
    class_aware, multiclass = jax_fns

    @settings(max_examples=40, deadline=None)
    @given(st.data())
    def run(data):
        n = data.draw(st.integers(1, FUZZ_N), label="n")
        coord, side = st.integers(0, 24), st.integers(0, 24)
        rows = data.draw(st.lists(st.tuples(coord, coord, side, side),
                                  min_size=n, max_size=n), label="boxes")
        seed = data.draw(st.integers(0, 2 ** 31 - 1), label="seed")
        thresh = data.draw(st.sampled_from([0.1, 0.3, 0.5, 0.7]),
                           label="thresh")
        r = np.random.RandomState(seed)
        boxes = np.zeros((2, FUZZ_N, 4), np.float32)
        boxes[:, :n] = [[x, y, x + w, y + h] for x, y, w, h in rows]
        scores = np.zeros((2, FUZZ_N), np.float32)
        for k in range(2):
            s = np.linspace(1.0, 0.1, n).astype(np.float32)
            r.shuffle(s)
            scores[k, :n] = s
        valid = np.zeros((2, FUZZ_N), bool)
        valid[:, :n] = r.rand(2, n) > 0.1
        t = np.float32(thresh)

        want_idx, want_ok = class_aware(boxes, scores, valid, t)
        idx, ok = _numpy(tnms.class_aware_nms, _t(boxes), _t(scores),
                               _t(valid), thresh, FUZZ_OUT)
        np.testing.assert_array_equal(ok, np.asarray(want_ok))
        np.testing.assert_array_equal(idx, np.asarray(want_idx))
        (keep,) = _numpy(tdetect.multiclass_nms, _t(boxes),
                               _t(scores), _t(valid), thresh,
                               score_thresh=0.3)
        np.testing.assert_array_equal(
            keep, np.asarray(multiclass(boxes, scores, valid, t)))
        dets = np.hstack([boxes[0, :n], scores[0, :n, None]])
        assert tnative.py_cpu_nms(dets, thresh) == \
            jnative.py_cpu_nms(dets, thresh)

    run()


# -- the route: the detect and train paths enter the operators -------------

@pytest.fixture
def op_calls(monkeypatch):
    """Wrap both operators to count their calls; returns the counts."""
    calls = {"nms_keep_mask": 0, "batched_nms_keep": 0}
    for name in calls:
        real = getattr(torch.ops.frcnn, name)

        def counted(*args, _name=name, _real=real, **kwargs):
            calls[_name] += 1
            return _real(*args, **kwargs)
        monkeypatch.setattr(torch.ops.frcnn, name, counted)
    return calls


def _model(mode, **extra):
    """A tiny mobile from the port's cfg defaults, seeded weights."""
    spec = dataclasses.replace(tnet.spec_from_cfg("mobile", 21, mode),
                               **SMALL, **extra)
    model = tnet.FasterRCNN(spec, device="cpu").eval()
    init_model(model, torch.Generator().manual_seed(0))
    return spec, model


def _detect_inputs(b=2):
    rng = np.random.RandomState(0)
    image = torch.from_numpy(
        (rng.rand(b, *CANVAS, 3) * 255 - 128).astype(np.float32))
    im_info = torch.tensor([[90.0, 120.0, 1.5], [80.0, 128.0, 1.6]][:b])
    orig_hw = im_info[:, :2] / im_info[:, 2:]
    return image, im_info, orig_hw


def test_detect_step_enters_both_operators(monkeypatch, op_calls):
    spec, model = _model("TEST")
    inputs = _detect_inputs()
    got = make_detect_fn(model, spec)(*inputs)
    assert op_calls == {"nms_keep_mask": 1, "batched_nms_keep": 1}
    monkeypatch.undo()
    want = make_detect_fn(model, spec)(*inputs)
    assert int(want[1].sum()) > 0
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_train_forward_enters_k1_once(monkeypatch, op_calls):
    spec, model = _model("TRAIN", rpn_batchsize=32, roi_batch_size=16)
    image, im_info, _ = _detect_inputs()
    gt = torch.tensor([[[10.0, 12.0, 60.0, 70.0, 3.0], [0, 0, 0, 0, 0]],
                       [[20.0, 5.0, 90.0, 50.0, 7.0],
                        [40.0, 30.0, 70.0, 75.0, 1.0]]])
    gt_valid = torch.tensor([[True, False], [True, True]])

    def forward():
        gen = torch.Generator().manual_seed(5)
        with torch.no_grad():
            out = model(image, im_info, gt, gt_valid, generator=gen)
        return out, detection_losses(out)

    got, got_losses = forward()
    assert op_calls == {"nms_keep_mask": 1, "batched_nms_keep": 0}
    monkeypatch.undo()
    want, want_losses = forward()
    for key in ("rois", "roi_valid", "cls_score", "bbox_pred"):
        assert torch.equal(got[key], want[key]), key
    assert torch.equal(got["proposal_targets"].labels,
                       want["proposal_targets"].labels)
    assert got_losses.keys() == want_losses.keys()
    for key in want_losses:
        assert torch.equal(got_losses[key], want_losses[key]), key


def test_flag_off_yaml_is_refused(tmp_path):
    """TPU.USE_PALLAS_NMS False from a YAML: spec_from_cfg refuses it in
    both modes, and so does the profiler's --cfg form, naming the flag."""
    path = tmp_path / "flag_off.yml"
    path.write_text("TPU:\n  USE_PALLAS_NMS: False\n")
    tcfg.cfg_from_file(str(path))
    for mode in ("TEST", "TRAIN"):
        with pytest.raises(NotImplementedError, match="TPU.USE_PALLAS_NMS"):
            tnet.spec_from_cfg("mobile", 21, mode)
    with pytest.raises(NotImplementedError, match="TPU.USE_PALLAS_NMS"):
        train_profile.detect_target("mobile", "float32", cfg_file=str(path))


# -- extract_head ------------------------------------------------------------

@pytest.mark.parametrize("backbone", ["mobile", "res50"])
def test_extract_head_matches(rng, backbone):
    """The head's features of the whole detector's bridged weights, f32,
    with and without per-image extents."""
    kw = dict(anchor_scales=(2, 4))
    if backbone == "mobile":
        kw["depth_multiplier"] = 0.25
    jspec = dataclasses.replace(jnet.spec_from_cfg(backbone, 4, "TEST"), **kw)
    tspec = dataclasses.replace(tnet.spec_from_cfg(backbone, 4, "TEST"),
                                **kw)
    jmodel = jnet.FasterRCNN(jspec)
    h, w = 64, 96
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, h, w, 3)),
                            jnp.array([[float(h), float(w), 1.0]]))
    params = numpy_params(shapes, 1)
    tmodel = tnet.FasterRCNN(tspec, device="cpu").eval()
    tmodel.load_state_dict(state_dict_from_flax(params), strict=True)
    image = (rng.randn(2, h, w, 3) * 60).astype(np.float32)
    for valid_hw in (None, np.array([[64, 96], [41, 70]], np.float32)):
        want = np.asarray(jnet.extract_head(jmodel, params, image, valid_hw))
        with torch.no_grad():
            got = tnet.extract_head(
                tmodel, _t(image),
                None if valid_hw is None else _t(valid_hw)).numpy()
        assert got.shape == want.shape
        assert got.dtype == np.float32
        err = float(np.abs(got - want).max()) / float(np.abs(want).max())
        assert err <= 1e-4, f"extract_head {backbone} {valid_hw}: {err:.3g}"
        if valid_hw is not None:
            # the second image's margin is masked to zero in both
            assert not got[1, -1].any() and not want[1, -1].any()
