"""The port's TEST forward and postprocess against the JAX package.

Each stage is fed identical inputs (numpy, from a seed) in both frameworks:

* ``_proposals``: the same proposals in the same slots, and the same valid
  slots (exact; the box coordinates to 1e-6 relative, since torch's and
  XLA's float32 exp may differ by an ulp);
* crop, tail and heads: 1e-4 relative to the largest magnitude (float32
  convolutions summed in different orders);
* ``postprocess_detections``: class ids and the valid mask exact, scores
  and boxes at 1e-5;
* the whole res101 detect chain against ``make_detect_fn``, at the size of
  tests/test_network.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tf_faster_rcnn_tpu.engine.detect import \
    postprocess_detections as jpostprocess
from tf_faster_rcnn_tpu.engine.test_engine import make_detect_fn as jmake
from tf_faster_rcnn_tpu.models import network as jnet
from tf_faster_rcnn_tpu.models.resnet_v1 import ResNetV1Tail as JTail
from tf_faster_rcnn_tpu.ops.anchors import anchor_grid
from tf_faster_rcnn_tpu.ops.roi_align import roi_crop_pool as jcrop
from tf_faster_rcnn_torch.engine.detect import \
    postprocess_detections as tpostprocess
from tf_faster_rcnn_torch.engine.test_engine import make_detect_fn as tmake
from tf_faster_rcnn_torch.models import network as tnet
from tf_faster_rcnn_torch.models.init import numpy_params
from tf_faster_rcnn_torch.utils.weights import state_dict_from_flax

SMALL = dict(anchor_scales=(2, 4), rpn_pre_nms_top_n=512,
             rpn_post_nms_top_n=32)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _rel_close(got, want, tol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = float(np.abs(got - want).max()) / float(np.abs(want).max())
    assert err <= tol, f"max error {err:.3g} relative to max > {tol}"


def _specs(backbone, **kw):
    jspec = dataclasses.replace(jnet.spec_from_cfg(backbone, 21, "TEST"),
                                **kw)
    tspec = dataclasses.replace(tnet.spec_from_cfg(backbone, 21, "TEST"),
                                **kw)
    return jspec, tspec


def _models(backbone, canvas, seed, **kw):
    """Both detectors with the same numpy-drawn parameters."""
    jspec, tspec = _specs(backbone, **kw)
    jmodel = jnet.FasterRCNN(jspec)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                            jnp.zeros((1,) + canvas + (3,)),
                            jnp.array([[float(canvas[0]), float(canvas[1]),
                                        1.0]]))
    params = numpy_params(shapes, seed)
    tmodel = tnet.FasterRCNN(tspec, device="cpu").eval()
    tmodel.load_state_dict(state_dict_from_flax(params), strict=True)
    return jspec, jmodel, params, tspec, tmodel


@pytest.mark.parametrize("fh,fw,pre,post,ties", [
    (8, 8, 512, 32, False),
    (8, 8, 512, 32, True),
    (38, 64, 6000, 300, False),     # the main path's 608x1024 canvas
])
def test_proposals_match(rng, fh, fw, pre, post, ties):
    scales = (2, 4) if fh == 8 else (8, 16, 32)
    jspec, tspec = _specs("res50", anchor_scales=scales,
                          rpn_pre_nms_top_n=pre, rpn_post_nms_top_n=post)
    anchors = anchor_grid(fh, fw, 16, scales, jspec.anchor_ratios)
    n = anchors.shape[0]
    deltas = (rng.randn(2, n, 4) * 0.3).astype(np.float32)
    scores = rng.rand(2, n).astype(np.float32)
    if ties:
        scores = np.round(scores * 16) / 16          # 17 values, bulk ties
    im_info = np.array([[fh * 16.0, fw * 16.0, 1.0],
                        [fh * 12.0 + 3, fw * 10.0 + 5, 1.0]], np.float32)
    j_rois, j_scores, j_valid = jnet.FasterRCNN(jspec).apply(
        {}, anchors, deltas, scores, im_info, fw,
        method=jnet.FasterRCNN._proposals)
    tmodel = tnet.FasterRCNN(tspec, device="cpu")
    t_rois, t_scores, t_valid = tmodel._proposals(
        _t(anchors), _t(deltas), _t(scores), _t(im_info), fw)
    np.testing.assert_array_equal(t_valid.numpy(), np.asarray(j_valid))
    np.testing.assert_array_equal(t_scores.numpy(), np.asarray(j_scores))
    # one ulp of exp in the decode: at most 6.1e-5 at coordinates ~1000
    np.testing.assert_allclose(t_rois.numpy(), np.asarray(j_rois),
                               rtol=1e-6, atol=1e-4)
    assert int(t_valid.sum()) > post // 2


@pytest.mark.parametrize("max_pool", [False, True])
def test_roi_heads_match(rng, max_pool):
    """Crop -> tail -> cls_score / bbox_pred -> un-normalize, on the same
    features and rois."""
    jspec, _, params, tspec, tmodel = _models(
        "res101", (64, 96), 5, resnet_max_pool=max_pool, **SMALL)
    p = params["params"]
    feats = np.abs(rng.randn(2, 4, 6, 1024)).astype(np.float32)
    rois = rng.uniform(0, 60, (2, 12, 4)).astype(np.float32)
    rois[..., 2:] = rois[..., :2] + rng.uniform(8, 40, (2, 12, 2))
    im_info = np.array([[64.0, 96.0, 1.0], [50.0, 70.0, 1.0]], np.float32)

    pooled = jcrop(feats, rois, 16, 7, max_pool,
                   valid_hw=np.ceil(im_info[:, :2] / 16.0))
    fc7 = JTail(101).apply({"params": p["tail"]},
                           pooled.reshape(24, 7, 7, 1024))
    fc7 = np.asarray(fc7)
    cls = fc7 @ p["cls_score"]["kernel"] + p["cls_score"]["bias"]
    box = fc7 @ p["bbox_pred"]["kernel"] + p["bbox_pred"]["bias"]
    box = box * np.tile(np.float32(jspec.bbox_normalize_stds), 21)

    with torch.no_grad():
        t_cls, t_box = tmodel._roi_heads(_t(feats).permute(0, 3, 1, 2),
                                         _t(rois), _t(im_info))
    _rel_close(t_cls.numpy(), cls.reshape(2, 12, 21), 1e-4)
    _rel_close(t_box.numpy(), box.reshape(2, 12, 84), 1e-4)


def _post_inputs(rng, b, r, k, scale=1.5):
    rois = rng.uniform(0, 300, (b, r, 4)).astype(np.float32)
    rois[..., 2:] = rois[..., :2] + rng.uniform(5, 100, (b, r, 2))
    logits = rng.randn(b, r, k).astype(np.float32) * 2
    prob = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    pred = (rng.randn(b, r, 4 * k) * 0.1).astype(np.float32)
    im_info = np.tile(np.array([[480, 640, scale]], np.float32), (b, 1))
    ohw = np.tile(np.array([[320, 427]], np.float32), (b, 1))
    return rois, np.ones((b, r), bool), prob.astype(np.float32), pred, \
        im_info, ohw


def _compare_post(args, **kw):
    jd, jv = jpostprocess(*args, **kw)
    td, tv = tpostprocess(*[_t(a) for a in args], **kw)
    jd, jv = np.asarray(jd), np.asarray(jv)
    np.testing.assert_array_equal(tv.numpy(), jv)
    np.testing.assert_array_equal(td[..., 0].numpy(), jd[..., 0])
    np.testing.assert_allclose(td.numpy(), jd, rtol=1e-5, atol=0)
    return td, tv


def test_postprocess_matches(rng):
    args = _post_inputs(rng, 2, 50, 6)
    args[1][1, 30:] = False                          # invalid rois
    td, tv = _compare_post(args, num_classes=6, max_per_image=20,
                           nms_thresh=0.3)
    assert int(tv.sum()) == 40


def test_postprocess_ties_and_score_threshold(rng):
    """Tied class scores (a flat 0.25 table) resolve by index in both."""
    rois, valid, _, pred, im_info, ohw = _post_inputs(rng, 2, 30, 4)
    prob = np.full((2, 30, 4), 0.25, np.float32)
    prob[0, :4, 1] = [0.9, 0.6, 0.4, 0.05]
    args = (rois, valid, prob, np.zeros_like(pred), im_info, ohw)
    _compare_post(args, num_classes=4, max_per_image=10, nms_thresh=0.3)
    _compare_post(args, num_classes=4, max_per_image=10, nms_thresh=0.99,
                  score_thresh=0.3)


def test_postprocess_bbox_reg_off(rng):
    rois, valid, prob, pred, im_info, ohw = _post_inputs(rng, 2, 20, 5, 2.0)
    _compare_post((rois, valid, prob, pred * 100, im_info, ohw),
                  num_classes=5, max_per_image=10, nms_thresh=0.3,
                  bbox_reg=False)


def test_postprocess_cap_exceeds_candidates(rng):
    """max_per_image > classes x proposals: the slab is padded."""
    args = _post_inputs(rng, 2, 4, 3)
    td, tv = _compare_post(args, num_classes=3, max_per_image=100,
                           nms_thresh=0.3)
    assert td.shape == (2, 100, 6) and not tv[:, 8:].any()


# The seed of the whole-chain test: chosen so that the top fg scores are
# separated far beyond the frameworks' float32 disagreement (asserted below).
CHAIN_SEED = 30


def test_detect_chain_res101_matches_make_detect_fn():
    """res101 TEST at 128x128, B = 2 with different extents, scales (2, 4),
    512 -> 32 proposals: the port's detect fn against the JAX one."""
    canvas = (128, 128)
    jspec, jmodel, params, tspec, tmodel = _models("res101", canvas,
                                                   CHAIN_SEED, **SMALL)
    rng = np.random.RandomState(CHAIN_SEED)
    image = (rng.randn(2, 128, 128, 3) * 60).astype(np.float32)
    im_info = np.array([[128.0, 128.0, 1.6], [100.0, 120.0, 1.25]],
                       np.float32)
    orig_hw = np.array([[80.0, 80.0], [80.0, 96.0]], np.float32)

    jout = jax.tree_util.tree_map(
        np.asarray, jax.jit(jmodel.apply)(params, image, im_info))
    with torch.no_grad():
        tout = tmodel(_t(image), _t(im_info))

    # the proposals can match only if the top fg scores are separated far
    # beyond the frameworks' float32 disagreement: the smallest gap between
    # the sorted top-k scores (k = post_nms_top_n) must exceed 100x the
    # largest fg-score difference over all anchors
    jfg = np.asarray(jax.nn.softmax(jout["rpn_cls_score"], -1))[..., 1]
    tfg = torch.softmax(tout["rpn_cls_score"], -1)[..., 1].numpy()
    disagreement = float(np.abs(jfg - tfg).max())
    k = tspec.rpn_post_nms_top_n
    for b in range(2):
        ranked = np.sort(jfg[b])[::-1][:k]
        gap = float(np.min(-np.diff(ranked)))
        assert gap > 100 * disagreement, (b, gap, disagreement)

    np.testing.assert_array_equal(tout["roi_valid"].numpy(),
                                  jout["roi_valid"])
    np.testing.assert_allclose(tout["rois"].numpy(), jout["rois"],
                               rtol=0, atol=1e-3)
    for key in ("cls_prob", "bbox_pred"):
        _rel_close(tout[key].numpy(), jout[key], 1e-4)

    jdet, jdv = jmake(jmodel, jspec)(params, image, im_info, orig_hw)
    tdet, tdv = tmake(tmodel, tspec)(_t(image), _t(im_info), _t(orig_hw))
    jdet, jdv = np.asarray(jdet), np.asarray(jdv)
    assert tdet.shape == (2, 100, 6)
    np.testing.assert_array_equal(tdv.numpy(), jdv)
    np.testing.assert_array_equal(tdet[..., 0].numpy(), jdet[..., 0])
    np.testing.assert_allclose(tdet.numpy(), jdet, rtol=1e-4, atol=1e-3)


def test_chip_smoke_workload_is_the_bench_workload():
    """chip_smoke.py runs without the config module, so its canvas and
    scenes are copies: hold them to config.canvas_buckets and bench.py."""
    import bench
    import chip_smoke
    from tf_faster_rcnn_tpu.config import canvas_buckets, cfg
    assert chip_smoke.CANVAS == canvas_buckets(cfg.TEST)[0]
    np.testing.assert_array_equal(
        chip_smoke.synthetic_scenes(np.random.RandomState(0), 2, 96, 160),
        bench.synthetic_scenes(np.random.RandomState(0), 2, 96, 160))


def test_chip_smoke_train_workload_is_the_reference_config():
    """chip_smoke.py's train path: TRAIN_CFG leaves the port's cfg as
    experiments/cfgs/res101.yml leaves it, and its gt boxes are the
    rectangles synthetic_scenes paints, inside the image extent."""
    import os.path as osp
    import chip_smoke
    from tf_faster_rcnn_torch import config as tcfg
    path = osp.join(osp.dirname(osp.dirname(osp.abspath(__file__))),
                    "experiments", "cfgs", "res101.yml")
    try:
        tcfg.cfg_from_file(path)
        want = tnet.spec_from_cfg("res101", 21, "TRAIN")
        yaml_cfg = {k: dict(v) if isinstance(v, dict) else v
                    for k, v in tcfg.cfg.items()}
        tcfg.reset_cfg()
        tcfg.cfg_from_list(chip_smoke.TRAIN_CFG)
        assert tnet.spec_from_cfg("res101", 21, "TRAIN") == want
        # the train loop's logging interval and snapshot name aside
        skip = ("DISPLAY", "SNAPSHOT_PREFIX")
        for key in ("TRAIN", "TPU", "RESNET"):
            got = {k: v for k, v in tcfg.cfg[key].items() if k not in skip}
            assert got == {k: v for k, v in yaml_cfg[key].items()
                           if k not in skip}, key
    finally:
        tcfg.reset_cfg()
    assert (want.rpn_pre_nms_top_n, want.rpn_post_nms_top_n,
            want.roi_batch_size, want.bg_thresh_lo) == (12000, 2000, 256, 0.0)
    assert chip_smoke.MAX_GT == tcfg.cfg.TPU.MAX_GT

    h, w = 96, 160
    image = chip_smoke.synthetic_scenes(np.random.RandomState(0), 3, h, w)
    rects = chip_smoke.scene_rectangles(np.random.RandomState(0), 3, h, w)
    for b, image_rects in enumerate(rects):
        assert 2 <= len(image_rects) <= 6
        painted = np.zeros((h, w), bool)
        for x1, y1, x2, y2 in image_rects:
            painted[y1:y2 + 1, x1:x2 + 1] = True
        # outside the rectangles: the dark background (below 60 - 128)
        assert (image[b][~painted] < 60 - 128).all()
        x1, y1, x2, y2 = image_rects[-1]       # painted last: on top
        patch = image[b, y1:y2 + 1, x1:x2 + 1]
        assert (patch >= 140 - 128).all() and (patch == patch[0, 0]).all()
