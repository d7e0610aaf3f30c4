"""The port's vgg16 and MobileNet-v1 backbones, its bfloat16 compute path,
TEST.MODE 'top' and res152, against the JAX package.

Parameters are drawn with numpy by the port's init recipe
(tf_faster_rcnn_torch/models/init.py::numpy_params) and reach the port
through the weight bridge. Tolerances:

* float32 modules and forwards: 1e-4 relative to the largest magnitude,
  as the res101 tests (the frameworks sum convolutions in different
  orders); proposal slots, valid masks and class ids exact;
* bfloat16 units: FrozenBN equal to the JAX fold in bfloat16 (both round
  each operation), a convolution within 2 bfloat16 quanta (2/256) of the
  output's largest magnitude (each side rounds one float32 sum);
* the bfloat16 crop: within 1/256 of the feature scale of the float32 crop
  of the same features (the port rounds once), and within the JAX
  package's own 6/256 of its bfloat16 einsum;
* the bfloat16 res101 forward: a drift from float32 bounded on both sides
  (nonzero, so bfloat16 ran; and within 4x the JAX package's own drift),
  and proposals exactly equal when both packages get the same RPN outputs.

Every test caps torch at two threads (the suite runs several workers).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tf_faster_rcnn_tpu.models import layers as jlayers
from tf_faster_rcnn_tpu.models import mobilenet_v1 as jmob
from tf_faster_rcnn_tpu.models import network as jnet
from tf_faster_rcnn_tpu.models import vgg16 as jvgg
from tf_faster_rcnn_tpu.models.resnet_v1 import ResNetV1Tail as JResTail
from tf_faster_rcnn_tpu.ops import roi_align as jroi
from tf_faster_rcnn_torch.models import layers as tlayers
from tf_faster_rcnn_torch.models import mobilenet_v1 as tmob
from tf_faster_rcnn_torch.models import network as tnet
from tf_faster_rcnn_torch.models import vgg16 as tvgg
from tf_faster_rcnn_torch.models.init import init_model, numpy_params
from tf_faster_rcnn_torch.ops import roi_align as troi
from tf_faster_rcnn_torch.utils.weights import state_dict_from_flax

BF16_QUANTUM = 1.0 / 256.0
SMALL = dict(anchor_scales=(2, 4), rpn_pre_nms_top_n=512,
             rpn_post_nms_top_n=32)


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(min(before, 2))
    yield
    torch.set_num_threads(before)


def _t(x):
    return torch.from_numpy(np.array(x))


def _f32(x):
    return np.asarray(x, dtype=np.float32)


def _rel_err(got, want):
    got, want = _f32(got), _f32(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                 1e-30)


def _rel_close(got, want, tol=1e-4, name=""):
    err = _rel_err(got, want)
    assert err <= tol, f"{name}: max error {err:.3g} relative to max > {tol}"


def _nchw(x):
    return _t(x).permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1).detach().float().numpy()


def _bridge(module, params):
    module.load_state_dict(state_dict_from_flax(params), strict=True)
    return module.eval()


def _init(jmodule, seed, *args):
    shapes = jax.eval_shape(jmodule.init, jax.random.PRNGKey(0), *args)
    return numpy_params(shapes["params"], seed)


# --- vgg16 -----------------------------------------------------------------

def test_vgg16_head_matches_at_odd_feature_sizes(rng):
    """72x88 pools to 36x44, 18x22, 9x11 and 5x6: SAME pads the odd 9 and
    11 at the end with -inf (ceil_mode). The margin of the second image is
    masked after every conv and pool."""
    x = (rng.randn(2, 72, 88, 3) * 60).astype(np.float32)
    valid = np.array([[72, 88], [50, 61]], np.float32)
    jhead = jvgg.VGG16Head()
    params = _init(jhead, 11, x, valid)
    thead = _bridge(tvgg.VGG16Head(), params)
    want = jax.jit(jhead.apply)({"params": params}, x, valid)
    with torch.no_grad():
        got = thead(_nchw(x), _t(valid))
    assert got.shape == (2, 512, 5, 6)
    _rel_close(_nhwc(got), want)


@pytest.mark.parametrize("train", [False, True])
def test_vgg16_tail_matches_fc6_bridge_and_dropout(rng, train):
    """fc6 at the full 7x7x512 input: the flax kernel bridges unchanged
    because the port flattens the NHWC crop in (h, w, c) order. In TRAIN
    the port takes the keep masks flax drew (captured_dropout_masks)."""
    pooled = np.abs(rng.randn(6, 7, 7, 512)).astype(np.float32)
    jtail = jvgg.VGG16Tail(deterministic=not train)
    params = _init(jtail, 12, pooled)
    ttail = _bridge(tvgg.VGG16Tail(7), params)
    assert tuple(ttail.fc6.weight.shape) == (4096, 25088)
    keep = None
    rngs = {"dropout": jax.random.PRNGKey(5)}
    if train:
        keep = captured_dropout_masks(
            lambda p: jtail.apply({"params": p}, pooled, rngs=rngs), params)
        assert [k.shape for k in keep] == [(6, 4096)] * 2
        keep = tuple(_t(k) for k in keep)
        assert 0.4 < float(keep[0].float().mean()) < 0.6
    want = jtail.apply({"params": params}, pooled, rngs=rngs)
    with torch.no_grad():
        got = ttail(_t(pooled), keep)
    _rel_close(got.numpy(), want)


def captured_dropout_masks(apply_fn, *args):
    """The keep masks of every flax Dropout that apply_fn(*args) calls, in
    call order, under jit: each Dropout is run once on ones (so it draws
    its rng exactly as it would on its input) and its nonzero outputs are
    the mask."""
    from flax import linen as nn

    def run(*args):
        masks = []

        def interceptor(next_fun, call_args, kwargs, context):
            if not (isinstance(context.module, nn.Dropout)
                    and context.method_name == "__call__"):
                return next_fun(*call_args, **kwargs)
            x = call_args[0]
            keep = next_fun(jnp.ones_like(x), *call_args[1:], **kwargs) != 0
            masks.append(keep)
            return jnp.where(keep, x / (1.0 - context.module.rate), 0)

        with nn.intercept_methods(interceptor):
            apply_fn(*args)
        return masks

    return [np.asarray(m) for m in jax.jit(run)(*args)]


def test_vgg16_trainable_filter_matches():
    jspec, _, params, tspec, tmodel = _models("vgg16", (64, 64), 0,
                                              pooling_size=3)
    _assert_same_mask(jspec, params, tmodel)
    frozen = [n for n, p in tmodel.named_parameters() if not p.requires_grad]
    assert sorted(frozen) == sorted(
        f"head.conv{b}_{r}.{leaf}" for b in (1, 2) for r in (1, 2)
        for leaf in ("weight", "bias"))


# --- mobilenet_v1 ----------------------------------------------------------

@pytest.mark.parametrize("multiplier", [0.25, 1.0])
def test_mobilenet_head_matches(rng, multiplier):
    """Depthwise 3x3 kernels [3,3,1,C] bridge to [C,1,3,3]; conv2d_same at
    stride 2, relu6, FrozenBN eps 0.001, widths max(int(d*m), 8); the
    second image's margin masked after every layer."""
    x = (rng.randn(2, 48, 80, 3) * 60).astype(np.float32)
    valid = np.array([[48, 80], [33, 50]], np.float32)
    jhead = jmob.MobileNetV1Head(multiplier, fixed_layers=5)
    params = _init(jhead, 13, x, valid)
    thead = _bridge(tmob.MobileNetV1Head(multiplier, 5), params)
    dw = thead.base.conv2d_1.depthwise.weight
    assert tuple(dw.shape) == (tmob.depth(32, multiplier), 1, 3, 3)
    np.testing.assert_array_equal(
        dw.detach().numpy()[:, 0], np.asarray(
            params["base"]["conv2d_1"]["depthwise"]["kernel"])[:, :, 0]
        .transpose(2, 0, 1))
    want = jax.jit(jhead.apply)({"params": params}, x, valid)
    with torch.no_grad():
        got = thead(_nchw(x), _t(valid))
    assert got.shape == (2, tmob.depth(512, multiplier), 3, 5)
    _rel_close(_nhwc(got), want)


def test_mobilenet_tail_matches(rng):
    pooled = np.abs(rng.randn(5, 7, 7, 128)).astype(np.float32)
    jtail = jmob.MobileNetV1Tail(0.25)
    params = _init(jtail, 14, pooled)
    ttail = _bridge(tmob.MobileNetV1Tail(0.25), params)
    want = jtail.apply({"params": params}, pooled)
    with torch.no_grad():
        got = ttail(_t(pooled))
    assert got.shape == (5, 256)
    _rel_close(got.numpy(), want)


@pytest.mark.parametrize("fixed_layers", [0, 5, 12])
def test_mobilenet_trainable_filter_matches(fixed_layers):
    from tf_faster_rcnn_tpu.config import cfg as jcfg
    jcfg.MOBILENET.FIXED_LAYERS = fixed_layers
    jspec, _, params, tspec, tmodel = _models(
        "mobile", (64, 64), 0, depth_multiplier=0.25,
        fixed_layers=fixed_layers)
    _assert_same_mask(jspec, params, tmodel)
    frozen = {n.split(".")[2] for n, p in tmodel.named_parameters()
              if not p.requires_grad}
    assert frozen == {f"conv2d_{i}" for i in range(fixed_layers)}


def test_mobilenet_frozen_prefix_gradients_are_pruned(rng):
    """The head detaches after layer FIXED_LAYERS-1: with every parameter
    made trainable, the frozen layers' gradients are exactly zero and the
    next layer's are not."""
    spec = dataclasses.replace(tnet.spec_from_cfg("mobile", 5, "TEST"),
                               depth_multiplier=0.25, fixed_layers=3)
    model = tnet.FasterRCNN(spec, device="cpu")
    init_model(model, torch.Generator().manual_seed(0))
    for p in model.parameters():
        p.requires_grad_(True)
    x = _t((rng.randn(1, 64, 64, 3) * 60).astype(np.float32))
    feat = model.head(x.permute(0, 3, 1, 2), None)
    names = ["head.base.conv2d_0.weight", "head.base.conv2d_2.pointwise.weight",
             "head.base.conv2d_3.depthwise.weight"]
    named = dict(model.named_parameters())
    grads = torch.autograd.grad(feat.square().sum(),
                                [named[n] for n in names], allow_unused=True)
    for name, g in zip(names[:2], grads[:2]):
        assert g is None or float(g.abs().max()) == 0.0, name
    assert float(grads[2].abs().max()) > 0.0


# --- the whole model: bridge, spec, init -----------------------------------

def _specs(backbone, **kw):
    jspec = dataclasses.replace(jnet.spec_from_cfg(backbone, 21, "TEST"),
                                **kw)
    tspec = dataclasses.replace(tnet.spec_from_cfg(backbone, 21, "TEST"),
                                **kw)
    return jspec, tspec


def _models(backbone, canvas, seed, **kw):
    """Both detectors (TEST) with the same numpy-drawn parameters."""
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


def _assert_same_mask(jspec, params, tmodel):
    """The port's trainable parameters are the JAX mask's True leaves; the
    mask's BN leaves are the port's buffers."""
    mask = state_dict_from_flax(jax.tree_util.tree_map(
        lambda m, p: np.full(p.shape, m, np.float32),
        jnet.trainable_mask(params, jspec), params))
    mask = {k: bool(v.all()) for k, v in mask.items()}
    port = tnet.trainable_mask(tmodel)
    buffers = {k for k, _ in tmodel.named_buffers()}
    assert set(port) == set(mask) - buffers
    for name in buffers:
        assert not mask[name], name
    for name, trainable in port.items():
        assert trainable == mask[name], name
        assert dict(tmodel.named_parameters())[name].requires_grad == trainable


def test_seeded_init_keeps_new_backbones_order_one():
    """init_model draws every tensor of vgg16 and mobile nonzero, and the
    head features stay O(1) on raw-pixel inputs (the first conv of each
    backbone is He / 128)."""
    x = torch.from_numpy(
        (np.random.RandomState(0).randn(1, 3, 64, 96) * 60).astype(np.float32))
    for backbone, kw in (("vgg16", dict(pooling_size=3)),
                         ("mobile", dict(depth_multiplier=0.25))):
        spec = dataclasses.replace(tnet.ModelSpec(backbone, 5), **kw)
        model = tnet.FasterRCNN(spec, device="cpu").eval()
        init_model(model, torch.Generator().manual_seed(0))
        for name, t in model.state_dict().items():
            assert float(t.abs().max()) > 0, name
        with torch.no_grad():
            rms = float(model.head(x).pow(2).mean().sqrt())
        assert 0.05 < rms < 50, (backbone, rms)


# --- bfloat16 units --------------------------------------------------------

def _bf16(x):
    """x rounded to bfloat16, as float32 numpy."""
    return _f32(jnp.asarray(x, jnp.bfloat16))


def test_frozen_bn_bf16_matches(rng):
    """Under PARAM_DTYPE bfloat16 the four arrays are bfloat16 and both
    packages fold them in bfloat16, one rounding per operation, then apply
    in the activation's dtype: equal to the JAX output bit for bit."""
    x = _bf16(rng.randn(2, 4, 6, 16) * 3)
    arrays = {"mean": rng.randn(16), "var": rng.uniform(1e-4, 2, 16),
              "scale": rng.randn(16), "bias": rng.randn(16)}
    jparams = {k: jnp.asarray(v, jnp.bfloat16) for k, v in arrays.items()}
    bn = tlayers.FrozenBatchNorm(16, epsilon=0.001).to(torch.bfloat16)
    for k, v in jparams.items():
        getattr(bn, k).copy_(_t(_f32(v)))
    assert bn.var.dtype == torch.bfloat16
    want = jlayers.FrozenBatchNorm(epsilon=0.001).apply(
        {"params": jparams}, jnp.asarray(x, jnp.bfloat16))
    got = bn(_nchw(x).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(_nhwc(got), _f32(want))


@pytest.mark.parametrize("groups", [1, 8])
def test_conv_bf16_matches(rng, groups):
    """A float32 master weight computed in bfloat16 (flax's dtype=): the
    output is bfloat16, within 2 quanta of the JAX conv's largest value;
    the weight's gradient is float32."""
    x = rng.randn(2, 11, 9, 8).astype(np.float32)
    jconv = jlayers.ConvSame(8, 3, 2, dtype=jnp.bfloat16,
                             feature_group_count=groups)
    params = _init(jconv, 3, x)
    tconv = _bridge(tlayers.ConvSame(8, 8, 3, 2, groups=groups,
                                     compute_dtype=torch.bfloat16), params)
    want = jconv.apply({"params": params}, x)
    assert want.dtype == jnp.bfloat16
    xt = _nchw(x)
    got = tconv(xt)
    assert got.dtype == torch.bfloat16
    _rel_close(_nhwc(got), want, 2 * BF16_QUANTUM)
    # and both are the float32 conv to within their rounding
    _rel_close(_nhwc(got), jlayers.ConvSame(
        8, 3, 2, feature_group_count=groups).apply({"params": params},
                                                   _bf16(x)),
        2 * BF16_QUANTUM)
    (g,) = torch.autograd.grad(got.float().sum(), tconv.weight)
    assert g.dtype == torch.float32


def _crop_inputs(rng):
    feats = _bf16(rng.randn(2, 9, 13, 16) * 4)
    rois = rng.uniform(0, 180, (2, 20, 4)).astype(np.float32)
    rois[..., 2:] = rois[..., :2] + rng.uniform(4, 90, (2, 20, 2))
    valid = np.array([[9.0, 13.0], [6.0, 10.0]], np.float32)
    return feats, rois, valid


@pytest.mark.parametrize("max_pool", [False, True])
def test_crop_bf16_drift_bounded(rng, max_pool):
    """The port blends in float32 and rounds once: within 1/256 of the
    feature scale of the float32 crop of the same (bfloat16) features. The
    JAX einsum rounds its weights, its intermediate and its result: the
    two bfloat16 crops agree within its own 6/256 bound
    (tests/test_tf_differential.py::test_crop_and_resize_bf16_drift_bounded)
    and the port is the closer of the two to float32."""
    feats, rois, valid = _crop_inputs(rng)
    scale = float(np.abs(feats).max())
    want = _f32(jroi.roi_crop_pool(feats, rois, 16, 7, max_pool,
                                   valid_hw=valid))
    jbf = _f32(jroi.roi_crop_pool(jnp.asarray(feats, jnp.bfloat16), rois,
                                  16, 7, max_pool, valid_hw=valid))
    got = troi.roi_crop_pool(_t(feats).to(torch.bfloat16), _t(rois), 16, 7,
                             max_pool, valid_hw=_t(valid))
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    port_drift = float(np.abs(got - want).max()) / scale
    jax_drift = float(np.abs(jbf - want).max()) / scale
    assert 0 < port_drift <= BF16_QUANTUM, port_drift
    assert float(np.abs(got - jbf).max()) / scale < 6 * BF16_QUANTUM
    assert port_drift <= jax_drift, (port_drift, jax_drift)


# --- TEST forwards of vgg16, mobile and res152 -----------------------------

def _chain_inputs(seed, canvas=(128, 128)):
    rng = np.random.RandomState(seed)
    image = (rng.randn(2, canvas[0], canvas[1], 3) * 60).astype(np.float32)
    im_info = np.array([[canvas[0], canvas[1], 1.6],
                        [canvas[0] - 28.0, canvas[1] - 8.0, 1.25]],
                       np.float32)
    return image, im_info


def _assert_score_separation(jout, tout, k, factor=10.0):
    """The proposals can match only if the frameworks rank the top k fg
    scores alike: every gap between them must exceed factor x the largest
    fg-score disagreement."""
    jfg = _f32(jax.nn.softmax(jout["rpn_cls_score"], -1))[..., 1]
    tfg = torch.softmax(tout["rpn_cls_score"].float(), -1)[..., 1].numpy()
    disagreement = float(np.abs(jfg - tfg).max())
    for b in range(jfg.shape[0]):
        ranked = np.sort(jfg[b])[::-1][:k]
        gap = float(np.min(-np.diff(ranked)))
        assert gap > factor * disagreement, (b, gap, disagreement)


# each seed chosen so that the top fg scores are separated far beyond the
# two frameworks' float32 disagreement (asserted)
@pytest.mark.parametrize("backbone,kw,seed", [
    ("vgg16", dict(pooling_size=3), 1),
    ("mobile", dict(depth_multiplier=0.25), 1),
    ("res152", {}, 1),
])
def test_test_forward_matches(backbone, kw, seed):
    """The whole TEST forward at 128x128, B = 2 with different extents:
    rois and valid slots equal, cls_prob and bbox_pred within 1e-4. res152
    is the first backbone test of that depth (no JAX test runs it)."""
    _, jmodel, params, tspec, tmodel = _models(backbone, (128, 128), seed,
                                               **SMALL, **kw)
    image, im_info = _chain_inputs(seed)
    jout = jax.tree_util.tree_map(
        np.asarray, jax.jit(jmodel.apply)(params, image, im_info))
    with torch.no_grad():
        tout = tmodel(_t(image), _t(im_info))
    _assert_score_separation(jout, tout, tspec.rpn_post_nms_top_n)
    np.testing.assert_array_equal(tout["roi_valid"].numpy(),
                                  jout["roi_valid"])
    assert int(tout["roi_valid"].sum()) > 0
    np.testing.assert_allclose(tout["rois"].numpy(), jout["rois"],
                               rtol=0, atol=1e-3)
    for key in ("rpn_cls_score", "rpn_bbox_pred", "cls_prob", "bbox_pred"):
        _rel_close(tout[key].numpy(), jout[key], 1e-4, key)


# --- TEST.MODE 'top' -------------------------------------------------------

@pytest.mark.parametrize("ties", [False, True])
def test_top_mode_proposals_match(rng, ties):
    """'top': the plain top rpn_top_n masked fg scores, no NMS, ties to the
    lower index; slots past the image's anchors are invalid."""
    jspec, tspec = _specs("res50", anchor_scales=(2, 4), test_mode="top",
                          rpn_top_n=200)
    fh = fw = 8
    from tf_faster_rcnn_torch.ops.anchors import anchor_grid
    anchors = anchor_grid(fh, fw, 16, (2, 4), jspec.anchor_ratios)
    n = anchors.shape[0]
    deltas = (rng.randn(2, n, 4) * 0.3).astype(np.float32)
    scores = rng.rand(2, n).astype(np.float32)
    if ties:
        scores = np.round(scores * 8) / 8
    im_info = np.array([[128.0, 128.0, 1.0], [40.0, 60.0, 1.0]], np.float32)
    want = jnet.FasterRCNN(jspec).apply(
        {}, anchors, deltas, scores, im_info, fw,
        method=jnet.FasterRCNN._proposals)
    got = tnet.FasterRCNN(tspec, device="cpu")._proposals(
        _t(anchors), _t(deltas), _t(scores), _t(im_info), fw)
    j_rois, j_scores, j_valid = [np.asarray(w) for w in want]
    np.testing.assert_array_equal(got[2].numpy(), j_valid)
    np.testing.assert_array_equal(got[1].numpy(), j_scores)
    np.testing.assert_allclose(got[0].numpy(), j_rois, rtol=1e-6, atol=1e-4)
    assert bool(j_valid[0].all()) and not bool(j_valid[1].all())
    assert np.all(np.diff(j_scores[0]) <= 0)


def test_top_mode_pad_branch_takes_the_indices_given():
    """rpn_top_n > #anchors: the reference pads by random choice with
    replacement over all anchors, ignoring scores. The port takes the JAX
    package's indices (randint of fold_in(PRNGKey(0), i)) as top_pad and
    matches it exactly, valid slots included (as tests/test_network.py's
    pad test). Left to itself it draws them per image from a generator
    seeded with i: the same on every call."""
    jspec, tspec = _specs("vgg16", **SMALL, pooling_size=3, test_mode="top")
    rng = np.random.RandomState(2)
    fh, fw = 4, 6
    n = fh * fw * 6
    top_n = n + 37
    jspec = dataclasses.replace(jspec, rpn_top_n=top_n)
    tspec = dataclasses.replace(tspec, rpn_top_n=top_n)
    from tf_faster_rcnn_torch.ops.anchors import anchor_grid
    anchors = anchor_grid(fh, fw, 16, (2, 4), jspec.anchor_ratios)
    deltas = (rng.randn(2, n, 4) * 0.3).astype(np.float32)
    scores = rng.rand(2, n).astype(np.float32)
    im_info = np.array([[64.0, 96.0, 1.0], [40.0, 50.0, 1.0]], np.float32)
    want = [np.asarray(w) for w in jnet.FasterRCNN(jspec).apply(
        {}, anchors, deltas, scores, im_info, fw,
        method=jnet.FasterRCNN._proposals)]
    pad = np.stack([np.asarray(jax.random.randint(
        jax.random.fold_in(jax.random.PRNGKey(0), i), (top_n,), 0, n))
        for i in range(2)])
    model = tnet.FasterRCNN(tspec, device="cpu")
    args = (_t(anchors), _t(deltas), _t(scores), _t(im_info), fw)
    got = model._proposals(*args, top_pad=_t(pad).long())
    np.testing.assert_array_equal(got[2].numpy(), want[2])
    np.testing.assert_array_equal(got[1].numpy(), want[1])
    np.testing.assert_allclose(got[0].numpy(), want[0], rtol=1e-6, atol=1e-4)
    assert got[0].shape == (2, top_n, 4)
    assert len(np.unique(want[0][0], axis=0)) < top_n      # resampled
    assert bool(got[2][0].all()) and not bool(got[2][1].all())
    first, again = model._proposals(*args), model._proposals(*args)
    for a, b in zip(first, again):
        assert torch.equal(a, b)
    assert not torch.equal(first[1][0], first[1][1])      # per image


def test_top_mode_forward_builds_from_cfg():
    """TEST.MODE 'top' from the cfg: the whole forward gives rpn_top_n
    proposals sorted by score, all valid on a full image."""
    from tf_faster_rcnn_torch.config import cfg, reset_cfg
    cfg.TEST.MODE = "top"
    cfg.TEST.RPN_TOP_N = 40
    try:
        spec = dataclasses.replace(tnet.spec_from_cfg("res50", 5, "TEST"),
                                   anchor_scales=(2, 4))
    finally:
        reset_cfg()
    assert (spec.test_mode, spec.rpn_top_n) == ("top", 40)
    model = tnet.FasterRCNN(spec, device="cpu").eval()
    init_model(model, torch.Generator().manual_seed(0))
    image, im_info = _chain_inputs(0, (64, 64))
    with torch.no_grad():
        out = model(_t(image), _t(im_info))
    assert out["rois"].shape == (2, 40, 4)
    assert bool(out["roi_valid"].all())
    assert bool((out["roi_scores"].diff(dim=1) <= 0).all())


# --- the bfloat16 res101 forward -------------------------------------------

def test_bf16_res101_forward_drift_bounded():
    """res101 at COMPUTE_DTYPE bfloat16, 64x96, B = 2, on the float32
    weights. Against the float32 forward of the same package on the same
    weights, the port drifts (so bfloat16 ran) and by no more than 4x the
    JAX package's own drift, on the RPN outputs and on the RoI heads at the
    same rois. The RPN outputs leave both in float32. Fed the same RPN
    outputs (JAX's bfloat16 ones), the two proposal selections give the
    same slots and valid masks."""
    canvas = (64, 96)
    _, jmodel, params, tspec, tmodel = _models("res101", canvas, 7, **SMALL)
    jspec16, tspec16 = _specs("res101", compute_dtype="bfloat16", **SMALL)
    assert tspec16.dtype == torch.bfloat16
    jmodel16 = jnet.FasterRCNN(jspec16)
    tmodel16 = tnet.FasterRCNN(tspec16, device="cpu").eval()
    tmodel16.load_state_dict(tmodel.state_dict())
    image, im_info = _chain_inputs(7, canvas)

    def jrun(m):
        return jax.tree_util.tree_map(
            np.asarray, jax.jit(m.apply)(params, image, im_info))

    j32, j16 = jrun(jmodel), jrun(jmodel16)
    with torch.no_grad():
        t32 = tmodel(_t(image), _t(im_info))
        t16 = tmodel16(_t(image), _t(im_info))
    for key in ("rpn_cls_score", "rpn_bbox_pred", "cls_score", "bbox_pred"):
        assert t16[key].dtype == torch.float32, key
    for key in ("rpn_cls_score", "rpn_bbox_pred"):
        port, ref = _rel_err(t16[key], t32[key]), _rel_err(j16[key], j32[key])
        assert 0 < port <= 4 * ref, (key, port, ref)

    # the RoI heads at the float32 forward's rois, in both dtypes
    rois, info = t32["rois"], _t(im_info)
    x = _t(image).permute(0, 3, 1, 2)
    with torch.no_grad():
        heads = [m._roi_heads(m.head(x.to(m.spec.dtype), info[:, :2]),
                              rois, info) for m in (tmodel, tmodel16)]
    jheads = [_jax_roi_heads(params["params"], image, rois.numpy(),
                             im_info, dt) for dt in (jnp.float32, jnp.bfloat16)]
    for i, key in enumerate(("cls_score", "bbox_pred")):
        _rel_close(heads[0][i].numpy(), jheads[0][i], 1e-4, key)
        port = _rel_err(heads[1][i], heads[0][i])
        ref = _rel_err(jheads[1][i], jheads[0][i])
        assert 0 < port <= 4 * ref, (key, port, ref)

    # the same bfloat16 RPN outputs into both proposal selections
    fg = _f32(jax.nn.softmax(j16["rpn_cls_score"], -1))[..., 1]
    fw = canvas[1] // 16
    want = jmodel16.apply({}, j16["anchors"], j16["rpn_bbox_pred"], fg,
                          im_info, fw, method=jnet.FasterRCNN._proposals)
    got = tmodel16._proposals(_t(j16["anchors"]), _t(j16["rpn_bbox_pred"]),
                              _t(fg), _t(im_info), fw)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=1e-6, atol=1e-4)


def _jax_roi_heads(p, image, rois, im_info, dtype):
    """The JAX package's head, crop, tail and class and box heads (the
    TEST forward's, un-normalized) at the given rois, in dtype; jitted."""
    from tf_faster_rcnn_tpu.models.resnet_v1 import ResNetV1Head

    def heads(p, image, rois, im_info):
        feats = ResNetV1Head(101, dtype=dtype).apply(
            {"params": p["head"]}, image.astype(dtype), im_info[:, :2])
        b, r = rois.shape[:2]
        pooled = jroi.roi_crop_pool(feats, rois, 16, 7, False,
                                    valid_hw=jnp.ceil(im_info[:, :2] / 16.0))
        fc7 = JResTail(101, dtype=dtype).apply(
            {"params": p["tail"]}, pooled.reshape(b * r, 7, 7, -1))

        def dense(name):
            k, bias = p[name]["kernel"], p[name]["bias"]
            y = fc7.astype(dtype) @ k.astype(dtype) + bias.astype(dtype)
            return y.astype(jnp.float32).reshape(b, r, -1)

        stds = jnp.tile(jnp.float32([0.1, 0.1, 0.2, 0.2]), 21)
        return dense("cls_score"), dense("bbox_pred") * stds

    return [np.asarray(x) for x in jax.jit(heads)(p, image, rois, im_info)]


# --- what reaches the NMS kernels ------------------------------------------

@pytest.mark.parametrize("backbone,mode,test_mode", [
    ("res50", "TEST", "nms"), ("vgg16", "TRAIN", "nms"),
    ("mobile", "TEST", "top")])
def test_bf16_paths_give_the_kernels_float32(monkeypatch, backbone, mode,
                                             test_mode):
    """Under COMPUTE_DTYPE bfloat16 every input of K1 and K2 is float32
    (the RPN outputs and heads are cast up before the proposals and the
    postprocess), so neither wrapper ever gets a bfloat16 tensor; K1 is not
    called in 'top' mode. A bfloat16 box makes the wrapper raise."""
    from tf_faster_rcnn_torch.engine import detect as tdetect
    from tf_faster_rcnn_torch.engine.test_engine import make_detect_fn
    from tf_faster_rcnn_torch.ops import nms as tnms
    from tf_faster_rcnn_torch.ops import nms_kernels as K
    seen = []

    def spy(name, fn):
        def call(boxes, valid, *args, **kwargs):
            seen.append((name, boxes.dtype))
            return fn(boxes, valid, *args, **kwargs)
        return call

    monkeypatch.setattr(tnms, "nms_keep_mask_batched",
                        spy("K1", K.nms_keep_mask_batched))
    monkeypatch.setattr(tdetect, "batched_nms_keep",
                        spy("K2", K.batched_nms_keep))
    spec = tnet.ModelSpec(
        backbone, 5, mode=mode, compute_dtype="bfloat16",
        test_mode=test_mode, rpn_top_n=16, anchor_scales=(2, 4),
        rpn_pre_nms_top_n=128, rpn_post_nms_top_n=16, pooling_size=3,
        depth_multiplier=0.25, roi_batch_size=8, rpn_batchsize=16)
    model = tnet.FasterRCNN(spec, device="cpu").eval()
    init_model(model, torch.Generator().manual_seed(0))
    image, im_info = (_t(x) for x in _chain_inputs(0, (64, 64)))
    if mode == "TRAIN":
        gt = torch.zeros(2, 3, 5)
        gt[:, 0] = torch.tensor([5.0, 5.0, 40.0, 40.0, 1.0])
        gv = torch.zeros(2, 3, dtype=torch.bool)
        gv[:, 0] = True
        model(image, im_info, gt, gv,
              generator=torch.Generator().manual_seed(0))
        want = {("K1", torch.float32)}
    else:
        make_detect_fn(model, spec)(image, im_info, im_info[:, :2])
        want = {("K2", torch.float32)} | (
            set() if test_mode == "top" else {("K1", torch.float32)})
    assert set(seen) == want
    with pytest.raises(TypeError, match="float32"):
        tnms.nms_keep_mask(torch.zeros(1, 4, 4, dtype=torch.bfloat16),
                           torch.ones(1, 4, dtype=torch.bool), 0.7)


@pytest.mark.parametrize("backbone", ["vgg16", "mobile"])
def test_chip_smoke_backbone_train_cfg_is_the_yaml(backbone):
    """chip_smoke.py's vgg16 and mobile train paths leave the port's cfg as
    experiments/cfgs/<backbone>.yml leaves it (the keys the spec and the
    train step read)."""
    import os.path as osp
    import chip_smoke
    from tf_faster_rcnn_torch import config as tcfg
    path = osp.join(osp.dirname(osp.dirname(osp.abspath(__file__))),
                    "experiments", "cfgs", backbone + ".yml")
    try:
        tcfg.cfg_from_file(path)
        want = tnet.spec_from_cfg(backbone, 21, "TRAIN")
        yaml_train = dict(tcfg.cfg.TRAIN)
        tcfg.reset_cfg()
        tcfg.cfg_from_list(chip_smoke.BACKBONE_TRAIN_CFG[backbone])
        assert tnet.spec_from_cfg(backbone, 21, "TRAIN") == want
        skip = ("DISPLAY", "SNAPSHOT_PREFIX")
        assert {k: v for k, v in tcfg.cfg.TRAIN.items() if k not in skip} \
            == {k: v for k, v in yaml_train.items() if k not in skip}
    finally:
        tcfg.reset_cfg()
