"""The port's ResNet layers, head and tail, its model spec and its own cfg
copy, against the JAX package.

Parameters are drawn with numpy by the port's init recipe
(tf_faster_rcnn_torch/models/init.py::numpy_params), which replaces the
flax init's zero expand convs, and reach the port through the weight bridge.
Tolerance: 1e-4 relative to the largest magnitude, in float32 (the two
frameworks sum the convolutions in different orders); the valid masks and
the bridge's key set are exact.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tf_faster_rcnn_tpu.models import layers as jlayers
from tf_faster_rcnn_tpu.models import network as jnet
from tf_faster_rcnn_tpu.models import resnet_v1 as jres
from tf_faster_rcnn_torch.models import layers as tlayers
from tf_faster_rcnn_torch.models import network as tnet
from tf_faster_rcnn_torch.models import resnet_v1 as tres
from tf_faster_rcnn_torch.models.init import init_model, numpy_params
from tf_faster_rcnn_torch.utils.weights import state_dict_from_flax


def _rel_close(got, want, tol=1e-4):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = float(np.abs(got - want).max()) / float(np.abs(want).max())
    assert err <= tol, f"max error {err:.3g} relative to max > {tol}"


def _nchw(x):
    return torch.from_numpy(np.asarray(x)).permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1).detach().numpy()


def _bridge(module, params):
    module.load_state_dict(state_dict_from_flax(params), strict=True)
    return module.eval()


@pytest.mark.parametrize("kernel,stride", [(1, 1), (1, 2), (3, 1), (3, 2),
                                           (7, 2)])
def test_conv_same_matches(rng, kernel, stride):
    x = rng.randn(2, 13, 10, 5).astype(np.float32)
    jconv = jlayers.ConvSame(4, kernel, stride)
    params = numpy_params(
        jax.eval_shape(jconv.init, jax.random.PRNGKey(0), x)["params"], 1)
    tconv = _bridge(tlayers.ConvSame(5, 4, kernel, stride), params)
    want = jconv.apply({"params": params}, x)
    _rel_close(_nhwc(tconv(_nchw(x))), want)


def test_frozen_bn_matches(rng):
    x = rng.randn(2, 4, 6, 8).astype(np.float32) * 3
    params = {"mean": rng.randn(8), "var": rng.uniform(0.2, 2, 8),
              "scale": rng.randn(8), "bias": rng.randn(8)}
    params = {k: v.astype(np.float32) for k, v in params.items()}
    bn = tlayers.FrozenBatchNorm(8)
    for k, v in params.items():
        getattr(bn, k).copy_(torch.from_numpy(v))
    want = jlayers.FrozenBatchNorm().apply({"params": params}, x)
    _rel_close(_nhwc(bn(_nchw(x))), want, 1e-6)


def test_mask_and_shrink_valid_match(rng):
    x = rng.randn(3, 9, 12, 2).astype(np.float32)
    valid = np.array([[9, 12], [5, 7], [1, 12]], np.float32)
    np.testing.assert_array_equal(
        _nhwc(tlayers.mask_valid(_nchw(x), torch.from_numpy(valid))),
        np.asarray(jlayers.mask_valid(x, valid)))
    v = np.array([[600, 1000], [375, 499], [1, 1]], np.float32)
    for s in (1, 2, 16):
        np.testing.assert_array_equal(
            tlayers.shrink_valid(torch.from_numpy(v), s).numpy(),
            np.asarray(jlayers.shrink_valid(v, s)))


def _head_inputs(rng):
    x = (rng.randn(2, 64, 96, 3) * 60).astype(np.float32)
    valid = np.array([[64, 96], [50, 71]], np.float32)
    return x, valid


@pytest.mark.parametrize("depth", [50, 101])
def test_head_matches(rng, depth):
    x, valid = _head_inputs(rng)
    jhead = jres.ResNetV1Head(depth)
    params = numpy_params(jax.eval_shape(
        jhead.init, jax.random.PRNGKey(0), x, valid)["params"], depth)
    thead = _bridge(tres.ResNetV1Head(depth), params)
    want = jax.jit(jhead.apply)({"params": params}, x, valid)
    with torch.no_grad():
        got = thead(_nchw(x), torch.from_numpy(valid))
    assert got.shape == (2, 1024, 4, 6)
    _rel_close(_nhwc(got), want)


@pytest.mark.parametrize("depth", [50, 101])
def test_tail_matches(rng, depth):
    pooled = np.abs(rng.randn(6, 7, 7, 1024)).astype(np.float32)
    jtail = jres.ResNetV1Tail(depth)
    params = numpy_params(jax.eval_shape(
        jtail.init, jax.random.PRNGKey(0), pooled)["params"], depth)
    ttail = _bridge(tres.ResNetV1Tail(depth), params)
    want = jax.jit(jtail.apply)({"params": params}, pooled)
    with torch.no_grad():
        got = ttail(torch.from_numpy(pooled))       # NHWC, as cropped
    assert got.shape == (6, 2048)
    _rel_close(got.numpy(), want)


def _small_spec(backbone, num_classes=21):
    return dataclasses.replace(
        tnet.spec_from_cfg(backbone, num_classes, "TEST"),
        anchor_scales=(2, 4), rpn_pre_nms_top_n=256, rpn_post_nms_top_n=16)


@pytest.mark.parametrize("backbone", ["res50", "res101", "res152", "vgg16",
                                      "mobile"])
def test_bridge_fills_every_tensor(backbone):
    """The flax tree of the whole detector maps one to one onto the port's
    state_dict: same keys, same shapes (vgg16's fc6 at the full 7x7x512,
    mobile's depthwise kernels)."""
    spec = _small_spec(backbone)
    jspec = dataclasses.replace(jnet.spec_from_cfg(backbone, 21, "TEST"),
                                anchor_scales=(2, 4))
    shapes = jax.eval_shape(jnet.FasterRCNN(jspec).init,
                            jax.random.PRNGKey(0),
                            jnp.zeros((1, 64, 64, 3)),
                            jnp.array([[64.0, 64.0, 1.0]]))
    sd = state_dict_from_flax(numpy_params(shapes, 0))
    model = tnet.FasterRCNN(spec, device="cpu")
    want = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert {k: tuple(v.shape) for k, v in sd.items()} == want
    model.load_state_dict(sd, strict=True)


def test_seeded_init_is_nonzero_and_keeps_activations_order_one():
    spec = _small_spec("res101")
    model = tnet.FasterRCNN(spec, device="cpu").eval()
    init_model(model, torch.Generator().manual_seed(0))
    for name, t in model.state_dict().items():
        assert float(t.abs().max()) > 0, name
    again = tnet.FasterRCNN(spec, device="cpu")
    init_model(again, torch.Generator().manual_seed(0))
    for (name, a), b in zip(model.state_dict().items(),
                            again.state_dict().values()):
        assert torch.equal(a, b), name
    x = torch.from_numpy(
        (np.random.RandomState(0).randn(1, 3, 64, 96) * 60).astype(np.float32))
    with torch.no_grad():
        feat = model.head(x)
    rms = float(feat.pow(2).mean().sqrt())
    assert 0.05 < rms < 50, rms


def test_canvas_invariance_nonzero_bn(rng):
    """The same image on two canvases gives the same proposals, scores and
    box deltas: masking keeps the padded margin out (BN shifts nonzero)."""
    spec = _small_spec("res50", 6)
    model = tnet.FasterRCNN(spec, device="cpu").eval()
    init_model(model, torch.Generator().manual_seed(1))
    content = (rng.randn(60, 90, 3) * 40).astype(np.float32)
    im_info = torch.tensor([[60.0, 90.0, 1.0]])
    outs = []
    for ch, cw in ((64, 96), (96, 128)):
        canvas = np.zeros((1, ch, cw, 3), np.float32)
        canvas[0, :60, :90] = content
        with torch.no_grad():
            outs.append(model(torch.from_numpy(canvas), im_info))
    a, b = outs
    assert torch.equal(a["roi_valid"], b["roi_valid"])
    assert int(a["roi_valid"].sum()) > 0
    for key in ("rois", "cls_prob", "bbox_pred"):
        np.testing.assert_allclose(b[key].numpy(), a[key].numpy(),
                                   rtol=1e-4, atol=1e-4, err_msg=key)


@pytest.mark.parametrize("backbone", ["vgg16", "mobile"])
def test_unported_backbones_raise(backbone):
    """The last two backbones are ported: each builds, with its head's and
    tail's widths on the RPN and the heads; an unknown backbone raises."""
    spec = dataclasses.replace(_small_spec("res101"), backbone=backbone)
    model = tnet.FasterRCNN(spec, device="cpu")
    widths = {"vgg16": (512, 4096), "mobile": (512, 1024)}[backbone]
    assert (model.rpn_conv.in_channels, model.cls_score.in_features) == widths
    with pytest.raises(ValueError, match="backbone"):
        tnet.FasterRCNN(dataclasses.replace(spec, backbone="res34"),
                        device="cpu")


def test_spec_defaults_are_the_cfg_defaults():
    """A ModelSpec built without cfg (as chip_smoke.py builds it) is the one
    spec_from_cfg snapshots from the default cfg."""
    assert tnet.spec_from_cfg("res101", 21, "TEST") == tnet.ModelSpec(
        "res101", 21)


def _common_fields(port, ref):
    """The fields both specs have, but the three the port adds."""
    names = {f.name for f in dataclasses.fields(ref)}
    return {f.name: (getattr(port, f.name), getattr(ref, f.name))
            for f in dataclasses.fields(port) if f.name in names}


def _assert_same_spec(port, ref):
    for name, (got, want) in _common_fields(port, ref).items():
        assert got == want, (name, got, want)


def test_spec_from_cfg_raises_on_train_and_unported_backbones():
    """TRAIN builds, with the TRAIN phase's proposal counts; every backbone
    builds in either mode, and bf16 parameters too, each with the JAX
    package's spec; the model builds from each."""
    from tf_faster_rcnn_tpu.config import cfg as jcfg
    from tf_faster_rcnn_torch.config import cfg, reset_cfg
    spec = tnet.spec_from_cfg("res101", 21, "TRAIN")
    assert spec.mode == "TRAIN"
    assert (spec.rpn_pre_nms_top_n, spec.rpn_post_nms_top_n) == (12000, 2000)
    assert spec == dataclasses.replace(
        tnet.ModelSpec("res101", 21), mode="TRAIN", rpn_pre_nms_top_n=12000,
        rpn_post_nms_top_n=2000)
    for backbone in ("vgg16", "mobile"):
        for mode in ("TRAIN", "TEST"):
            _assert_same_spec(tnet.spec_from_cfg(backbone, 21, mode),
                              jnet.spec_from_cfg(backbone, 21, mode))
    cfg.TPU.PARAM_DTYPE = jcfg.TPU.PARAM_DTYPE = "bfloat16"
    try:
        port = tnet.spec_from_cfg("res101", 21, "TRAIN")
        _assert_same_spec(port, jnet.spec_from_cfg("res101", 21, "TRAIN"))
        tnet.FasterRCNN(dataclasses.replace(port, anchor_scales=(2,)),
                        device="cpu")
    finally:
        reset_cfg()


@pytest.mark.parametrize("section,key,value", [
    ("TEST", "MODE", "top"), ("TPU", "SPACE_TO_DEPTH", True),
    ("TPU", "COMPUTE_DTYPE", "bfloat16"), ("TPU", "PARAM_DTYPE", "bfloat16")])
def test_spec_from_cfg_raises_on_unported_cfg(section, key, value):
    """The 'top' proposals, bf16 compute and bf16 parameters are ported:
    the spec builds with the JAX package's fields, for every backbone in
    both modes, and so does the model. The s2d stem, a TPU workaround,
    still raises."""
    from tf_faster_rcnn_tpu.config import cfg as jcfg
    from tf_faster_rcnn_torch.config import cfg, reset_cfg
    cfg[section][key] = jcfg[section][key] = value
    try:
        if key == "SPACE_TO_DEPTH":
            with pytest.raises(NotImplementedError):
                tnet.spec_from_cfg("res101", 21, "TEST")
            return
        for backbone in ("vgg16", "res50", "res101", "res152", "mobile"):
            for mode in ("TEST", "TRAIN"):
                port = tnet.spec_from_cfg(backbone, 21, mode)
                _assert_same_spec(port,
                                  jnet.spec_from_cfg(backbone, 21, mode))
                tnet.FasterRCNN(dataclasses.replace(
                    port, anchor_scales=(2,), pooling_size=2),
                    device="cpu")
    finally:
        reset_cfg()


def _same_tree(port, ref, path=""):
    """Every key of the port's tree is in the reference's, with an equal
    value of the same type (each package has its own AttrDict)."""
    for key, value in port.items():
        assert key in ref, path + key
        want = ref[key]
        if isinstance(value, dict):
            assert isinstance(want, dict), path + key
            _same_tree(value, want, path + key + ".")
            continue
        assert type(value) is type(want), (path + key, value, want)
        if isinstance(value, np.ndarray):
            assert value.dtype == want.dtype, path + key
            np.testing.assert_array_equal(value, want, err_msg=path + key)
        else:
            assert value == want, (path + key, value, want)


def test_port_cfg_defaults_are_the_reference_defaults():
    """The port's own copy of the default cfg equals the JAX package's at
    every key it copies, and the two merge a YAML override alike."""
    from tf_faster_rcnn_torch import config as tcfg
    from tf_faster_rcnn_tpu import config as jcfg
    tcfg.reset_cfg()
    _same_tree(tcfg.cfg, jcfg.cfg)
    args = ["TEST.RPN_POST_NMS_TOP_N", "100", "TEST.NMS", "0.4",
            "ANCHOR_SCALES", "[4, 8, 16, 32]", "TPU.RPN_NMS_CAP", "64"]
    try:
        tcfg.cfg_from_list(args)
        jcfg.cfg_from_list(args)
        _same_tree(tcfg.cfg, jcfg.cfg)
    finally:
        tcfg.reset_cfg()


@pytest.mark.parametrize("name", ["res101", "res101-lg", "res50", "vgg16",
                                  "mobile", "mobile-lg"])
def test_port_cfg_from_file_matches_the_reference(name):
    """Each of the repo's experiment YAMLs merges into the port's cfg as it
    merges into the JAX package's."""
    import os.path as osp
    from tf_faster_rcnn_torch import config as tcfg
    from tf_faster_rcnn_tpu import config as jcfg
    path = osp.join(osp.dirname(osp.dirname(osp.abspath(__file__))),
                    "experiments", "cfgs", name + ".yml")
    try:
        tcfg.cfg_from_file(path)
        jcfg.cfg_from_file(path)
        _same_tree(tcfg.cfg, jcfg.cfg)
    finally:
        tcfg.reset_cfg()


def test_model_builds_on_the_card_by_default():
    """FasterRCNN(spec) builds on the CUDA device and raises where there is
    none; device='cpu' builds on the CPU."""
    spec = _small_spec("res50", 4)
    if torch.cuda.is_available():
        model = tnet.FasterRCNN(spec)
        assert next(model.parameters()).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tnet.FasterRCNN(spec)
    model = tnet.FasterRCNN(spec, device="cpu")
    assert {p.device.type for p in model.parameters()} == {"cpu"}


@pytest.mark.parametrize("name", ["res101", "res50"])
def test_train_spec_matches_the_reference_spec(name):
    """spec_from_cfg(..., "TRAIN") after an experiment YAML snapshots the
    same TRAIN fields as the JAX package's ModelSpec."""
    import os.path as osp
    from tf_faster_rcnn_torch import config as tcfg
    from tf_faster_rcnn_tpu import config as jcfg
    path = osp.join(osp.dirname(osp.dirname(osp.abspath(__file__))),
                    "experiments", "cfgs", name + ".yml")
    try:
        tcfg.cfg_from_file(path)
        jcfg.cfg_from_file(path)
        port = tnet.spec_from_cfg(name, 21, "TRAIN")
        ref = jnet.spec_from_cfg(name, 21, "TRAIN")
    finally:
        tcfg.reset_cfg()
    _assert_same_spec(port, ref)
