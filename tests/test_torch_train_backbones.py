"""The port's train step for vgg16 and MobileNet-v1, its bfloat16
parameters and MobileNet's weight decay, against the JAX package.

Tolerances: one vgg16 and one mobile (multiplier 0.25) train step from one
JAX TrainState carried across by the bridge, with the sampling noise and
the dropout keep masks JAX drew: sampled labels and valid masks exact, the
losses and updated parameters to 1e-4 relative to each tensor's largest
magnitude, the momentum to 1e-4 of the step's largest (as the res50 step of
tests/test_torch_train.py); the bfloat16 optimizer fed identical gradients
bit for bit equal to optax's, parameters and momentum, after two steps;
MobileNet's weight decay to 1e-6 relative.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_backbones import captured_dropout_masks
from test_torch_train import (  # noqa: F401 (two fixtures used here)
    SMALL_TRAIN, _assert_score_separation, _jax_noise, _rel_close, _t,
    _torch_batch, _train_inputs, _two_torch_threads, port_cfg)
from tf_faster_rcnn_tpu.config import cfg as jcfg
from tf_faster_rcnn_tpu.engine import losses as jlosses
from tf_faster_rcnn_tpu.engine import train as jtrain
from tf_faster_rcnn_tpu.models import network as jnet
from tf_faster_rcnn_torch.engine import losses as tlosses
from tf_faster_rcnn_torch.engine import train as ttrain
from tf_faster_rcnn_torch.models import network as tnet
from tf_faster_rcnn_torch.models.init import init_model, numpy_params
from tf_faster_rcnn_torch.utils.weights import (state_dict_from_flax,
                                                train_state_from_flax)

BACKBONE_KW = {"vgg16": dict(pooling_size=3),
               "mobile": dict(depth_multiplier=0.25)}


def _params(backbone, seed, mode, canvas=(128, 128), **kw):
    """Numpy-drawn params of the JAX detector and both specs."""
    kw = {**BACKBONE_KW[backbone], "anchor_scales": (2, 4), **kw}
    jspec = dataclasses.replace(jnet.spec_from_cfg(backbone, 21, mode), **kw)
    tspec = dataclasses.replace(tnet.spec_from_cfg(backbone, 21, mode), **kw)
    jmodel = jnet.FasterRCNN(jspec)
    h, w = canvas
    args = [jnp.zeros((1, h, w, 3)), jnp.array([[float(h), float(w), 1.0]])]
    if mode == "TRAIN":
        args += [jnp.zeros((1, 2, 5)), jnp.ones((1, 2), bool)]
    shapes = jax.eval_shape(
        jmodel.init, {"params": jax.random.PRNGKey(0),
                      "sampling": jax.random.PRNGKey(1),
                      "dropout": jax.random.PRNGKey(2)}, *args)
    return jspec, jmodel, numpy_params(shapes, seed), tspec


# --- one train step of vgg16 and of mobile ---------------------------------

# chosen so that the top fg scores are separated far beyond the two
# frameworks' float32 disagreement (asserted)
@pytest.mark.parametrize("backbone,seed", [("vgg16", 4), ("mobile", 1)])
def test_train_step_matches_make_train_step(port_cfg, backbone, seed):
    """vgg16 (fc6 on 3x3 crops) and mobile (multiplier 0.25) TRAIN at
    128x128, B = 2: one step of the port's train step against the JAX one
    from the same TrainState, with the sampler noise and (vgg16) the
    dropout keep masks that JAX drew: targets, losses, momentum and
    updated parameters; the frozen prefix (vgg16 conv1 and conv2, mobile
    layers 0-4) bitwise unchanged."""
    for c in (jcfg, port_cfg):
        c.TRAIN.LEARNING_RATE = 0.01
    image, im_info, gt, gtv = _train_inputs(np.random.RandomState(seed))
    jspec, jmodel, params, tspec = _params(backbone, seed, "TRAIN",
                                           **SMALL_TRAIN)
    jstate = jtrain.create_train_state(jspec, params,
                                       jax.random.PRNGKey(seed), 2)
    jstep = jtrain.make_train_step(jmodel, jspec, weight_decay=1e-4,
                                   mobile_weight_decay=4e-5, donate=False,
                                   nan_guard=True)
    tmodel = tnet.FasterRCNN(tspec, device="cpu")
    tstate = ttrain.create_train_state(tspec, tmodel, torch.Generator(), 2)
    tstate.load_state_dict(train_state_from_flax(jstate))
    tstep = ttrain.make_train_step(tmodel, tspec, weight_decay=1e-4,
                                   mobile_weight_decay=4e-5, nan_guard=True)
    batch = _torch_batch(image, im_info, gt, gtv)
    frozen = {k: p.detach().clone() for k, p in tmodel.named_parameters()
              if not p.requires_grad}
    assert frozen

    n_anchors = (128 // 16) ** 2 * tspec.num_anchors
    key, noise = _jax_noise(jmodel, jstate.key, 2, n_anchors,
                            tspec.rpn_post_nms_top_n)
    rngs = {"sampling": key, "dropout": jax.random.fold_in(key, 1)}
    masks = captured_dropout_masks(lambda p: jmodel.apply(
        p, image, im_info, gt, gtv, rngs=rngs), jstate.params)
    if backbone == "vgg16":
        rows = 2 * tspec.roi_batch_size
        assert [m.shape for m in masks] == [(rows, 4096)] * 2
        noise = noise._replace(dropout=tuple(_t(m) for m in masks))
    else:
        assert not masks
    jout = jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda p: jmodel.apply(p, image, im_info, gt, gtv, rngs=rngs))(
            jstate.params))
    with torch.no_grad():
        tout = tmodel(*batch.values(), noise=noise)
    _assert_score_separation(jout, tout, tspec.rpn_post_nms_top_n)
    for name in ("anchor_targets", "proposal_targets"):
        np.testing.assert_array_equal(tout[name].labels.numpy(),
                                      jout[name].labels, err_msg=name)
    np.testing.assert_array_equal(tout["roi_valid"].numpy(),
                                  jout["roi_valid"])
    assert (jout["proposal_targets"].labels > 0).sum() > 0
    for key_ in ("cls_score", "bbox_pred"):
        _rel_close(tout[key_].numpy(), jout[key_], 1e-4, key_)

    jstate, jm = jstep(jstate, {"image": image, "im_info": im_info,
                                "gt_boxes": gt, "gt_valid": gtv})
    tstate, tm = tstep(tstate, batch, noise=noise)
    for name, value in jm.items():
        _rel_close(tm[name].numpy(), value, 1e-4, name)
    assert float(tm["step_skipped"]) == 0.0
    want = train_state_from_flax(jstate)
    for name, p in tmodel.named_parameters():
        _rel_close(p.detach().numpy(), want["params"][name].numpy(), 1e-4,
                   name)
        if name in frozen:
            assert torch.equal(p, frozen[name]), name
    scale = max(float(np.abs(want["trace"][k].numpy()).max())
                for k in tstate.trace)
    for name, t in tstate.trace.items():
        err = float(np.abs(t.numpy() - want["trace"][name].numpy()).max())
        assert err <= 1e-4 * scale, (name, err / scale)


def test_vgg16_train_forward_draws_dropout_masks():
    """Without noise the vgg16 TRAIN forward draws the keep masks from the
    generator (about half kept); given noise without them, it raises."""
    spec = dataclasses.replace(tnet.spec_from_cfg("vgg16", 5, "TRAIN"),
                               **BACKBONE_KW["vgg16"], **SMALL_TRAIN)
    model = tnet.FasterRCNN(spec, device="cpu")
    init_model(model, torch.Generator().manual_seed(0))
    batch = _torch_batch(*_train_inputs(np.random.RandomState(0)))
    n_anchors = 8 * 8 * spec.num_anchors
    noise = tnet.draw_noise(torch.Generator().manual_seed(1), 2, n_anchors,
                            spec.rpn_post_nms_top_n, "cpu",
                            2 * spec.roi_batch_size)
    assert [k.shape for k in noise.dropout] == [(64, 4096)] * 2
    assert 0.45 < float(noise.dropout[0].float().mean()) < 0.55
    with torch.no_grad():
        a = model(*batch.values(), noise=noise)["cls_score"]
        b = model(*batch.values(), noise=noise._replace(
            dropout=tuple(~k for k in noise.dropout)))["cls_score"]
        model(*batch.values(), generator=torch.Generator().manual_seed(2))
        assert not torch.equal(a, b)
        with pytest.raises(ValueError, match="dropout"):
            model(*batch.values(), noise=noise._replace(dropout=None))


# --- bfloat16 parameters ---------------------------------------------------

def _toy_params(rng):
    return {"params": {
        "rpn_conv": {"kernel": rng.randn(3, 3, 2, 4).astype(np.float32),
                     "bias": rng.randn(4).astype(np.float32)},
        "cls_score": {"kernel": rng.randn(8, 3).astype(np.float32) * 1e-2,
                      "bias": rng.randn(3).astype(np.float32)}}}


@pytest.mark.parametrize("double_bias", [False, True])
def test_bf16_optimizer_matches_optax_bit_for_bit(rng, double_bias):
    """PARAM_DTYPE bfloat16: parameters, gradients and momentum in
    bfloat16. optax 0.2's chain rounds at each step: the Python momentum
    to bfloat16 (0.8984375) in trace, the float32 step size to the
    gradient's dtype in scale_by_schedule, the sum in apply_updates. Two
    steps with identical bfloat16 gradients, across a gamma boundary: the
    port's parameters and momentum equal optax's bit for bit."""
    params = jax.tree_util.tree_map(lambda x: jnp.asarray(x, jnp.bfloat16),
                                    _toy_params(rng))
    spec = jnet.spec_from_cfg("res50", 3, "TRAIN")
    tx = jtrain.make_optimizer(spec, params, learning_rate=0.037,
                               momentum=0.9, gamma=0.1, stepsizes=[1],
                               double_bias=double_bias)
    jstate = jtrain.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                               opt_state=tx.init(params),
                               key=jax.random.PRNGKey(0), tx=tx)
    opt = ttrain.Optimizer(ttrain.lr_schedule(0.037, 0.1, [1]), 0.9,
                           double_bias)
    tparams = {k: v.to(torch.bfloat16)
               for k, v in state_dict_from_flax(params).items()}
    trace = {k: torch.zeros_like(v) for k, v in tparams.items()}
    count = torch.zeros((), dtype=torch.int64)
    for _ in range(2):
        grads = jax.tree_util.tree_map(
            lambda x: jnp.asarray(rng.randn(*x.shape), jnp.bfloat16), params)
        jstate = jstate.apply_gradients(grads)
        tgrads = {k: v.to(torch.bfloat16)
                  for k, v in state_dict_from_flax(grads).items()}
        opt.apply(tparams, tgrads, trace, count)
    want = train_state_from_flax(jstate)
    leaves = jax.tree_util.tree_leaves(jstate.opt_state)
    assert {str(x.dtype) for x in leaves if x.ndim} == {"bfloat16"}
    for k in tparams:
        assert tparams[k].dtype == trace[k].dtype == torch.bfloat16
        np.testing.assert_array_equal(tparams[k].float().numpy(),
                                      want["params"][k].numpy(), err_msg=k)
        np.testing.assert_array_equal(trace[k].float().numpy(),
                                      want["trace"][k].numpy(), err_msg=k)


def test_bf16_updates_below_a_256th_round_away():
    """An update of 1/1024 of the weight leaves it unchanged (ROADMAP's
    bfloat16 parameter study: below ~1/256 rounds away), 1/100 moves it."""
    opt = ttrain.Optimizer(ttrain.lr_schedule(1.0, 0.1, [100]), 0.0, False)
    p = {"w.weight": torch.ones(2, dtype=torch.bfloat16)}
    trace = {"w.weight": torch.zeros(2, dtype=torch.bfloat16)}
    g = {"w.weight": torch.tensor([1.0 / 1024, 1.0 / 100],
                                  dtype=torch.bfloat16)}
    opt.apply(p, g, trace, torch.zeros((), dtype=torch.int64))
    assert float(p["w.weight"][0]) == 1.0
    assert float(p["w.weight"][1]) < 1.0


def test_create_train_state_casts_to_param_dtype(port_cfg):
    """PARAM_DTYPE bfloat16 casts every parameter and FrozenBN buffer, as
    the JAX package casts its whole params tree; the momentum follows; a
    step under COMPUTE_DTYPE float32 (the weights cast up at each conv)
    updates them in bfloat16."""
    port_cfg.TPU.PARAM_DTYPE = "bfloat16"
    spec = dataclasses.replace(tnet.spec_from_cfg("res50", 21, "TRAIN"),
                               **SMALL_TRAIN)
    assert spec.compute_dtype == "float32"
    model = tnet.FasterRCNN(spec, device="cpu")
    init_model(model, torch.Generator().manual_seed(0))
    state = ttrain.create_train_state(spec, model,
                                      torch.Generator().manual_seed(0), 2)
    assert {t.dtype for t in model.state_dict().values()} == {torch.bfloat16}
    assert {t.dtype for t in state.trace.values()} == {torch.bfloat16}
    step = ttrain.make_train_step(model, spec, weight_decay=1e-4,
                                  nan_guard=True)
    before = model.rpn_conv.weight.detach().clone()
    state, m = step(state, _torch_batch(*_train_inputs(
        np.random.RandomState(0))))
    assert float(m["step_skipped"]) == 0.0
    assert np.isfinite(float(m["total_loss"]))
    assert model.rpn_conv.weight.dtype == torch.bfloat16
    assert not torch.equal(model.rpn_conv.weight, before)


# --- MobileNet's weight decay ----------------------------------------------

@pytest.mark.parametrize("regu_depth", [False, True])
def test_mobile_weight_decay_matches(regu_depth):
    """MOBILENET.WEIGHT_DECAY on the head's and tail's kernels, depthwise
    ones only under REGU_DEPTH; TRAIN.WEIGHT_DECAY on the RPN and the
    heads; BN never."""
    jcfg.MOBILENET.REGU_DEPTH = regu_depth
    _, _, params, tspec = _params("mobile", 3, "TEST", (64, 64))
    model = tnet.FasterRCNN(tspec, device="cpu")
    model.load_state_dict(state_dict_from_flax(params), strict=True)
    want = float(jlosses.weight_decay_loss(params["params"], 1e-4, 4e-5,
                                           "mobile"))
    with torch.no_grad():
        got = float(tlosses.weight_decay_loss(
            model, 1e-4, mobile_weight_decay=4e-5, regu_depth=regu_depth))
        depthwise = sum(float(p.double().square().sum())
                        for n, p in model.named_parameters()
                        if ".depthwise." in n)
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert depthwise > 0
    if not regu_depth:
        with torch.no_grad():
            with_depth = float(tlosses.weight_decay_loss(
                model, 1e-4, mobile_weight_decay=4e-5, regu_depth=True))
        np.testing.assert_allclose(with_depth - got,
                                   4e-5 * 0.5 * depthwise, rtol=1e-4)
    with pytest.raises(ValueError, match="mobile_weight_decay"):
        tlosses.weight_decay_loss(model, 1e-4)
