"""The port's losses, weight decay, optimizer, freeze rules, NaN guard and
whole train step against the JAX package.

Tolerances: the losses and weight decay on random inputs to 1e-6 relative;
the optimizer's parameters and momentum, and the learning rate, to 1e-6
relative (the same float32 operations in the same order); the whole res50
train step to 1e-4 relative to each tensor's largest magnitude (float32
convolutions summed in different orders, through two steps), with the
sampled labels and valid masks exactly equal and the frozen prefix's
gradients exactly zero.

The JAX step draws its sampling noise from ``state.key``; the test
reproduces that derivation (``split(state.key)``, flax's ``make_rng``,
``split(rng, 2B)``, then each sampler's fg/bg split) and passes the same
noise to the port.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tf_faster_rcnn_tpu.config import cfg as jcfg
from tf_faster_rcnn_tpu.engine import losses as jlosses
from tf_faster_rcnn_tpu.engine import train as jtrain
from tf_faster_rcnn_tpu.models import network as jnet
from tf_faster_rcnn_tpu.models import targets as jtargets
from tf_faster_rcnn_torch import config as tconfig
from tf_faster_rcnn_torch.engine import losses as tlosses
from tf_faster_rcnn_torch.engine import train as ttrain
from tf_faster_rcnn_torch.models import network as tnet
from tf_faster_rcnn_torch.models import targets as ttargets
from tf_faster_rcnn_torch.models.init import init_model, numpy_params
from tf_faster_rcnn_torch.utils.weights import (state_dict_from_flax,
                                                train_state_from_flax)

SMALL_TRAIN = dict(anchor_scales=(2, 4), rpn_pre_nms_top_n=512,
                   rpn_post_nms_top_n=64, roi_batch_size=32,
                   rpn_batchsize=64)


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two intra-op threads: the suite runs several workers on the host's
    cores; these small tensors gain little from more threads, and more
    spin-waiting threads slow every worker."""
    before = torch.get_num_threads()
    torch.set_num_threads(min(before, 2))
    yield
    torch.set_num_threads(before)


@pytest.fixture
def port_cfg():
    """The port's cfg, reset after the test (the conftest resets only the
    JAX package's)."""
    tconfig.reset_cfg()
    yield tconfig.cfg
    tconfig.reset_cfg()


def _t(x):
    return torch.from_numpy(np.array(x))


def _rel_close(got, want, tol, name=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max()) / scale
    assert err <= tol, f"{name}: max error {err:.3g} relative to max > {tol}"


# --- losses ----------------------------------------------------------------

def _loss_inputs(rng, b=2, n=300, s=16, k=5):
    labels = rng.choice([-1, -1, 0, 1], (b, n)).astype(np.int32)
    at = [labels, rng.randn(b, n, 4), rng.rand(b, n, 4) > 0.5,
          rng.rand(b, n, 4) / n]
    pt_labels = rng.randint(0, k, (b, s)).astype(np.int32)
    valid = np.ones((b, s), bool)
    valid[1, s // 2:] = False
    pt = [rng.uniform(0, 100, (b, s, 4)), pt_labels, rng.randn(b, s, 4 * k),
          rng.rand(b, s, 4 * k) > 0.7, rng.rand(b, s, 4 * k) > 0.7, valid]
    preds = {"rpn_cls_score": rng.randn(b, n, 2) * 3,
             "rpn_bbox_pred": rng.randn(b, n, 4),
             "cls_score": rng.randn(b, s, k) * 3,
             # some deltas within 1/sigma^2 of the target: both branches
             "bbox_pred": pt[2] + rng.randn(b, s, 4 * k) * 0.5}

    def f32(x):
        return x.astype(np.float32) if x.dtype.kind in "fb" else x

    at, pt = [f32(np.asarray(x)) for x in at], [f32(np.asarray(x)) for x in pt]
    preds = {key: f32(v) for key, v in preds.items()}
    jpreds = dict(preds, anchor_targets=jtargets.AnchorTargets(*at),
                  proposal_targets=jtargets.ProposalTargets(*pt))
    tat = [_t(x) for x in at]
    tat[0] = tat[0].long()
    tpt = [_t(x) for x in pt]
    tpt[1] = tpt[1].long()
    tpt[5] = tpt[5].bool()
    tpreds = {key: _t(v) for key, v in preds.items()}
    tpreds.update(anchor_targets=ttargets.AnchorTargets(*tat),
                  proposal_targets=ttargets.ProposalTargets(*tpt))
    return jpreds, tpreds


@pytest.mark.parametrize("case", ["mixed", "rpn all ignored",
                                  "rois all invalid"])
def test_detection_losses_match(rng, case):
    jpreds, tpreds = _loss_inputs(rng)
    if case == "rpn all ignored":       # the max(sum(mask), 1) denominator
        jpreds["anchor_targets"] = jpreds["anchor_targets"]._replace(
            labels=np.full((2, 300), -1, np.int32))
        tpreds["anchor_targets"] = tpreds["anchor_targets"]._replace(
            labels=torch.full((2, 300), -1))
    if case == "rois all invalid":
        jpreds["proposal_targets"] = jpreds["proposal_targets"]._replace(
            valid=np.zeros((2, 16), bool))
        tpreds["proposal_targets"] = tpreds["proposal_targets"]._replace(
            valid=torch.zeros(2, 16, dtype=torch.bool))
    want = jlosses.detection_losses(jpreds, None)
    got = tlosses.detection_losses(tpreds)
    assert set(got) == set(want)
    for key in want:
        _rel_close(got[key].numpy(), want[key], 1e-6, key)
    if case == "rpn all ignored":
        assert float(got["rpn_cross_entropy"]) == 0.0


@pytest.mark.parametrize("sigma,dims", [(3.0, (1, 2)), (1.0, (2,))])
def test_smooth_l1_loss_and_its_gradient_match(rng, sigma, dims):
    pred, target = rng.randn(2, 40, 8), rng.randn(2, 40, 8)
    pred[0, :10] = target[0, :10] + 0.01        # the quadratic branch
    iw, ow = rng.rand(2, 40, 8), rng.rand(2, 40, 8)
    args = [x.astype(np.float32) for x in (pred, target, iw, ow)]

    def jloss(p):
        return jlosses.smooth_l1_loss(p, *args[1:], sigma, dims)

    want, want_grad = jax.value_and_grad(jloss)(args[0])
    p = _t(args[0]).requires_grad_(True)
    rows = int(np.prod([n for d, n in enumerate(pred.shape)
                        if d not in dims]))
    got = tlosses.smooth_l1_loss(p, *[_t(x) for x in args[1:]], sigma, rows)
    (grad,) = torch.autograd.grad(got, p)
    _rel_close(got.detach().numpy(), want, 1e-6)
    _rel_close(grad.numpy(), want_grad, 1e-6)


def _res50_params(seed, mode="TEST", canvas=(64, 64), **kw):
    """Numpy-drawn params of the JAX res50 detector and both specs."""
    kw = dict({"anchor_scales": (2, 4)}, **kw)
    jspec = dataclasses.replace(jnet.spec_from_cfg("res50", 21, mode), **kw)
    tspec = dataclasses.replace(tnet.spec_from_cfg("res50", 21, mode), **kw)
    jmodel = jnet.FasterRCNN(jspec)
    h, w = canvas
    args = [jnp.zeros((1, h, w, 3)), jnp.array([[float(h), float(w), 1.0]])]
    if mode == "TRAIN":
        args += [jnp.zeros((1, 2, 5)), jnp.ones((1, 2), bool)]
    shapes = jax.eval_shape(
        jmodel.init, {"params": jax.random.PRNGKey(0),
                      "sampling": jax.random.PRNGKey(1)}, *args)
    return jspec, jmodel, numpy_params(shapes, seed), tspec


@pytest.mark.parametrize("bias_decay", [False, True])
def test_weight_decay_loss_matches(bias_decay):
    """Every conv and Dense kernel counts, frozen ones included; BN never.
    Under BIAS_DECAY the JAX function also counts FrozenBN's bias (a frozen
    array, so training is unaffected, only the reported loss): the port
    leaves it out, as the reference's slim batch_norm does (ROADMAP Queue
    C), and the difference is exactly those terms."""
    _, _, params, tspec = _res50_params(3)
    model = tnet.FasterRCNN(tspec, device="cpu")
    model.load_state_dict(state_dict_from_flax(params), strict=True)
    want = float(jlosses.weight_decay_loss(params["params"], 1e-4, 4e-5,
                                           "res50", bias_decay=bias_decay))
    with torch.no_grad():
        got = float(tlosses.weight_decay_loss(model, 1e-4, bias_decay))
    if bias_decay:
        bn_bias = sum(float(v.double().square().sum())
                      for k, v in model.state_dict().items()
                      if k.endswith("bn.bias"))
        assert bn_bias > 0
        want -= 1e-4 * 0.5 * bn_bias
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert got > 0


# --- freeze rules ----------------------------------------------------------

@pytest.mark.parametrize("fixed_blocks", [1, 3])
def test_trainable_mask_matches(fixed_blocks):
    """The port's trainable parameters are the JAX mask's True leaves; the
    mask's BN leaves are the port's buffers."""
    jcfg.RESNET.FIXED_BLOCKS = fixed_blocks
    jspec, _, params, tspec = _res50_params(0)
    tspec = dataclasses.replace(tspec, fixed_blocks=fixed_blocks)
    model = tnet.FasterRCNN(tspec, device="cpu")
    mask = state_dict_from_flax(jax.tree_util.tree_map(
        lambda m, p: np.full(p.shape, m, np.float32),
        jnet.trainable_mask(params, jspec), params))
    mask = {k: bool(v.all()) for k, v in mask.items()}
    port = tnet.trainable_mask(model)
    buffers = {k for k, _ in model.named_buffers()}
    assert set(port) == set(mask) - buffers
    for name in buffers:
        assert not mask[name], name
    for name, trainable in port.items():
        assert trainable == mask[name], name
        assert dict(model.named_parameters())[name].requires_grad == trainable


def _train_inputs(rng, b=2, h=128, w=128):
    image = (rng.randn(b, h, w, 3) * 60).astype(np.float32)
    im_info = np.array([[120.0, 124.0, 1.6], [100.0, 128.0, 1.25]],
                       np.float32)[:b]
    gt = np.zeros((b, 8, 5), np.float32)
    gt[:, 0] = [10, 10, 60, 80, 5]
    gt[:, 1] = [30, 20, 90, 100, 12]
    gt[1, 2] = [64, 40, 120, 96, 3]
    gtv = np.zeros((b, 8), bool)
    gtv[:, :2] = True
    gtv[1, 2] = True
    return image, im_info, gt, gtv


def _torch_batch(image, im_info, gt, gtv):
    return {"image": _t(image), "im_info": _t(im_info), "gt_boxes": _t(gt),
            "gt_valid": _t(gtv)}


def _port_train_model(seed=0, **kw):
    spec = dataclasses.replace(tnet.spec_from_cfg("res50", 21, "TRAIN"),
                               **SMALL_TRAIN, **kw)
    model = tnet.FasterRCNN(spec, device="cpu")
    init_model(model, torch.Generator().manual_seed(seed))
    return spec, model


@pytest.mark.parametrize("fixed_blocks", [0, 1, 3])
def test_frozen_prefix_gradients_are_pruned(rng, fixed_blocks):
    """Freezing is a detach at the prefix boundary, not only
    requires_grad=False: with every parameter made trainable, the stem's
    and the frozen blocks' gradients are exactly zero, and the next
    block's are not."""
    spec, model = _port_train_model(fixed_blocks=fixed_blocks)
    assert not model.head.conv1.weight.requires_grad
    for p in model.parameters():
        p.requires_grad_(True)
    out = model(*_torch_batch(*_train_inputs(rng)).values(),
                generator=torch.Generator().manual_seed(0))
    total = tlosses.detection_losses(out)["total_loss"]
    named = dict(model.named_parameters())
    names = ["head.conv1.weight"] + [
        f"head.block{b}.unit_1.conv3.conv.weight" for b in (1, 2, 3)] + [
        "tail.block4.unit_1.conv3.conv.weight"]
    grads = torch.autograd.grad(total, [named[n] for n in names],
                                allow_unused=True)
    for block, (name, g) in enumerate(zip(names, grads)):
        if block <= fixed_blocks:
            assert g is None or float(g.abs().max()) == 0.0, name
        else:
            assert float(g.abs().max()) > 0.0, name


# --- optimizer -------------------------------------------------------------

def test_lr_schedule_matches_at_each_boundary():
    for args in ((0.001, 0.1, [30000]), (0.01, 0.5, [10, 20]),
                 (0.008, 0.1, [100, 250], 10, 0.25),
                 (0.008, 0.1, [3750], 63, 1.0 / 3.0)):
        jlr, tlr = jtrain.lr_schedule(*args), ttrain.lr_schedule(*args)
        marks = [0] + list(args[2]) + ([args[3]] if len(args) > 3 else [])
        steps = sorted({max(0, m + d) for m in marks for d in (-1, 0, 1)}
                       | {5, 10 ** 6})
        for s in steps:
            np.testing.assert_allclose(
                float(tlr(torch.tensor(s))), float(jlr(jnp.int32(s))),
                rtol=1e-6, err_msg=f"{args} step {s}")
    lr = ttrain.lr_schedule(0.008, 0.1, [100], 10, 0.25)
    assert float(lr(0)) == pytest.approx(0.002)
    assert float(lr(10)) == pytest.approx(0.008)
    assert float(lr(100)) == pytest.approx(0.0008)


@pytest.mark.parametrize("batch,auto", [(1, True), (2, True), (8, True),
                                        (8, False)])
def test_scale_recipe_matches(port_cfg, batch, auto):
    jcfg.TPU.AUTO_SCALE_SCHEDULE = auto
    port_cfg.TPU.AUTO_SCALE_SCHEDULE = auto
    want, got = jtrain.scale_recipe(batch), ttrain.scale_recipe(batch)
    for key in ("learning_rate", "stepsizes", "warmup_steps",
                "warmup_factor", "scale"):
        assert got[key] == want[key], key
    for n in (1, 7, 500, 30000, 70000):
        assert got["iters"](n) == want["iters"](n)
    if batch == 8 and auto:
        assert got["stepsizes"] == [3750] and got["warmup_steps"] == 63


def _toy_params(rng):
    """A toy tree with a conv kernel, a bias and a frozen vgg16 conv1
    (frozen by the JAX mask; the port leaves it out of the update)."""
    return {"params": {
        "rpn_conv": {"kernel": rng.randn(3, 3, 2, 4).astype(np.float32),
                     "bias": rng.randn(4).astype(np.float32)},
        "head": {"conv1_1": {"kernel": np.ones((3, 3, 2, 4), np.float32),
                             "bias": np.ones(4, np.float32)}}}}


@pytest.mark.parametrize("double_bias,stepsizes,warmup", [
    (False, [1000], 0), (True, [1000], 0), (False, [1], 0), (True, [2], 3)])
def test_optimizer_matches_optax_over_three_steps(rng, double_bias,
                                                  stepsizes, warmup):
    """TF-form momentum, DOUBLE_BIAS, the gamma boundary and warmup: three
    updates with random gradients, parameters and momentum trace
    compared after each; the frozen parameter never moves."""
    spec = jnet.spec_from_cfg("vgg16", 2, "TRAIN")
    params = _toy_params(rng)
    sched = dict(learning_rate=0.1, momentum=0.9, gamma=0.1,
                 stepsizes=stepsizes, double_bias=double_bias,
                 warmup_steps=warmup, warmup_factor=0.25)
    tx = jtrain.make_optimizer(spec, params, **sched)
    jstate = jtrain.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                               opt_state=tx.init(params),
                               key=jax.random.PRNGKey(0), tx=tx)
    opt = ttrain.Optimizer(
        ttrain.lr_schedule(0.1, 0.1, stepsizes, warmup, 0.25), 0.9,
        double_bias)
    sd = state_dict_from_flax(params)
    tparams = {k: v.clone() for k, v in sd.items()
               if k.startswith("rpn_conv")}
    trace = {k: torch.zeros_like(v) for k, v in tparams.items()}
    count = torch.zeros((), dtype=torch.int64)
    for _ in range(3):
        grads = jax.tree_util.tree_map(
            lambda x: rng.randn(*x.shape).astype(np.float32), params)
        jstate = jstate.apply_gradients(grads)
        tgrads = state_dict_from_flax(grads)
        opt.apply(tparams, {k: tgrads[k] for k in tparams}, trace, count)
        want = train_state_from_flax(jstate)
        for k in tparams:
            _rel_close(tparams[k].numpy(), want["params"][k].numpy(), 1e-6, k)
            _rel_close(trace[k].numpy(), want["trace"][k].numpy(), 1e-6, k)
        assert int(count) == want["count"] == int(jstate.step)
        np.testing.assert_array_equal(
            want["params"]["head.conv1_1.weight"].numpy(), 1.0)


def test_momentum_is_the_tf_form():
    """acc = m * acc + g; var -= lr * acc (tests/test_optimizer.py)."""
    opt = ttrain.Optimizer(ttrain.lr_schedule(0.1, 0.1, [1000]), 0.9, True)
    params = {"w.weight": torch.ones(2, 2), "w.bias": torch.ones(2)}
    trace = {k: torch.zeros_like(v) for k, v in params.items()}
    count = torch.zeros((), dtype=torch.int64)
    grads = {k: torch.ones_like(v) for k, v in params.items()}
    opt.apply(params, grads, trace, count)
    np.testing.assert_allclose(params["w.weight"].numpy(), 0.9, rtol=1e-6)
    np.testing.assert_allclose(params["w.bias"].numpy(), 0.8, rtol=1e-6)
    opt.apply(params, grads, trace, count)
    np.testing.assert_allclose(params["w.weight"].numpy(), 0.9 - 0.1 * 1.9,
                               rtol=1e-6)
    np.testing.assert_allclose(params["w.bias"].numpy(), 0.8 - 0.1 * 3.8,
                               rtol=1e-6)


# --- NaN guard -------------------------------------------------------------

@pytest.mark.parametrize("poison", ["loss", "gradient"])
def test_nan_guard_skips_the_step_and_holds_the_schedule(rng, port_cfg,
                                                         poison):
    """A non-finite loss or gradient: parameters and momentum unchanged
    (bit for bit), step + 1, the schedule's count held, step_skipped 1;
    the next finite step updates and advances the count."""
    port_cfg.TPU.WARMUP_ITERS = 8       # a learning rate that moves per step
    spec, model = _port_train_model()
    state = ttrain.create_train_state(spec, model,
                                      torch.Generator().manual_seed(0), 2)
    step = ttrain.make_train_step(model, spec, weight_decay=1e-4,
                                  nan_guard=True, lr_fn=state.tx.lr_fn)
    batch = _torch_batch(*_train_inputs(rng))
    state, m = step(state, batch)
    assert float(m["step_skipped"]) == 0.0 and int(state.count) == 1

    w = model.rpn_conv.weight
    if poison == "loss":
        saved = w.detach().clone()
        with torch.no_grad():
            w[0, 0, 0, 0] = float("nan")
    else:
        hook = w.register_hook(lambda g: g * float("nan"))
    before = state.state_dict()
    state, m = step(state, batch)
    assert float(m["step_skipped"]) == 1.0
    assert np.isfinite(float(m["total_loss"])) == (poison == "gradient")
    assert int(state.step) == 2 and int(state.count) == 1
    after = state.state_dict()
    for key in ("params", "trace"):
        for name, t in before[key].items():
            assert torch.equal(t.nan_to_num(), after[key][name].nan_to_num()) \
                and torch.equal(t.isnan(), after[key][name].isnan()), name

    if poison == "loss":
        with torch.no_grad():
            w.copy_(saved)
    else:
        hook.remove()
    w_before = w.detach().clone()
    state, m = step(state, batch)
    assert float(m["step_skipped"]) == 0.0
    assert int(state.step) == 3 and int(state.count) == 2
    # the metric follows the step (2); the update used the count (1)
    lr_fn = state.tx.lr_fn
    assert float(m["learning_rate"]) == float(lr_fn(2)) != float(lr_fn(1))
    assert torch.equal(w.detach(), w_before + (-lr_fn(1))
                       * state.trace["rpn_conv.weight"])


# --- the whole train step --------------------------------------------------

# chosen so that the top fg scores are separated far beyond the two
# frameworks' float32 disagreement at both steps (asserted below)
STEP_SEED = 4


def _jax_noise(jmodel, state_key, b, n_anchors, n_rois):
    """The TrainNoise the JAX train step draws from state.key: the step's
    key, flax's sampling rng, one key per image and sampler, then each
    sampler's fg/bg split."""
    key = jax.random.split(state_key)[0]
    rng = jmodel.apply({}, rngs={"sampling": key},
                       method=lambda m: m.make_rng("sampling"))
    keys = jax.random.split(rng, 2 * b)

    def draw(ks, n):
        pairs = [jax.random.split(k) for k in ks]
        return [np.stack([np.asarray(jax.random.uniform(p[i], (n,)))
                          for p in pairs]) for i in (0, 1)]

    a_fg, a_bg = draw(keys[:b], n_anchors)
    r_fg, r_bg = draw(keys[b:], n_rois)
    return key, tnet.TrainNoise(*(_t(x) for x in (a_fg, a_bg, r_fg, r_bg)))


def _assert_score_separation(jout, tout, k):
    """The proposals can match only if the frameworks rank the top k fg
    scores alike: any gap over twice the largest fg-score disagreement
    keeps the order; 10x leaves room for another CPU's summation order."""
    jfg = np.asarray(jax.nn.softmax(jout["rpn_cls_score"], -1))[..., 1]
    tfg = torch.softmax(tout["rpn_cls_score"], -1)[..., 1].detach().numpy()
    disagreement = float(np.abs(jfg - tfg).max())
    for b in range(jfg.shape[0]):
        ranked = np.sort(jfg[b])[::-1][:k]
        gap = float(np.min(-np.diff(ranked)))
        assert gap > 10 * disagreement, (b, gap, disagreement)


def test_train_step_res50_matches_make_train_step(port_cfg):
    """res50 TRAIN at 128x128, B = 2, scales (2, 4), 64 proposals, 32 RoIs,
    64 anchors: two steps of the port's train step against the JAX one,
    from one TrainState carried across by the bridge, with the noise JAX
    drew. Each step checks the sampled targets, the losses, the momentum
    (after step 1, the gradients, doubled for biases under DOUBLE_BIAS),
    the updated parameters and the schedule's count."""
    for c in (jcfg, port_cfg):
        c.TRAIN.LEARNING_RATE = 0.01
    image, im_info, gt, gtv = _train_inputs(np.random.RandomState(STEP_SEED))
    jspec, jmodel, params, tspec = _res50_params(
        STEP_SEED, "TRAIN", (128, 128), **SMALL_TRAIN)
    jstate = jtrain.create_train_state(jspec, params,
                                       jax.random.PRNGKey(STEP_SEED), 2)
    jstep = jtrain.make_train_step(jmodel, jspec, weight_decay=1e-4,
                                   mobile_weight_decay=4e-5, donate=False,
                                   nan_guard=True)
    jforward = jax.jit(lambda p, key: jmodel.apply(
        p, image, im_info, gt, gtv, rngs={"sampling": key}))

    tmodel = tnet.FasterRCNN(tspec, device="cpu")
    tstate = ttrain.create_train_state(tspec, tmodel, torch.Generator(), 2)
    tstate.load_state_dict(train_state_from_flax(jstate))
    tstep = ttrain.make_train_step(tmodel, tspec, weight_decay=1e-4,
                                   nan_guard=True)
    batch = _torch_batch(image, im_info, gt, gtv)
    n_anchors = (128 // 16) ** 2 * tspec.num_anchors
    frozen = {k: p.detach().clone() for k, p in tmodel.named_parameters()
              if not p.requires_grad}
    assert "head.conv1.weight" in frozen and any("block1" in k
                                                 for k in frozen)

    for it in range(2):
        key, noise = _jax_noise(jmodel, jstate.key, 2, n_anchors,
                                tspec.rpn_post_nms_top_n)
        jout = jax.tree_util.tree_map(np.asarray,
                                      jforward(jstate.params, key))
        with torch.no_grad():
            tout = tmodel(*batch.values(), noise=noise)
        _assert_score_separation(jout, tout, tspec.rpn_post_nms_top_n)
        for name in ("anchor_targets", "proposal_targets"):
            np.testing.assert_array_equal(tout[name].labels.numpy(),
                                          jout[name].labels, err_msg=name)
        np.testing.assert_array_equal(tout["roi_valid"].numpy(),
                                      jout["roi_valid"])
        # one ulp of exp in the proposal decode
        np.testing.assert_allclose(tout["rois"].numpy(), jout["rois"],
                                   rtol=0, atol=1e-3)
        assert (jout["proposal_targets"].labels > 0).sum() > 0

        jstate, jm = jstep(jstate, {"image": image, "im_info": im_info,
                                    "gt_boxes": gt, "gt_valid": gtv})
        tstate, tm = tstep(tstate, batch, noise=noise)
        for name, value in jm.items():
            _rel_close(tm[name].numpy(), value, 1e-4, name)
        assert float(tm["step_skipped"]) == 0.0

        want = train_state_from_flax(jstate)
        assert int(tstate.step) == want["step"] == it + 1
        assert int(tstate.count) == want["count"] == it + 1
        for name, p in tmodel.named_parameters():
            _rel_close(p.detach().numpy(), want["params"][name].numpy(),
                       1e-4, name)
            if name in frozen:
                # no loss gradient reached the frozen prefix in JAX either:
                # its momentum holds weight decay's alone, wd * w per step
                assert torch.equal(p, frozen[name]), name
                _rel_close(want["trace"][name].numpy(),
                           1e-4 * frozen[name].numpy() * (1 + 0.9 * it),
                           1e-6, name)
        # the momentum (after step 1: the gradients), each tensor to 1e-4
        # of the largest magnitude over all of them: the tail's gradients
        # move by 1.3e-4 of their own largest value under a 1e-6 relative
        # change of the input image, the size of the two frameworks'
        # float32 disagreement
        scale = max(float(np.abs(want["trace"][k].numpy()).max())
                    for k in tstate.trace)
        for name, t in tstate.trace.items():
            err = float(np.abs(t.numpy() - want["trace"][name].numpy()).max())
            assert err <= 1e-4 * scale, (name, err / scale)


def test_train_state_bridge_round_trip(port_cfg):
    """train_state_from_flax + load_state_dict put the JAX state's params,
    momentum, step and count into the port's state unchanged."""
    jspec, _, params, tspec = _res50_params(2)
    jstate = jtrain.create_train_state(jspec, params, jax.random.PRNGKey(0))
    grads = jax.tree_util.tree_map(lambda x: jnp.full(x.shape, 0.5), params)
    jstate = jstate.apply_gradients(grads).apply_gradients(grads)
    bridged = train_state_from_flax(jstate)
    assert bridged["step"] == bridged["count"] == 2
    model = tnet.FasterRCNN(tspec, device="cpu")
    state = ttrain.create_train_state(tspec, model, torch.Generator())
    state.load_state_dict(bridged)
    for name, p in model.named_parameters():
        assert torch.equal(p.detach(), bridged["params"][name]), name
    for name, t in state.trace.items():
        assert torch.equal(t, bridged["trace"][name]), name
        assert float(t.abs().max()) > 0
    assert int(state.step) == 2 and int(state.count) == 2
