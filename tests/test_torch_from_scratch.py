"""From-scratch training in the port: ``models/init.py::reference_init``
against the JAX package's ``model.init``, and the JAX from-scratch gates of
``tests/test_from_scratch_stability.py`` run on the port with their bounds.

* Per tensor, for res50, vgg16 (pooling_size 3: fc6 4608 -> 4096) and
  mobile, with TRAIN.TRUNCATED off and on, named through
  ``utils/weights.py::state_dict_from_flax``: a constant tensor (zeros,
  ones) equal to the JAX one; a drawn one of >= 4096 elements with a std
  within 3 % of the JAX tensor's and of the analytic std; no element of a
  truncated draw beyond its bound, in either package, and a plain normal
  draw past it in both.
* The init feature scale on pixel-scale inputs (vgg16, res50, mobile),
  16 steps of res50 at the scaled recipe finite and learning, and the
  24-step fixed-batch learning speed under the JAX ``_OVERFIT_BOUNDS``;
  the deep nets (res101, mobile) are ``slow`` as in the JAX test.
* A slim ImageNet dict without heads loaded over ``reference_init`` (what
  the train loop, test_net and convert_weights do) leaves the heads as the
  JAX package starts them: zero biases, stds 0.01 and 0.001.
"""

import dataclasses
import math

import jax
import numpy as np
import pytest
import torch

from test_from_scratch_stability import _OVERFIT_BOUNDS, _scene_batch
from test_torch_weights_import import _mobile_backbone_var
from tf_faster_rcnn_tpu.config import cfg as jcfg
from tf_faster_rcnn_tpu.models import network as jnet
from tf_faster_rcnn_torch import config as tconfig
from tf_faster_rcnn_torch.engine.train import (create_train_state,
                                               make_train_step, scale_recipe)
from tf_faster_rcnn_torch.models import network as tnet
from tf_faster_rcnn_torch.models.init import (TRUNC_STD, reference_dist,
                                              reference_init)
from tf_faster_rcnn_torch.utils.slim_import import load_pretrained_into
from tf_faster_rcnn_torch.utils.weights import state_dict_from_flax

STD_TOL = 0.03
MIN_DRAWN = 4096
SMALL = dict(anchor_scales=(2, 4), rpn_pre_nms_top_n=64,
             rpn_post_nms_top_n=16)
# tests/test_from_scratch_stability.py's batch, canvas and step count
BATCH = 2
CANVAS = (96, 128)
STEPS = 16


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(min(before, 2))
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def _port_cfg():
    tconfig.reset_cfg()
    yield
    tconfig.reset_cfg()


def _specs(net, truncated):
    """The JAX and port TEST specs of net at small proposal counts, both
    from their cfg with TRAIN.TRUNCATED set."""
    jcfg.TRAIN.TRUNCATED = truncated
    tconfig.cfg.TRAIN.TRUNCATED = truncated
    extra = dict(SMALL, pooling_size=3 if net == "vgg16" else 7)
    jspec = dataclasses.replace(jnet.spec_from_cfg(net, 4, "TEST"), **extra)
    tspec = dataclasses.replace(tnet.spec_from_cfg(net, 4, "TEST"), **extra)
    assert jspec.truncated == tspec.truncated == truncated
    return jspec, tspec


def _jax_init(jspec):
    im = np.zeros((1, 64, 64, 3), np.float32)
    info = np.array([[64.0, 64.0, 1.0]], np.float32)
    params = jax.jit(jnet.FasterRCNN(jspec).init)(jax.random.PRNGKey(0), im,
                                                  info)
    return state_dict_from_flax(params)


def _analytic(dist, fan_in):
    """(std, truncation bound or None) of a drawn reference_dist."""
    if dist[0] == "scaled":
        std = math.sqrt(dist[1] / fan_in)
        return std, 2.0 * std / TRUNC_STD
    if dist[0] == "truncated":
        return dist[1] * TRUNC_STD, 2.0 * dist[1]
    return dist[1], None


@pytest.mark.parametrize("truncated", [False, True])
@pytest.mark.parametrize("net", ["res50", "vgg16", "mobile"])
def test_reference_init_matches_jax_init(net, truncated):
    jspec, tspec = _specs(net, truncated)
    want = _jax_init(jspec)
    model = tnet.FasterRCNN(tspec, device="cpu")
    reference_init(model, torch.Generator().manual_seed(0))
    got = model.state_dict()
    assert set(got) == set(want)
    checked = 0
    for name, t in got.items():
        ref = want[name]
        assert t.shape == ref.shape, name
        path, leaf = name.rsplit(".", 1)
        dist = reference_dist(net, path, leaf, truncated)
        if dist[0] in ("zeros", "ones"):
            assert torch.equal(t, ref), name
            continue
        std, limit = _analytic(dist, int(np.prod(t.shape[1:])))
        for x in (t, ref):
            peak = float(x.abs().max())
            if limit is not None:
                assert peak <= limit * (1 + 1e-6), (name, peak, limit)
            elif x.numel() >= MIN_DRAWN:     # a plain normal is not cut
                assert peak > 2.0 * std, (name, peak, std)
        if t.numel() >= MIN_DRAWN:
            s, s_ref = float(t.std()), float(ref.std())
            assert abs(s / s_ref - 1) < STD_TOL, (name, s, s_ref)
            assert abs(s / std - 1) < STD_TOL, (name, s, std)
            checked += 1
    assert checked >= 10


def test_reference_init_draw_depends_only_on_the_generator():
    """The draw is a function of the generator's seed alone: two models,
    the same draw; another seed, another draw (the card's copy is held to
    the CPU's bit for bit by chip_smoke.py phase 14)."""
    _, tspec = _specs("mobile", False)
    tspec = dataclasses.replace(tspec, depth_multiplier=0.25)
    draws = []
    for seed in (0, 0, 1):
        model = tnet.FasterRCNN(tspec, device="cpu")
        reference_init(model, torch.Generator().manual_seed(seed))
        draws.append(model.state_dict())
    for name, t in draws[0].items():
        assert torch.equal(t, draws[1][name]), name
    assert not torch.equal(draws[0]["rpn_conv.weight"],
                           draws[2]["rpn_conv.weight"])


@pytest.mark.parametrize("net", ["vgg16", "res50", "mobile"])
def test_from_scratch_init_feature_scale(net):
    """The JAX gate (test_from_scratch_stability.py:120): the backbone
    output's std at init on a pixel-scale input lies in (0.05, 20)."""
    spec = dataclasses.replace(tnet.spec_from_cfg(net, 4, "TEST"), **SMALL)
    model = tnet.FasterRCNN(spec, device="cpu")
    reference_init(model, torch.Generator().manual_seed(0))
    rng = np.random.RandomState(0)
    h, w = CANVAS
    im = (rng.rand(1, h, w, 3).astype(np.float32) * 255.0
          ) - tconfig.cfg.PIXEL_MEANS.reshape(1, 1, 1, 3)
    info = torch.tensor([[h, w]], dtype=torch.float32)
    with torch.no_grad():
        feats = model.head(torch.from_numpy(im).permute(0, 3, 1, 2), info)
    std = float(feats.std())
    assert 0.05 < std < 20.0, f"{net} init backbone-output std {std:.4g}"


def _run_steps(net, steps=STEPS, batch=BATCH, fixed_batch=False):
    """The JAX test's _run_steps in the port: its cfg, scenes and recipe,
    from reference_init."""
    c = tconfig.cfg
    c.TPU.MAX_GT = 8
    c.ANCHOR_SCALES = [2, 4, 8]
    c.TRAIN.RPN_PRE_NMS_TOP_N = 256
    c.TRAIN.RPN_POST_NMS_TOP_N = 48
    c.TRAIN.BATCH_SIZE = 32
    c.TRAIN.RPN_BATCHSIZE = 64
    c.TPU.WARMUP_ITERS = 4 * batch
    spec = tnet.spec_from_cfg(net, 4, "TRAIN")
    model = tnet.FasterRCNN(spec, device="cpu")
    reference_init(model, torch.Generator().manual_seed(c.RNG_SEED))
    state = create_train_state(spec, model, torch.Generator().manual_seed(1),
                               batch_size=batch)
    recipe = scale_recipe(batch)
    assert recipe["scale"] == batch and recipe["warmup_steps"] > 0
    step_fn = make_train_step(
        model, spec, weight_decay=float(c.TRAIN.WEIGHT_DECAY),
        mobile_weight_decay=float(c.MOBILENET.WEIGHT_DECAY),
        lr_fn=state.tx.lr_fn, nan_guard=True)
    rng = np.random.RandomState(0)

    def draw():
        return {k: torch.from_numpy(v) for k, v in
                _scene_batch(rng, CANVAS, batch, c.TPU.MAX_GT).items()}

    batch0 = draw()
    losses, skipped = [], 0
    for _ in range(steps):
        state, metrics = step_fn(state, batch0 if fixed_batch else draw())
        skipped += int(metrics["step_skipped"])
        losses.append(float(metrics["total_loss"]))
    return losses, skipped


@pytest.mark.parametrize("net", ["res50"])
def test_from_scratch_scaled_recipe_stays_finite_and_learns(net):
    losses, skipped = _run_steps(net)
    assert skipped == 0, f"non-finite steps at the scaled recipe: {losses}"
    assert all(np.isfinite(losses)), losses
    assert np.mean(losses[-4:]) < np.mean(losses[:4]), losses


@pytest.mark.slow
@pytest.mark.parametrize("net", ["res101", "mobile"])
def test_from_scratch_scaled_recipe_deep_nets(net):
    losses, skipped = _run_steps(net)
    assert skipped == 0, f"non-finite steps at the scaled recipe: {losses}"
    assert np.mean(losses[-4:]) < np.mean(losses[:4]), losses


@pytest.mark.parametrize("net", ["vgg16", "res50", "mobile"])
def test_from_scratch_learning_speed(net):
    """24 steps on one fixed scene batch: the trailing-4 mean loss under
    the JAX package's calibrated bound for the backbone."""
    losses, skipped = _run_steps(net, steps=24, fixed_batch=True)
    assert skipped == 0, f"non-finite steps: {losses}"
    tail = float(np.mean(losses[-4:]))
    assert tail < _OVERFIT_BOUNDS[net], (net, tail, losses)


def test_pretrained_backbone_keeps_reference_heads(tmp_path):
    """A slim ImageNet dict (the backbone only) loaded over reference_init:
    the backbone is the dict's, the heads the JAX package's init."""
    _, var = _mobile_backbone_var()
    spec = dataclasses.replace(tnet.spec_from_cfg("mobile", 21, "TEST"),
                               depth_multiplier=0.25, **SMALL)
    model = tnet.FasterRCNN(spec, device="cpu")
    reference_init(model, torch.Generator().manual_seed(0))
    drawn = {k: v.clone() for k, v in model.state_dict().items()}
    path = str(tmp_path / "mobile.npz")
    np.savez(path, **var)
    load_pretrained_into(model, path, "mobile")
    sd = model.state_dict()
    stds = {"rpn_conv": 0.01, "rpn_cls_score": 0.01, "rpn_bbox_pred": 0.01,
            "cls_score": 0.01, "bbox_pred": 0.001}
    for head, std in stds.items():
        assert not sd[f"{head}.bias"].any(), head
        w = sd[f"{head}.weight"]
        assert torch.equal(w, drawn[f"{head}.weight"]), head
        assert w.numel() >= MIN_DRAWN
        assert abs(float(w.std()) / std - 1) < STD_TOL, (head, w.std())
    moved = [k for k in sd if k.startswith("head.")
             and not torch.equal(sd[k], drawn[k])]
    assert len(moved) > 20
