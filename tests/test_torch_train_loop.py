"""The port's training loop (``engine/train_loop.py``) and its CLI, against
the JAX package's loop and on their own.

The setting: mobile at depth multiplier 0.25 on a mini-VOC of 8 images in
both orientations with their flipped entries (``tests/
test_torch_datasets.py::make_voc``), one 128x128 canvas, TRAIN.SCALES
(96,), B = 2 (TPU.IMS_PER_DEVICE), 48 proposals, 16 RoIs, 32 anchors per
image, TPU.PREFETCH 0 unless said.

* Parity: four steps of the JAX loop and of the port's, from one TrainState
  (the JAX loop's, its params redrawn by ``models/init.py::numpy_params``,
  carried across by ``train_state_from_flax``) and with the noise the JAX
  steps drew (``tests/test_torch_train.py::_jax_noise`` on the JAX state's
  key chain, passed in by wrapping the port's step): the same batches, and
  every loss, the regularization loss and the learning rate within 1e-4
  relative at each step; both loops' snapshots hold equal data cursors.
* A run resumed from the port's step-4 snapshot ends equal, bit for bit,
  to the unbroken run (parameters, momentum, counts, the generator, the
  data cursors).
* The JAX loop's step-4 ``.msgpack`` snapshot pair resumes in the port:
  parameters and momentum equal to the bridged ones, the same cursors and
  np.random state. A JAX snapshot trained under TPU.SPACE_TO_DEPTH resumes
  with the 7x7 stem; one with a nonzero tap outside the 7x7 support
  raises.
* NaN patience snapshots and raises; TPU.CHECKPOINT_BACKEND 'orbax'
  raises; SIGTERM to the CLI snapshots and exits 0, and the same command
  resumes and finishes; the in-training eval writes the mAP, keeps the
  newest eval dir and ``{prefix}_best.pt``; the run writes metrics.jsonl,
  both event dirs and the GT image.
"""

import dataclasses
import json
import os
import os.path as osp
import pickle
import shutil
import signal
import subprocess
import sys
import threading

import jax
import numpy as np
import pytest
import torch

from test_torch_datasets import make_voc, set_both_cfgs
from test_torch_train import _jax_noise
from tf_faster_rcnn_tpu import config as jconfig
from tf_faster_rcnn_tpu.data import roidb as jroidb
from tf_faster_rcnn_tpu.datasets import factory as jfactory
from tf_faster_rcnn_tpu.engine import train as jtrain
from tf_faster_rcnn_tpu.engine import train_loop as jloop
from tf_faster_rcnn_tpu.models import network as jnet
from tf_faster_rcnn_tpu.models.resnet_v1 import s2d_conv1_kernel
from tf_faster_rcnn_tpu.utils import checkpoint as jckpt
from tf_faster_rcnn_torch import config as tconfig
from tf_faster_rcnn_torch.data import roidb as troidb
from tf_faster_rcnn_torch.datasets import factory as tfactory
from tf_faster_rcnn_torch.engine import train as ttrain
from tf_faster_rcnn_torch.engine import train_loop as tloop
from tf_faster_rcnn_torch.models import network as tnet
from tf_faster_rcnn_torch.models.init import numpy_params
from tf_faster_rcnn_torch.utils import checkpoint as tckpt
from tf_faster_rcnn_torch.utils.weights import train_state_from_flax

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
PREFIX = "res101_faster_rcnn"        # TRAIN.SNAPSHOT_PREFIX's default
SEED = 5
LOSS_TOL = 1e-4
B = 2
CANVAS = 128
LOOP_CFG = {
    "TRAIN.SCALES": (96,), "TRAIN.MAX_SIZE": 128, "TEST.SCALES": (96,),
    "TEST.MAX_SIZE": 128, "TPU.CANVAS_SIZE": [CANVAS, CANVAS],
    "ANCHOR_SCALES": [2, 4], "MOBILENET.DEPTH_MULTIPLIER": 0.25,
    "TRAIN.RPN_PRE_NMS_TOP_N": 256, "TRAIN.RPN_POST_NMS_TOP_N": 48,
    "TEST.RPN_PRE_NMS_TOP_N": 128, "TEST.RPN_POST_NMS_TOP_N": 16,
    "TRAIN.BATCH_SIZE": 16, "TRAIN.RPN_BATCHSIZE": 32,
    "TPU.IMS_PER_DEVICE": B, "TPU.MAX_GT": 8, "TRAIN.SNAPSHOT_ITERS": 4,
    "TRAIN.DISPLAY": 1, "TPU.PREFETCH": 0, "TRAIN.LEARNING_RATE": 0.01,
}
N_ANCHORS = (CANVAS // 16) ** 2 * 6


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(min(before, 2))
    yield
    torch.set_num_threads(before)


def _set_cfgs(root, **extra):
    tconfig.reset_cfg()
    jconfig.reset_cfg()
    set_both_cfgs(DATA_DIR=str(root), ROOT_DIR=str(root),
                  **dict(LOOP_CFG, **extra))


def _voc_root(tmp_path_factory, name):
    root = tmp_path_factory.mktemp(name)
    make_voc(str(root), image_set="trainval")
    make_voc(str(root), image_set="test")
    return root


def _roidbs(factory, roidb_mod):
    """(imdb, train roidb with flipped entries, val imdb, val roidb)."""
    imdb = factory.get_imdb("voc_2007_trainval")
    imdb.set_proposal_method("gt")
    imdb.append_flipped_images()
    roidb_mod.prepare_roidb(imdb)
    valimdb = factory.get_imdb("voc_2007_test")
    valimdb.set_proposal_method("gt")
    roidb_mod.prepare_roidb(valimdb)
    return imdb, imdb.roidb, valimdb, valimdb.roidb


def _port_train(root, out, max_iters, **kw):
    imdb, roidb, valimdb, valroidb = _roidbs(tfactory, troidb)
    return tloop.train_net("mobile", imdb, roidb, valroidb,
                           str(root / out), str(root / (out + "_tb")),
                           max_iters=max_iters, valimdb=valimdb,
                           device="cpu", **kw)


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """Four steps of the JAX loop (8 images of reference units): the
    initial TrainState (params redrawn by numpy_params), and each step's
    state key and metrics. Snapshots at steps 2 and 4."""
    root = _voc_root(tmp_path_factory, "jax_loop")
    _set_cfgs(root)
    record = {"keys": [], "metrics": []}
    orig_create, orig_step = jloop.create_train_state, jloop.make_train_step

    def create(spec, params, key, batch_size=1):
        state = orig_create(spec, numpy_params(params, SEED), key,
                            batch_size)
        record["state"] = jax.tree_util.tree_map(np.asarray, state)
        return state

    def make_step(*args, **kwargs):
        step = orig_step(*args, **kwargs)

        def wrapped(state, batch):
            record["keys"].append(np.asarray(state.key))
            state, metrics = step(state, batch)
            record["metrics"].append(
                {k: float(v) for k, v in metrics.items()})
            return state, metrics
        return wrapped

    jloop.create_train_state, jloop.make_train_step = create, make_step
    try:
        imdb, roidb, valimdb, valroidb = _roidbs(jfactory, jroidb)
        jloop.train_net("mobile", imdb, roidb, valroidb,
                        str(root / "out"), str(root / "tb"), max_iters=8,
                        valimdb=valimdb)
    finally:
        jloop.create_train_state, jloop.make_train_step = \
            orig_create, orig_step
        jconfig.reset_cfg()
    record["root"] = root
    return record


def test_loop_losses_match_jax(jax_run, monkeypatch):
    """The port's loop, from the JAX loop's initial state and with its
    noise, gives its losses at every step."""
    root = jax_run["root"]
    _set_cfgs(root)
    jmodel = jnet.FasterRCNN(jnet.spec_from_cfg("mobile", 21, "TRAIN"))
    noise_of = iter(jax_run["keys"])
    got = []
    orig_create, orig_step = tloop.create_train_state, tloop.make_train_step

    def create(spec, model, generator, batch_size=1):
        state = orig_create(spec, model, generator, batch_size)
        state.load_state_dict(train_state_from_flax(jax_run["state"]))
        return state

    def make_step(model, spec, **kwargs):
        step = orig_step(model, spec, **kwargs)

        def wrapped(state, batch):
            _, noise = _jax_noise(jmodel, next(noise_of), B, N_ANCHORS,
                                  spec.rpn_post_nms_top_n)
            state, metrics = step(state, batch, noise=noise)
            got.append({k: float(v) for k, v in metrics.items()})
            return state, metrics
        return wrapped

    monkeypatch.setattr(tloop, "create_train_state", create)
    monkeypatch.setattr(tloop, "make_train_step", make_step)
    state = _port_train(root, "port_out", 8)
    assert int(state.step) == 4 and len(got) == len(jax_run["metrics"]) == 4
    for i, (g, want) in enumerate(zip(got, jax_run["metrics"])):
        assert set(g) == set(want)
        assert want["step_skipped"] == g["step_skipped"] == 0.0
        assert want["cross_entropy"] > 0 and want["rpn_cross_entropy"] > 0
        for key, value in want.items():
            assert abs(g[key] - value) <= LOSS_TOL * max(abs(value), 1e-6), \
                (i + 1, key, g[key], value)
    # both loops' step-4 snapshots hold the same data cursors
    jmeta = tckpt.restore_meta(str(root / "out" / f"{PREFIX}_iter_4.pkl"))
    tmeta = tckpt.restore_meta(str(root / "port_out" / f"{PREFIX}_iter_4.pkl"))
    _assert_data_state_equal(tmeta["data_state"]["train"],
                             jmeta["data_state"]["train"])
    assert tmeta["step"] == jmeta["step"] == 4


def _assert_data_state_equal(got, want):
    assert int(got["cur"]) == int(want["cur"])
    np.testing.assert_array_equal(got["perm"], want["perm"])
    for a, b in zip(got["rng_state"], want["rng_state"]):
        np.testing.assert_array_equal(a, b)


def test_jax_snapshot_resumes_in_the_port(jax_run, monkeypatch, capsys):
    """The JAX loop's step-4 snapshot pair, alone in an output dir, is the
    port's resume point: state and cursors as the JAX loop left them."""
    root = jax_run["root"]
    _set_cfgs(root)
    out = root / "resume_jax"
    out.mkdir()
    for ext in ("msgpack", "pkl"):
        shutil.copy(root / "out" / f"{PREFIX}_iter_4.{ext}", out)
    seen = {}
    orig = tloop.SolverWrapper._restore

    def restore(self):
        orig(self)
        seen["state"] = self.state.state_dict()
        seen["data"] = self.data_layer.get_state()
        seen["np"] = np.random.get_state()

    monkeypatch.setattr(tloop.SolverWrapper, "_restore", restore)
    state = _port_train(root, "resume_jax", 10)
    assert int(state.step) == 5
    printed = capsys.readouterr().out
    assert "Restored from iter 4" in printed
    assert "RNG_SEED + step" in printed

    want = tckpt._train_state_from_msgpack(
        str(out / f"{PREFIX}_iter_4.msgpack"))
    assert seen["state"]["step"] == want["step"] == 4
    assert seen["state"]["count"] == want["count"] == 4
    for key in ("params", "trace"):
        for name, t in seen["state"][key].items():
            assert torch.equal(t, want[key][name]), (key, name)
    meta = tckpt.restore_meta(str(out / f"{PREFIX}_iter_4.pkl"))
    _assert_data_state_equal(seen["data"], meta["data_state"]["train"])
    for a, b in zip(seen["np"], meta["np_rng_state"]):
        np.testing.assert_array_equal(a, b)
    # the port's own snapshot of step 5 sits beside the JAX pair
    assert tckpt.find_previous(str(out), PREFIX)[0] == 5


def _s2d_snapshot(out, rng, outside=0.0):
    """A JAX res50 TrainState trained under TPU.SPACE_TO_DEPTH (conv1
    [4, 4, 12, 64]) written by the JAX package's snapshot; returns the 7x7
    kernel it was made from."""
    spec = dataclasses.replace(jnet.spec_from_cfg("res50", 21, "TRAIN"),
                               anchor_scales=(2, 4))
    shapes = jax.eval_shape(
        jnet.FasterRCNN(spec).init,
        {"params": jax.random.PRNGKey(0), "sampling": jax.random.PRNGKey(1)},
        np.zeros((1, 64, 64, 3), np.float32),
        np.array([[64.0, 64.0, 1.0]], np.float32),
        np.zeros((1, 2, 5), np.float32), np.ones((1, 2), bool))
    params = numpy_params(shapes, 3)
    k7 = params["params"]["head"]["conv1"]["kernel"]
    k2 = s2d_conv1_kernel(k7)
    k2[0, 0, 0, 0] = outside
    params["params"]["head"]["conv1"]["kernel"] = k2
    state = jtrain.create_train_state(spec, params, jax.random.PRNGKey(7))
    grads = jax.tree_util.tree_map(
        lambda x: rng.randn(*x.shape).astype(np.float32), params)
    # the stem is frozen behind a stop_gradient: its gradient is zero
    grads["params"]["head"]["conv1"]["kernel"] = np.zeros_like(k2)
    state = jax.jit(lambda s, g: s.apply_gradients(grads=g))(state, grads)
    jckpt.snapshot(str(out), PREFIX, state, {"train": {"cur": 0}},
                   extra_meta={"best_map": 0.25})
    return k7, state


@pytest.mark.parametrize("outside", [0.0, 0.5])
def test_jax_space_to_depth_snapshot_resumes(tmp_path, rng, outside):
    out = tmp_path / "s2d"
    k7, jstate = _s2d_snapshot(out, rng, outside)
    found = tckpt.find_previous(str(out), PREFIX)
    assert found[0] == 1 and found[1].endswith(".msgpack")
    tconfig.reset_cfg()
    spec = dataclasses.replace(tnet.spec_from_cfg("res50", 21, "TRAIN"),
                               anchor_scales=(2, 4))
    model = tnet.FasterRCNN(spec, device="cpu")
    state = ttrain.create_train_state(spec, model, torch.Generator(), 1)
    if outside:
        with pytest.raises(ValueError, match="outside the 7x7 support"):
            tckpt.restore(state, found[1])
        return
    tckpt.restore(state, found[1])
    np.testing.assert_array_equal(model.head.conv1.weight.numpy(),
                                  k7.transpose(3, 2, 0, 1))
    want = train_state_from_flax(jstate)
    assert int(state.step) == int(state.count) == 1
    for name, t in state.trace.items():
        assert torch.equal(t, want["trace"][name]), name
    assert float(state.trace["rpn_conv.weight"].abs().max()) > 0
    assert tckpt.restore_meta(found[2])["best_map"] == 0.25


def test_resumed_run_equals_unbroken_run(tmp_path_factory):
    """Eight steps unbroken, and four more from a copy of its step-4
    snapshot pair: equal parameters, momentum, counts, generator and data
    cursors, bit for bit."""
    root = _voc_root(tmp_path_factory, "resume")
    _set_cfgs(root, **{"TRAIN.SNAPSHOT_ITERS": 8, "TRAIN.SNAPSHOT_KEPT": 3})
    unbroken = _port_train(root, "unbroken", 16)
    assert int(unbroken.step) == 8
    full = unbroken.state_dict()
    full_gen = unbroken.generator.get_state()
    (root / "resumed").mkdir()
    for ext in ("pt", "pkl"):
        shutil.copy(root / "unbroken" / f"{PREFIX}_iter_4.{ext}",
                    root / "resumed")
    resumed = _port_train(root, "resumed", 16)
    again = resumed.state_dict()
    assert again["step"] == full["step"] and again["count"] == full["count"]
    for key in ("params", "trace"):
        for name, t in full[key].items():
            assert torch.equal(again[key][name], t), (key, name)
    assert torch.equal(resumed.generator.get_state(), full_gen)
    metas = [tckpt.restore_meta(str(root / d / f"{PREFIX}_iter_8.pkl"))
             for d in ("unbroken", "resumed")]
    _assert_data_state_equal(metas[1]["data_state"]["train"],
                             metas[0]["data_state"]["train"])
    kept = sorted(f for f in os.listdir(root / "unbroken")
                  if f.endswith(".pt"))
    assert kept == [f"{PREFIX}_iter_4.pt", f"{PREFIX}_iter_8.pt"]


def test_eval_best_params_and_summaries(tmp_path_factory):
    """TPU.EVAL_ITERS: the mAP in metrics.jsonl at each eval, only the
    newest eval dir kept, {prefix}_best.pt loadable into a TEST model; the
    summaries: metrics.jsonl, event files in both dirs, the GT image."""
    root = _voc_root(tmp_path_factory, "evals")
    _set_cfgs(root, **{"TPU.EVAL_ITERS": 4, "TPU.PREFETCH": 2})
    _port_train(root, "out", 8)
    out, tb = root / "out", root / "out_tb"
    assert sorted(d for d in os.listdir(out) if d.startswith("val_eval")) \
        == ["val_eval_iter_4"]
    rows = [json.loads(line) for line in open(tb / "metrics.jsonl")]
    maps = [r for r in rows if "val_mAP" in r]
    assert [r["step"] for r in maps] == [2, 4]
    assert all(0.0 <= r["val_mAP"] <= 1.0 for r in maps)
    assert {r["prefix"] for r in rows} == {"train", "val", ""}
    assert any(f.startswith("events.out.tfevents.") for f in os.listdir(tb))
    assert any(f.startswith("events.out.tfevents.")
               for f in os.listdir(str(tb) + "_val"))
    assert (tb / "gt_image_iter_1.png").exists()
    model = tnet.FasterRCNN(tnet.spec_from_cfg("mobile", 21, "TEST"),
                            device="cpu")
    model.load_state_dict(tckpt.load_params(str(out / f"{PREFIX}_best.pt")),
                          strict=True)
    assert tckpt.restore_meta(str(out / f"{PREFIX}_iter_4.pkl"))[
        "best_map"] == max(r["val_mAP"] for r in maps)


def test_nan_patience_snapshots_and_raises(tmp_path_factory, monkeypatch):
    root = _voc_root(tmp_path_factory, "nan")
    _set_cfgs(root, **{"TPU.NAN_GUARD_PATIENCE": 2})
    orig = tloop.make_train_step

    def poisoned(model, spec, **kwargs):
        step = orig(model, spec, **kwargs)

        def wrapped(state, batch):
            with torch.no_grad():
                model.rpn_conv.weight[0, 0, 0, 0] = float("nan")
            return step(state, batch)
        return wrapped

    monkeypatch.setattr(tloop, "make_train_step", poisoned)
    with pytest.raises(RuntimeError, match="2 consecutive non-finite"):
        _port_train(root, "out", 40)
    found = tckpt.find_previous(str(root / "out"), PREFIX)
    assert found[0] == 2


def test_orbax_backend_raises(tmp_path_factory):
    root = _voc_root(tmp_path_factory, "orbax")
    _set_cfgs(root, **{"TPU.CHECKPOINT_BACKEND": "orbax"})
    with pytest.raises(NotImplementedError, match="orbax"):
        _port_train(root, "out", 4)
    tconfig.reset_cfg()


def _cli(root, iters):
    sets = ["DATA_DIR", str(root), "ROOT_DIR", str(root)]
    for key, value in LOOP_CFG.items():
        sets += [key, str(value).replace(" ", "")]
    return [sys.executable, "-u", "-m", "tf_faster_rcnn_torch.tools."
            "trainval_net", "--net", "mobile", "--imdb", "voc_2007_trainval",
            "--imdbval", "voc_2007_test", "--iters", str(iters), "--device",
            "cpu", "--set"] + sets + ["TRAIN.SNAPSHOT_ITERS", "1000"]


def test_sigterm_to_the_cli_snapshots_and_the_same_command_resumes(
        tmp_path_factory):
    root = _voc_root(tmp_path_factory, "sigterm")
    cmd = _cli(root, 40)
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    proc = subprocess.Popen(cmd, cwd=REPO, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    killer = threading.Timer(300, proc.kill)
    killer.start()
    try:
        for line in proc.stdout:
            if line.startswith("iter: 2 / 20"):
                break
        proc.send_signal(signal.SIGTERM)
        out = proc.stdout.read()
        rc = proc.wait(timeout=120)
    finally:
        killer.cancel()
    assert rc == 0, out[-3000:]
    assert "preempted at iter" in out
    out_dir = root / "output" / "default" / "voc_2007_trainval" / "default"
    step = tckpt.find_previous(str(out_dir), PREFIX)[0]
    assert 2 <= step < 20

    again = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True,
                           text=True, timeout=300)
    assert again.returncode == 0, again.stdout[-3000:] + again.stderr[-3000:]
    assert f"Restored from iter {step}" in again.stdout
    assert tckpt.find_previous(str(out_dir), PREFIX)[0] == 20
    with open(out_dir / f"{PREFIX}_iter_20.pkl", "rb") as f:
        assert pickle.load(f)["step"] == 20
