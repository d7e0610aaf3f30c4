"""The port's data parallelism (``tf_faster_rcnn_torch/parallel``) against
the JAX package and against the port's own single process.

* The data layer's process slicing: for 2 and 4 processes, each rank's
  batch equals the JAX layer's batch for that rank on the same roidb
  (im_info, gt exactly, canvases within 1e-4 as in
  ``tests/test_torch_loader.py``), the ranks' batches together equal the
  one-process global batch exactly, and a global batch that the process
  count does not divide raises.
* The global normalizers, in process: the two images of a batch whose
  labelled-anchor and valid-RoI counts differ, each through
  ``detection_losses`` with a summing seam (two threads that add their
  tensors): the shares summed equal ``detection_losses`` on the whole batch
  and the JAX ``detection_losses`` to 1e-6 relative, and the mean of the
  halves' own losses does not.
* One two-process gloo run on the CPU (``tests/torch_parallel_worker.py``,
  spawned once for the module, its workers free of JAX) for every
  scenario: two data-parallel steps of the tiny vgg16 of
  ``tests/test_multichip.py::_tiny_setup`` (fc6 on 3x3 crops) from a JAX
  state bridged in, with the noise and dropout masks JAX drew, against the
  JAX single-device step on the same global batch of 4 (the losses within
  1e-5 relative, the parameters within 1e-4 of each tensor's largest
  magnitude and the momentum within 1e-4 of the step's largest, the
  whole-step convention of ``tests/test_torch_train.py``); the same with
  the port's own generator against the port's one process; a snapshot of
  one process resumed on two and one of two resumed on one; ``test_net``
  striped over the ranks against the one-process port (equal) and the JAX
  package (the eval tests' tolerances: boxes 1e-3, scores 1e-5, equal
  mAP); the in-training eval recorded by the coordinator only; and the
  ``trainval_net`` CLI with ``--num-procs 2 --device cpu``.
* Small units: ``local_slice`` and ``on_coordinator`` of a rank,
  ``--devices`` above the GPU count, and the MATLAB wrapper's own copy.
  The 'model' axis is ``tests/test_torch_model_axis.py``'s.
"""

import dataclasses
import filecmp
import json
import os
import os.path as osp
import pickle
import shutil
import subprocess
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_worker as worker
from test_torch_backbones import captured_dropout_masks
from test_torch_datasets import make_voc, set_both_cfgs
from test_torch_eval import NET_CFG, SMALL
from test_torch_loader import (LAYER_CFG, _assert_batch_equal,
                               _assert_state_equal)
from test_torch_loader import _roidbs as _layer_roidbs
from test_torch_train import (_assert_score_separation, _jax_noise,
                              _loss_inputs, _rel_close, _t)
from test_torch_train_loop import LOOP_CFG
from tf_faster_rcnn_tpu import config as jconfig
from tf_faster_rcnn_tpu.data import loader as jloader
from tf_faster_rcnn_tpu.datasets import pascal_voc as jvoc
from tf_faster_rcnn_tpu.engine import losses as jlosses
from tf_faster_rcnn_tpu.engine import test_engine as jengine
from tf_faster_rcnn_tpu.engine import train as jtrain
from tf_faster_rcnn_tpu.models import network as jnet
from tf_faster_rcnn_torch import config as tconfig
from tf_faster_rcnn_torch.data import blob as tblob
from tf_faster_rcnn_torch.data import loader as tloader
from tf_faster_rcnn_torch.datasets import pascal_voc as tvoc
from tf_faster_rcnn_torch.engine import losses as tlosses
from tf_faster_rcnn_torch.models import network as tnet
from tf_faster_rcnn_torch.models.init import numpy_params
from tf_faster_rcnn_torch.parallel import dist
from tf_faster_rcnn_torch.parallel.launch import free_port
from tf_faster_rcnn_torch.tools import test_net as test_net_cli
from tf_faster_rcnn_torch.tools import trainval_net
from tf_faster_rcnn_torch.utils.weights import (state_dict_from_flax,
                                                train_state_from_flax)

TESTS = osp.dirname(osp.abspath(__file__))
REPO = osp.dirname(TESTS)
RANKS = 2
B = 4                  # the tiny vgg16's global batch
CANVAS = 64
# the weights' seed: the top RPN scores are separated far beyond the
# frameworks' float32 disagreement (asserted), and the two-process run lands
# within the whole-step convention of the JAX step over two steps. At other
# seeds the tiny net's step is discontinuous within an ulp of its inputs,
# so two float32 runs can differ by up to 7e-4 of the momentum after two
# steps, JAX against itself as much as the port against JAX: measured and
# held by test_one_step_within_the_jax_steps_own_spread at seeds 4, 8, 26
# and 30 as well as this one
SEED = 19
LR = 0.01
LOSS_TOL = 1e-5
STEP_TOL = 1e-4
LOOP_ITERS = 8         # 4 steps at a global batch of 2, the eval at 2, 4
CLI_ITERS = 4


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


# --- the data layer's process slicing ---------------------------------------

@pytest.mark.parametrize("ranks", [2, 4])
def test_loader_process_slicing_matches_jax(tmp_path, ranks):
    make_voc(str(tmp_path), image_set="trainval")
    set_both_cfgs(DATA_DIR=str(tmp_path), **LAYER_CFG)
    jdb, tdb = _layer_roidbs(str(tmp_path))
    whole = tloader.RoIDataLayer(tdb, batch_size=4, device="cpu")
    jlayers = [jloader.RoIDataLayer(jdb, batch_size=4, process_index=r,
                                    process_count=ranks)
               for r in range(ranks)]
    tlayers = [tloader.RoIDataLayer(tdb, batch_size=4, device="cpu",
                                    process_index=r, process_count=ranks)
               for r in range(ranks)]
    for _ in range(2 * len(tdb) // 4 + 1):       # past two epochs
        full = whole.forward()
        parts = [t.forward() for t in tlayers]
        for jl, tl, part in zip(jlayers, tlayers, parts):
            _assert_batch_equal(part, jl.forward())
            _assert_state_equal(tl.get_state(), jl.get_state())
            _assert_state_equal(tl.get_state(), whole.get_state())
        for key, value in full.items():
            assert torch.equal(torch.cat([p[key] for p in parts]), value), key
    with pytest.raises(ValueError, match="not divisible by 3"):
        tloader.RoIDataLayer(tdb, batch_size=4, device="cpu",
                             process_index=0, process_count=3)


# --- the global normalizers ------------------------------------------------

def _half(tpreds, i):
    """Image i of the batch, as its own batch of one."""
    def rows(x):
        return x[i:i + 1]
    out = {k: rows(v) for k, v in tpreds.items() if torch.is_tensor(v)}
    for key in ("anchor_targets", "proposal_targets"):
        out[key] = type(tpreds[key])(*(rows(t) for t in tpreds[key]))
    return out


def _summing_seam(n):
    """n reduce functions, one a thread: each blocks until all n threads
    have called it, then returns the sum of their tensors."""
    barrier = threading.Barrier(n, timeout=60)
    slots = [None] * n

    def for_rank(r):
        def reduce(t):
            slots[r] = t
            barrier.wait()
            total = sum(slots[1:], slots[0])
            barrier.wait()
            return total
        return reduce

    return [for_rank(r) for r in range(n)]


def test_global_normalizers_need_the_seam(rng):
    jpreds, tpreds = _loss_inputs(rng)
    halves = [_half(tpreds, i) for i in range(2)]
    counts = [(int((h["anchor_targets"].labels != -1).sum()),
               int(h["proposal_targets"].valid.sum())) for h in halves]
    assert counts[0][0] != counts[1][0] and counts[0][1] != counts[1][1]
    seams = _summing_seam(2)
    shares = [None, None]

    def run(i):
        shares[i] = tlosses.detection_losses(halves[i], seams[i])

    threads = [threading.Thread(target=run, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    whole = tlosses.detection_losses(tpreds)
    want = jlosses.detection_losses(jpreds, None)
    for key in want:
        got = shares[0][key] + shares[1][key]
        _rel_close(got.numpy(), whole[key].numpy(), 1e-6, key)
        _rel_close(got.numpy(), want[key], 1e-6, key)
    # what DDP's averaging of per-rank losses would train on instead
    own = [tlosses.detection_losses(h) for h in halves]
    for key in ("rpn_cross_entropy", "cross_entropy"):
        mean = float(own[0][key] + own[1][key]) / 2
        assert abs(mean - float(whole[key])) > 1e-3 * abs(float(whole[key]))


# --- the two-process suite ---------------------------------------------------

def _tiny_batch():
    """tests/test_multichip.py::_tiny_setup's batch, at B."""
    rng = np.random.RandomState(0)
    return {
        "image": rng.randn(B, CANVAS, CANVAS, 3).astype(np.float32),
        "im_info": np.tile(np.array([[60.0, 62.0, 1.0]], np.float32),
                           (B, 1)),
        "gt_boxes": np.tile(np.array(
            [[[8, 8, 40, 44, 3], [20, 16, 56, 58, 7]]], np.float32),
            (B, 1, 1)),
        "gt_valid": np.ones((B, 2), bool)}


def _jax_tiny(batch, seed):
    """The JAX tiny vgg16, its state from numpy-drawn params of seed at
    the global batch, and its single-device step."""
    jconfig.cfg.TRAIN.LEARNING_RATE = tconfig.cfg.TRAIN.LEARNING_RATE = LR
    jspec = dataclasses.replace(jnet.spec_from_cfg("vgg16", 21, "TRAIN"),
                                **worker.TINY)
    jmodel = jnet.FasterRCNN(jspec)
    args = [batch[k][:1] for k in ("image", "im_info", "gt_boxes",
                                   "gt_valid")]
    shapes = jax.eval_shape(jmodel.init, {
        "params": jax.random.PRNGKey(0), "sampling": jax.random.PRNGKey(1),
        "dropout": jax.random.PRNGKey(2)}, *args)
    jstate = jtrain.create_train_state(jspec, numpy_params(shapes, seed),
                                       jax.random.PRNGKey(seed), B)
    jstep = jtrain.make_train_step(jmodel, jspec, weight_decay=1e-4,
                                   mobile_weight_decay=4e-5, donate=False,
                                   nan_guard=True)
    return jmodel, jstate, jstep


def _jax_step_noise(jmodel, jstate, batch):
    """The TrainNoise, with its dropout masks, that the JAX step draws
    from jstate; the forward on it held to the port's on the same params
    and noise by the separation guard."""
    tspec = dataclasses.replace(tnet.spec_from_cfg("vgg16", 21, "TRAIN"),
                                **worker.TINY)
    inputs = [batch[k] for k in ("image", "im_info", "gt_boxes", "gt_valid")]
    n_anchors = (CANVAS // 16) ** 2 * tspec.num_anchors
    key, noise = _jax_noise(jmodel, jstate.key, B, n_anchors,
                            tspec.rpn_post_nms_top_n)
    rngs = {"sampling": key, "dropout": jax.random.fold_in(key, 1)}
    masks = captured_dropout_masks(lambda p: jmodel.apply(
        p, *inputs, rngs=rngs), jstate.params)
    noise = noise._replace(dropout=tuple(_t(m) for m in masks))
    jout = jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda p: jmodel.apply(p, *inputs, rngs=rngs))(jstate.params))
    tmodel = tnet.FasterRCNN(tspec, device="cpu")
    tmodel.load_state_dict(train_state_from_flax(jstate)["params"])
    with torch.no_grad():
        tout = tmodel(*(torch.from_numpy(x) for x in inputs), noise=noise)
    _assert_score_separation(jout, tout, tspec.rpn_post_nms_top_n)
    return noise


def _jax_steps(batch):
    """Two JAX single-device steps of the tiny vgg16 on the global batch,
    from numpy-drawn params: (the initial state bridged, each step's noise
    with its dropout masks, each step's metrics, the final state
    bridged)."""
    jmodel, jstate, jstep = _jax_tiny(batch, SEED)
    initial = train_state_from_flax(jstate)
    noises, metrics = [], []
    for _ in range(2):
        noises.append(_jax_step_noise(jmodel, jstate, batch))
        jstate, jm = jstep(jstate, batch)
        metrics.append({k: float(v) for k, v in jm.items()})
    return initial, noises, metrics, train_state_from_flax(jstate)


def _mobile_weights(path):
    """tests/test_torch_eval.py's mobile weights (numpy-drawn, seed 3),
    saved as the port's state_dict."""
    from test_torch_eval import SEED as EVAL_SEED
    jspec = dataclasses.replace(jnet.spec_from_cfg("mobile", 21, "TEST"),
                                **SMALL)
    shapes = jax.eval_shape(jnet.FasterRCNN(jspec).init,
                            jax.random.PRNGKey(0),
                            jnp.zeros((1, 96, 128, 3)),
                            jnp.array([[96.0, 128.0, 1.0]]))
    params = numpy_params(shapes, EVAL_SEED)
    torch.save(state_dict_from_flax(params), path)
    return jspec, params


def _cli_set(root, loop_cfg):
    sets = ["DATA_DIR", str(root), "ROOT_DIR", str(root)]
    for key, value in loop_cfg.items():
        sets += [key, str(value).replace(" ", "")]
    return sets


@pytest.fixture(scope="module")
def suite(tmp_path_factory):
    """The inputs, the one-process references that the workers' inputs
    depend on, and the two workers' results."""
    work = tmp_path_factory.mktemp("torch_dp")
    tconfig.reset_cfg()
    jconfig.reset_cfg()
    batch = _tiny_batch()
    try:
        initial, noises, jmetrics, jfinal = _jax_steps(batch)
    finally:
        jconfig.reset_cfg()
    voc = work / "voc"
    make_voc(str(voc), image_set="trainval")
    make_voc(str(voc), image_set="test")
    jspec, mobile_params = _mobile_weights(str(work / "mobile.pt"))
    loop_2p = dict(LOOP_CFG, **{"TPU.IMS_PER_DEVICE": 1,
                                "TPU.EVAL_ITERS": 4})
    inputs = {
        "state": initial, "batch": batch, "global_batch": B,
        "learning_rate": LR, "jax_noise": noises, "voc": str(voc),
        "weights": str(work / "mobile.pt"), "eval_cfg": NET_CFG,
        "eval_spec": SMALL, "loop_cfg_2p": loop_2p,
        "loop_iters": LOOP_ITERS, "cli_iters": CLI_ITERS,
        "cli_set": _cli_set(voc, dict(LOOP_CFG,
                                      **{"TPU.IMS_PER_DEVICE": 1}))}
    # the port's one process: its own noise, then a snapshot for the
    # two-process resume
    tconfig.cfg.TRAIN.LEARNING_RATE = LR
    one = worker.steps(inputs, snapshot_dir=str(work / "snap_1p"))
    inputs["snap_1p"] = one["snapshot"]
    tconfig.reset_cfg()
    with open(work / "inputs.pkl", "wb") as f:
        pickle.dump(inputs, f)

    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    cmd = [sys.executable, osp.join(TESTS, "torch_parallel_worker.py")]
    ports = set()
    while len(ports) < 2:
        ports.add(str(free_port()))
    procs = [subprocess.Popen(cmd + [str(r), str(RANKS)] + sorted(ports)
                              + [str(work)], env=env, cwd=str(work),
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT)
             for r in range(RANKS)]
    logs = [p.communicate(timeout=900)[0].decode(errors="replace")
            for p in procs]
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"rank {r} failed:\n{logs[r][-4000:]}"
    got = []
    for r in range(RANKS):
        with open(work / f"rank{r}.pkl", "rb") as f:
            got.append(pickle.load(f))
        os.remove(work / f"rank{r}.pkl")
    os.remove(work / "inputs.pkl")
    yield {"work": work, "inputs": inputs, "got": got, "one": one,
           "jax": (jmetrics, jfinal), "mobile": (jspec, mobile_params)}
    # the states and snapshots of the tiny vgg16 weigh ~400 MB each
    shutil.rmtree(work, ignore_errors=True)


def _assert_step_close(got, want_metrics, want_state, name):
    """The losses within LOSS_TOL relative; the parameters within STEP_TOL
    of each tensor's largest, the momentum within STEP_TOL of the step's
    largest."""
    for i, (g, w) in enumerate(zip(got["metrics"], want_metrics)):
        for key in tlosses.LOSS_KEYS + ("total_loss",
                                        "regularization_loss"):
            _rel_close(g[key], w[key], LOSS_TOL, f"{name} step {i} {key}")
        assert g["step_skipped"] == 0.0
    for key, value in got["params"].items():
        _rel_close(value.numpy(), want_state["params"][key].numpy(),
                   STEP_TOL, f"{name} {key}")
    scale = max(float(t.abs().max()) for t in want_state["trace"].values())
    for key, value in got["trace"].items():
        err = float((value - want_state["trace"][key]).abs().max())
        assert err <= STEP_TOL * scale, (name, key, err / scale)


def test_workers_import_no_jax_and_hold_one_state(suite):
    for res in suite["got"]:
        assert res["imported"] == [], res["imported"]
    a, b = suite["got"]
    for scenario in ("jax_noise", "own_noise", "restored"):
        assert a[scenario]["metrics"] == b[scenario]["metrics"]
        assert a[scenario]["fingerprint"] == b[scenario]["fingerprint"]
        assert a[scenario]["fingerprint"] == (
            worker.fingerprint(a[scenario]["params"]),
            worker.fingerprint(a[scenario]["trace"]))


def test_two_process_step_matches_the_jax_single_device_step(suite):
    jmetrics, jfinal = suite["jax"]
    got = suite["got"][0]["jax_noise"]
    assert got["step"] == jfinal["step"] == 2
    _assert_step_close(got, jmetrics, jfinal, "dp2 vs JAX")


def _ulp_moved(params, draw):
    """params with every element moved one float32 ulp, up or down as a
    numpy draw of seed draw says."""
    rng = np.random.RandomState(draw)

    def move(x):
        x = np.asarray(x)
        up = rng.rand(*x.shape) < 0.5
        toward = np.where(up, np.inf, -np.inf).astype(x.dtype)
        return np.nextafter(x, toward)

    return jax.tree_util.tree_map(move, params)


def _trace_err(got, want):
    """The largest |difference| of the momentum tensors in got, over the
    largest magnitude of want's among them."""
    scale = max(float(want[k].abs().max()) for k in got)
    return max(float((v - want[k]).abs().max()) for k, v in got.items()) / (
        scale)


@pytest.mark.parametrize("seed", [4, 8, SEED, 26, 30])
def test_one_step_within_the_jax_steps_own_spread(seed):
    """Why SEED, and why the steps after a restore are one: at random
    weights the tiny vgg16's step is discontinuous close to its inputs
    (one float32 ulp of the parameters moves JAX's own gradient by up to
    5e-4 of the largest, and the port's anchor and RoI labels do not flip
    under it, so a max-pool's argmax or a ReLU's sign is what is left), and
    two float32 runs that round differently can land a bias's gradient on
    either side. One step of the port's one process on the JAX noise
    against the JAX step, at five weight seeds: the momentum within
    STEP_TOL of the largest, or, where it is farther, the JAX step itself
    moves at least half as far when its parameters move by one ulp (one of
    three draws). Measured on the CPU: the port 7.1e-6, 4.7e-4, 1.2e-7,
    5.1e-5 and 1.3e-4 from JAX at seeds 4, 8, 19, 26 and 30; JAX from
    itself under a one-ulp move up to 4.7e-4 at seed 8 and 5.5e-4 at seed
    30. After a second step the spread grows at every seed (2.1e-4 to
    6.9e-4 port to JAX, 2.4e-4 to 7.1e-4 JAX to itself under a 2^-20
    relative move), which is why the two-step test keeps seed 19, where
    the two-process run lands within 1e-4."""
    batch = _tiny_batch()
    try:
        jmodel, j0, jstep = _jax_tiny(batch, seed)
        noise = _jax_step_noise(jmodel, j0, batch)
        want = train_state_from_flax(jstep(j0, batch)[0])["trace"]
        inputs = {"state": train_state_from_flax(j0), "batch": batch,
                  "global_batch": B, "learning_rate": LR}
        got = worker.steps(inputs, noises=[noise], n=1)["trace"]
        err = _trace_err(got, want)
        if err <= STEP_TOL:
            return
        spread = 0.0
        for draw in range(100, 103):
            moved = jstep(j0.replace(params=_ulp_moved(j0.params, draw)),
                          batch)[0]
            trace = train_state_from_flax(moved)["trace"]
            spread = max(spread, _trace_err({k: trace[k] for k in got},
                                            want))
    finally:
        jconfig.reset_cfg()
    assert spread >= err / 2, (seed, err, spread)


def test_two_process_own_noise_matches_one_process(suite):
    one = suite["one"]
    got = suite["got"][0]["own_noise"]
    assert got["step"] == one["step"] == 2
    _assert_step_close(got, one["metrics"], one, "dp2 vs 1 process")


def test_cross_process_count_restore(suite):
    """A one-process snapshot resumes on two processes, and the
    two-process snapshot (the coordinator's alone) on one, both equal to
    the one-process resume over the step after it. One step: over a second
    one this random net's ReLU boundaries turn the runs' reduction-order
    difference (1e-7) into 1e-4 of the momentum."""
    inputs = suite["inputs"]
    tconfig.cfg.TRAIN.LEARNING_RATE = LR
    ref = worker.steps(inputs, restore=inputs["snap_1p"], n=1)
    assert ref["step"] == 3
    got = suite["got"]
    assert got[0]["restored"]["step"] == 3
    _assert_step_close(got[0]["restored"], ref["metrics"], ref, "1p -> 2p")
    snap = got[0]["own_noise"]["snapshot"]
    assert snap and got[1]["own_noise"]["snapshot"] is None
    assert sorted(os.listdir(osp.dirname(snap))) == [
        f"{worker.PREFIX}_iter_2.pkl", f"{worker.PREFIX}_iter_2.pt"]
    back = worker.steps(inputs, restore=snap, n=1)
    assert back["step"] == 3
    _assert_step_close(back, ref["metrics"], ref, "2p -> 1p")


def test_striped_test_net_matches_one_process_and_jax(suite, monkeypatch):
    work, inputs = suite["work"], suite["inputs"]
    assert suite["got"][1]["eval_map"] is None
    tmap2 = suite["got"][0]["eval_map"]
    with open(work / "eval_2p" / "detections.pkl", "rb") as f:
        merged = pickle.load(f)
    assert not [p for p in os.listdir(work / "eval_2p") if ".part" in p]
    tmap1 = worker.striped_eval(inputs, str(work / "eval_1p"))
    with open(work / "eval_1p" / "detections.pkl", "rb") as f:
        one = pickle.load(f)

    # the JAX engine on the same canvases (tests/test_torch_eval.py)
    def port_prep(im, pixel_means, target_size, max_size):
        out, scale = tblob.prep_im_for_blob(torch.from_numpy(im),
                                            pixel_means, target_size,
                                            max_size)
        return out.numpy(), scale
    monkeypatch.setattr(jengine, "prep_im_for_blob", port_prep)
    set_both_cfgs(DATA_DIR=inputs["voc"], ROOT_DIR=inputs["voc"], **NET_CFG)
    jspec, params = suite["mobile"]
    jmap = jengine.test_net(jnet.FasterRCNN(jspec), jspec, params,
                            jvoc.pascal_voc("test", "2007"), "w",
                            max_per_image=100,
                            output_dir=str(work / "eval_jax"))
    with open(work / "eval_jax" / "detections.pkl", "rb") as f:
        jboxes = pickle.load(f)
    assert tmap2 == tmap1 == jmap
    n_dets = 0
    for c in range(1, 21):
        for i in range(8):
            t = merged[c][i]
            assert isinstance(t, np.ndarray), (c, i)
            np.testing.assert_array_equal(t, one[c][i])
            assert t.shape == jboxes[c][i].shape, (c, i)
            np.testing.assert_allclose(t[:, :4], jboxes[c][i][:, :4],
                                       rtol=0, atol=1e-3)
            np.testing.assert_allclose(t[:, 4], jboxes[c][i][:, 4], rtol=0,
                                       atol=1e-5)
            n_dets += len(t)
    assert n_dets > 0


def test_in_training_eval_is_the_coordinators(suite, tmp_path):
    """Only the coordinator records val_mAP, once an eval, equal to one
    process at the same global batch; the merged final eval covers every
    image; the snapshots are the coordinator's."""
    work, inputs = suite["work"], suite["inputs"]
    assert [r["loop_step"] for r in suite["got"]] == [4, 4]
    with open(work / "loop_2p_tb" / "metrics.jsonl") as f:
        records = [json.loads(line) for line in f]
    got = [(r["step"], r["val_mAP"]) for r in records if "val_mAP" in r]
    assert [s for s, _ in got] == [2, 4]
    loop_1p = dict(inputs["loop_cfg_2p"], **{"TPU.IMS_PER_DEVICE": 2})
    step = worker.train_with_eval(inputs["voc"], loop_1p,
                                  str(tmp_path / "out"), str(tmp_path / "tb"),
                                  LOOP_ITERS)
    assert step == 4
    with open(tmp_path / "tb" / "metrics.jsonl") as f:
        want = [(r["step"], r["val_mAP"]) for r in map(json.loads, f)
                if "val_mAP" in r]
    assert [s for s, _ in want] == [2, 4]
    np.testing.assert_allclose([v for _, v in got], [v for _, v in want],
                               atol=1e-3)
    with open(work / "loop_2p" / "val_eval_iter_4" / "detections.pkl",
              "rb") as f:
        boxes = pickle.load(f)
    assert all(isinstance(boxes[c][i], np.ndarray)
               for c in range(1, 21) for i in range(8))
    snaps = sorted(p for p in os.listdir(work / "loop_2p")
                   if p.startswith("res101_faster_rcnn_iter_"))
    assert snaps == sorted(f"res101_faster_rcnn_iter_{s}.{e}"
                           for s in (2, 4) for e in ("pt", "pkl"))


def test_trainval_net_cli_on_two_processes(suite):
    assert [r["cli_step"] for r in suite["got"]] == [2, 2]
    out = osp.join(suite["inputs"]["voc"], "output", "default",
                   "voc_2007_trainval", "default")
    assert sorted(os.listdir(out)) == [
        "res101_faster_rcnn_iter_2.pkl", "res101_faster_rcnn_iter_2.pt"]


def test_test_net_cli_devices_two_on_the_cpu(suite, tmp_path):
    """tools.test_net --devices 2 --device cpu spawns two gloo ranks; its
    detections.pkl equals one process's."""
    inputs = suite["inputs"]
    root = tmp_path / "voc"
    make_voc(str(root))
    sets = ["DATA_DIR", str(root), "ROOT_DIR", str(root)]
    for key, value in NET_CFG.items():
        sets += [key, repr(value).replace(" ", "")]
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    subprocess.run([sys.executable, "-m", "tf_faster_rcnn_torch.tools."
                    "test_net", "--net", "mobile", "--imdb", "voc_2007_test",
                    "--model", inputs["weights"], "--device", "cpu",
                    "--devices", "2", "--set"] + sets, env=env, check=True,
                   cwd=str(tmp_path), capture_output=True, timeout=600)
    got = osp.join(root, "output", "default", "voc_2007_test", "mobile.pt",
                   "detections.pkl")
    worker.striped_eval(dict(inputs, voc=str(root)), str(tmp_path / "one"))
    with open(got, "rb") as f, open(tmp_path / "one" / "detections.pkl",
                                    "rb") as g:
        two, one = pickle.load(f), pickle.load(g)
    for c in range(1, 21):
        for i in range(8):
            np.testing.assert_array_equal(two[c][i], one[c][i])


# --- small units ------------------------------------------------------------

def test_local_slice_and_coordinator(monkeypatch):
    assert (dist.process_index(), dist.process_count()) == (0, 1)
    assert dist.on_coordinator() and dist.local_slice(8, 0, 1) == slice(0, 8)
    assert dist.local_slice(8, 1, 2) == slice(4, 8)
    assert dist.local_slice(8, 3, 4) == slice(6, 8)
    with pytest.raises(ValueError, match="not divisible"):
        dist.local_slice(7, 0, 2)
    monkeypatch.setattr(dist, "process_index", lambda: 1)
    monkeypatch.setattr(dist, "process_count", lambda: 2)
    assert not dist.on_coordinator()


@pytest.mark.parametrize("cli", [trainval_net, test_net_cli])
def test_devices_above_the_gpu_count_exit(cli):
    n = torch.cuda.device_count()
    with pytest.raises(SystemExit, match=f"this host has {n}"):
        cli.main(["--devices", str(n + 1)])


def test_drivers_pass_devices_and_multihost_flags(tmp_path, monkeypatch):
    """DEVICES and the multi-host flags reach both stages' CLIs, whose own
    parsers read the forwarded commands as the ranks asked for: DEVICES
    ranks on this host, or this process as one rank under the multi-host
    flags, where DEVICES above 1 is refused before any stage runs."""
    from tf_faster_rcnn_torch.parallel.launch import local_ranks
    from tf_faster_rcnn_torch.tools import (test_faster_rcnn,
                                            train_faster_rcnn)
    rundir = tmp_path / "output" / "mobile" / "voc_2007_trainval" / "default"
    rundir.mkdir(parents=True)
    (rundir / "mobile_faster_rcnn_iter_3.pt").write_bytes(b"")
    calls = []
    for module in (train_faster_rcnn, test_faster_rcnn):
        monkeypatch.setattr(module, "run_logged",
                            lambda cmd, log: calls.append(cmd))
    monkeypatch.setattr(test_faster_rcnn, "log_path", lambda name: name)
    monkeypatch.setattr(train_faster_rcnn, "log_path", lambda name: name)
    parsers = {"tf_faster_rcnn_torch.tools.trainval_net":
               trainval_net.build_parser().parse_args,
               "tf_faster_rcnn_torch.tools.test_net": test_net_cli.parse_args}
    flags = ["--coordinator", "host0:29500", "--num-procs", "4",
             "--proc-id", "3"]
    common = ["pascal_voc", "mobile", "--device", "cpu", "--tag", "",
              "--output-root", str(tmp_path)]
    for devices, extra, ranks in (("2", [], 2), ("1", flags, 1)):
        calls.clear()
        train_faster_rcnn.main([devices] + common + extra)
        assert [c[2] for c in calls] == list(parsers)
        for cmd in calls:
            args = parsers[cmd[2]](cmd[3:])
            assert args.devices == int(devices)
            assert (args.coordinator, args.num_procs, args.proc_id) == (
                ("host0:29500", 4, 3) if extra else (None, None, None))
            assert local_ranks(args) == ranks
    calls.clear()
    with pytest.raises(SystemExit, match="DEVICES 2: .*multi-host"):
        train_faster_rcnn.main(["2"] + common + flags)
    with pytest.raises(SystemExit, match="DEVICES 2: .*multi-host"):
        test_faster_rcnn.main(["2"] + common + flags)
    assert calls == []


def test_matlab_wrapper_is_the_ports_own(tmp_path, monkeypatch):
    names = ("get_voc_opts.m", "voc_eval.m", "xVOCap.m")
    ours = osp.join(REPO, "tf_faster_rcnn_torch", "datasets",
                    "VOCdevkit-matlab-wrapper")
    theirs = osp.join(REPO, "tf_faster_rcnn_tpu", "datasets",
                      "VOCdevkit-matlab-wrapper")
    assert sorted(os.listdir(ours)) == list(names)
    for name in names:
        assert filecmp.cmp(osp.join(ours, name), osp.join(theirs, name),
                           shallow=False), name
    make_voc(str(tmp_path))
    set_both_cfgs(DATA_DIR=str(tmp_path), ROOT_DIR=str(tmp_path))
    calls = []
    monkeypatch.setattr(tvoc.subprocess, "call",
                        lambda cmd, cwd=None: calls.append(cwd))
    tvoc.pascal_voc("test", "2007")._matlab_eval(str(tmp_path))
    assert calls == [ours]
