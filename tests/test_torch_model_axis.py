"""The port's 'model' axis (``parallel/mesh.py``'s ('data', 'model') mesh,
``parallel/tensor_parallel.py``, ``parallel/spatial.py``) against the JAX
package and against the port's own single rank.

* The TP layout, in process: for every tensor of vgg16, res50, res101 and
  mobile and for its momentum entry, the port's split dim
  (``mesh.tp_dim``) is the JAX ``tp_pspec``'s 'model' axis mapped through
  the weight bridge (``utils/weights.py::state_dict_from_flax``), by name.
* One four-process gloo run on the CPU laid out as a 2 x 2 mesh
  (``tests/torch_model_axis_worker.py``, spawned once for the module, its
  workers free of JAX):
  - halo ops: ``conv2d_same`` at stride 1 and 2 (7x7 and depthwise too),
    the res stem's pool, vgg16's SAME pool, the strided shortcut and
    ``mask_valid`` on 2 and 3 row shards, even and uneven, forward and
    input gradient within 1e-6 of the unsplit op (float64);
  - ``shard_params`` then ``gather_params`` lossless for vgg16, res50 and
    mobile, each rank holding its slice;
  - one 2 x 2 step of the tiny vgg16 of ``tests/test_multichip.py::
    _tiny_setup`` (fc6 on 3x3 crops; TP fc6/fc7 and SP) from the JAX state
    bridged in, with the noise and dropout masks JAX drew, against the JAX
    single-device step at that test's tolerances (loss rtol 1e-5,
    parameters rtol 5e-4 / atol 1e-6; seed 19, where the port lands within
    1.2e-7 of JAX's momentum: ROADMAP Queue C);
  - the res50 TEST forward at 2 x 2 (TP + SP) against the JAX
    single-device forward at ``test_hybrid_tp_detect_matches_single_
    device``'s sizes and tolerances;
  - a snapshot written at 2 x 2 resumes at one rank, and one rank's at 2 x
    2: the next step within 1e-6 of the unbroken run's;
  - the ``test_net`` and ``trainval_net`` CLIs' rank function (what
    ``--devices 4`` runs in each rank) at ``TPU.MODEL_DEVICES 2``: the
    detections and the step of one process.
* The CLIs' refusals, in process: ``--devices 3`` with MODEL_DEVICES 2,
  and the multi-host flags with MODEL_DEVICES 2 ("single-host only").
"""

import dataclasses
import os
import os.path as osp
import pickle
import shutil
import subprocess
import sys
import time

import jax
import numpy as np
import pytest
import torch

import torch_model_axis_worker as worker
from test_torch_datasets import make_voc
from test_torch_eval import NET_CFG
from test_torch_parallel import (B, LR, SEED, STEP_TOL, _cli_set,
                                 _jax_step_noise, _jax_tiny,
                                 _mobile_weights, _tiny_batch)
from test_torch_train import _rel_close
from test_torch_train_loop import LOOP_CFG
from tf_faster_rcnn_tpu import config as jconfig
from tf_faster_rcnn_tpu.engine import train as jtrain
from tf_faster_rcnn_tpu.models import network as jnet
from tf_faster_rcnn_tpu.parallel import mesh as jmesh
from tf_faster_rcnn_torch import config as tconfig
from tf_faster_rcnn_torch.engine import losses as tlosses
from tf_faster_rcnn_torch.models import network as tnet
from tf_faster_rcnn_torch.models.init import numpy_params
from tf_faster_rcnn_torch.parallel import mesh
from tf_faster_rcnn_torch.parallel.launch import free_port
from tf_faster_rcnn_torch.tools import test_net as test_net_cli
from tf_faster_rcnn_torch.tools import trainval_net
from tf_faster_rcnn_torch.utils.weights import (state_dict_from_flax,
                                                train_state_from_flax)

TESTS = osp.dirname(osp.abspath(__file__))
REPO = osp.dirname(TESTS)
HALO_TOL = 1e-6
RESUME_TOL = 1e-6
LOSS_RTOL = 1e-5
PARAM_RTOL, PARAM_ATOL = 5e-4, 1e-6
DETECT_TOL = {"cls_prob": (1e-4, 1e-5), "bbox_pred": (1e-4, 1e-4)}
TRAINVAL_ITERS = 2     # one step at the global batch of 2
WORKER_TIMEOUT_S = 300
# the split tensors of the JAX params and of its momentum trace (which,
# unlike the port's, holds FrozenBN's arrays: flax params, torch buffers)
TP_SPLIT = {"vgg16": (3, 3), "res50": (18, 18), "res101": (18, 18),
            "mobile": (0, 0)}


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


# --- the TP layout against JAX's tp_pspec ----------------------------------

def _bridged_dim(path, ndim, axis):
    """(the port's name, its split dim) of the flax leaf at path (a tuple
    under 'params') whose axis is split, through the weight bridge: a
    marker array long on that axis alone."""
    marker = np.zeros([2 if i == axis else 1 for i in range(ndim)],
                      np.float32)
    tree = node = {}
    for part in path[:-1]:
        node = node.setdefault(part, {})
    node[path[-1]] = marker
    (name, t), = state_dict_from_flax(tree).items()
    return name, (None if axis is None else list(t.shape).index(2))


def _model_axis(spec):
    axes = [i for i, a in enumerate(spec) if a == jmesh.MODEL_AXIS]
    return axes[0] if axes else None


@pytest.mark.parametrize("backbone", ["vgg16", "res50", "res101", "mobile"])
def test_tp_layout_equals_jax_tp_pspec(backbone):
    jspec = jnet.spec_from_cfg(backbone, 21, "TEST")
    shapes = jax.eval_shape(
        jnet.FasterRCNN(jspec).init, jax.random.PRNGKey(0),
        jax.ShapeDtypeStruct((1, 64, 64, 3), np.float32),
        jax.ShapeDtypeStruct((1, 3), np.float32))
    jstate = jax.eval_shape(lambda p: jtrain.create_train_state(
        jspec, p, jax.random.PRNGKey(0)), shapes)
    with torch.device("meta"):
        names = set(tnet.FasterRCNN(
            tnet.ModelSpec(backbone, 21), device="meta").state_dict())
    seen, split = set(), {"params/": 0, "trace/": 0}
    for tree, prefix in ((shapes, "params/"), (jstate.opt_state, "trace/")):
        for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
            pstr = jmesh._path_str(path)
            if prefix not in pstr:
                continue
            axis = _model_axis(jmesh.tp_pspec(pstr, backbone))
            rel = tuple(pstr.split(prefix, 1)[1].split("/"))
            name, want = _bridged_dim(rel, len(leaf.shape), axis)
            assert name in names, name
            assert mesh.tp_dim(name, backbone) == want, (pstr, name, want)
            seen.add((prefix, name))
            split[prefix] += want is not None
    # every tensor of the model
    assert {n for p, n in seen if p == "params/"} == names
    assert (split["params/"], split["trace/"]) == TP_SPLIT[backbone]


# --- the four-process suite -------------------------------------------------

def _res50_inputs():
    """The res50 TEST forward of tests/test_multichip.py at its sizes, on
    numpy-drawn parameters: (images, its forward's outputs, the
    bridged parameters)."""
    jspec = dataclasses.replace(jnet.spec_from_cfg("res50", 21, "TEST"),
                                **worker.RES50)
    jmodel = jnet.FasterRCNN(jspec)
    rng = np.random.RandomState(1)
    image = rng.randn(2, 64, 64, 3).astype(np.float32)
    im_info = np.tile(np.array([[60.0, 62.0, 1.0]], np.float32), (2, 1))
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), image[:1],
                            im_info[:1])
    params = numpy_params(shapes, 5)
    out = jax.jit(jmodel.apply)(params, image, im_info)
    want = {k: np.asarray(out[k]) for k in DETECT_TOL}
    return ({"image": image, "im_info": im_info}, want,
            state_dict_from_flax(params))


def _one_rank_steps(inputs, snapshot_dir=None, restore=None, n=2):
    tconfig.cfg.TRAIN.LEARNING_RATE = LR
    try:
        return worker.steps(inputs, None, snapshot_dir=snapshot_dir,
                            restore=restore, n=n)
    finally:
        tconfig.reset_cfg()


def _voc_argv(root, weights):
    sets = ["DATA_DIR", str(root), "ROOT_DIR", str(root)]
    for key, value in NET_CFG.items():
        sets += [key, repr(value).replace(" ", "")]
    return ["--net", "mobile", "--imdb", "voc_2007_test", "--model",
            weights, "--device", "cpu", "--set"] + sets


def _trainval_argv(root, model_devices):
    """The global batch of 2: one image a data group at 2 x 2."""
    loop = dict(LOOP_CFG, **{"TPU.IMS_PER_DEVICE": 2 // model_devices,
                             "TPU.MODEL_DEVICES": model_devices})
    return ["--net", "mobile", "--imdb", "voc_2007_trainval", "--imdbval",
            "voc_2007_test", "--iters", str(TRAINVAL_ITERS), "--device",
            "cpu", "--set"] + _cli_set(root, loop)


def _hand_over(work, name, inputs):
    """inputs to work/name, atomically: the ranks poll for the name."""
    with open(work / (name + ".tmp"), "wb") as f:
        pickle.dump(inputs, f)
    os.replace(work / (name + ".tmp"), work / name)


def _spawn_workers(work):
    """The four ranks, started before their inputs exist (they run the
    scenarios that need none first), each writing to a log file (a pipe
    that nobody reads while the test computes the inputs would fill and
    stop a rank inside a collective)."""
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    cmd = [sys.executable, osp.join(TESTS, "torch_model_axis_worker.py")]
    port = str(free_port())
    procs = []
    for r in range(worker.RANKS):
        with open(work / f"rank{r}.log", "w") as log:
            procs.append(subprocess.Popen(
                cmd + [str(r), port, str(work)], env=env,
                cwd=str(work), stdout=log, stderr=subprocess.STDOUT))
    return procs


@pytest.fixture(scope="module")
def suite(tmp_path_factory):
    """The inputs, the references that the workers' inputs depend on, the
    one-rank run that the restores continue, and the four workers'
    results."""
    work = tmp_path_factory.mktemp("torch_model_axis")
    procs = _spawn_workers(work)
    try:
        tconfig.reset_cfg()
        jconfig.reset_cfg()
        batch = _tiny_batch()
        try:
            jmodel, jstate, jstep = _jax_tiny(batch, SEED)
            initial = train_state_from_flax(jstate)
            noise = _jax_step_noise(jmodel, jstate, batch)
            jstate, jm = jstep(jstate, batch)
            jmetrics = {k: float(v) for k, v in jm.items()}
        finally:
            jconfig.reset_cfg()
        inputs = {"state": initial, "batch": batch, "global_batch": B,
                  "learning_rate": LR, "jax_noise": [noise]}
        # the port's one rank: a step and its snapshot, which the 2 x 2
        # ranks resume; written before the inputs that name it
        first = _one_rank_steps(inputs, snapshot_dir=str(work / "snap_1"),
                                n=1)
        inputs["snap_1"] = first["snapshot"]
        _hand_over(work, "inputs.pkl", inputs)
        try:
            res50_batch, res50_want, res50_params = _res50_inputs()
        finally:
            jconfig.reset_cfg()
        voc = work / "voc"
        make_voc(str(voc), image_set="trainval")
        make_voc(str(voc), image_set="test")
        _mobile_weights(str(work / "mobile.pt"))
        more = {"res50_params": res50_params, "res50_batch": res50_batch,
                "test_net_argv": _voc_argv(voc, str(work / "mobile.pt")) + [
                    "TPU.MODEL_DEVICES", "2"],
                "trainval_argv": _trainval_argv(voc, 2)}
        _hand_over(work, "more_inputs.pkl", more)
        inputs.update(more)
        # the unbroken one-rank run, while the ranks work
        unbroken = _one_rank_steps(inputs, n=3)
        deadline = time.time() + WORKER_TIMEOUT_S
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.time()))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, p in enumerate(procs):
        with open(work / f"rank{r}.log") as f:
            log = f.read()
        assert p.returncode == 0, f"rank {r} failed:\n{log[-4000:]}"
    got = []
    for r in range(worker.RANKS):
        with open(work / f"rank{r}.pkl", "rb") as f:
            got.append(pickle.load(f))
    yield {"work": work, "inputs": inputs, "got": got,
           "jax": (jmetrics, train_state_from_flax(jstate)),
           "res50": res50_want, "voc": voc, "unbroken": unbroken}
    shutil.rmtree(work, ignore_errors=True)


def test_workers_import_no_jax_and_sit_on_a_2x2_mesh(suite):
    got = suite["got"]
    assert [r["coords"] for r in got] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    for res in got:
        assert res["imported"] == [], res["imported"]
    # every rank holds the same layout-free state and metrics
    for scenario in ("jax_noise", "resumed"):
        assert len({r[scenario]["fingerprint"] for r in got}) == 1
        assert all(r[scenario]["metrics"] == got[0][scenario]["metrics"]
                   for r in got)
        # SP ran: each rank held half the canvas's rows
        assert got[0][scenario]["canvas_h"] == 64
        assert got[0][scenario]["rows"][1] == 32


def test_halo_ops_equal_the_unsplit_ops(suite):
    errors = {}
    for res in suite["got"]:
        for key, (fwd, grad, same_shape) in res["halo"].items():
            assert same_shape, key
            worst = errors.get(key, (0.0, 0.0))
            errors[key] = (max(worst[0], fwd), max(worst[1], grad))
    assert {(c, h) for c, h, _ in errors} == {
        (c, h) for c, rows in worker.HALO_ROWS.items() for h in rows}
    bad = {k: v for k, v in errors.items() if max(v) > HALO_TOL}
    assert not bad, bad


def test_shard_and_gather_are_lossless(suite):
    for res in suite["got"]:
        for backbone, out in res["layout"].items():
            assert out["lossless"], (res["rank"], backbone)
    shapes = suite["got"][1]["layout"]
    assert shapes["vgg16"]["shapes"]["tail.fc6.weight"] == (2048, 512)
    assert shapes["vgg16"]["shapes"]["trace:tail.fc7.weight"] == (4096,
                                                                  2048)
    assert shapes["res50"]["shapes"][
        "tail.block4.unit_2.conv1.bn.var"] == (256,)
    assert shapes["res50"]["shapes"][
        "trace:tail.block4.unit_3.conv2.conv.weight"] == (512, 256, 3, 3)
    assert shapes["mobile"]["shapes"]["tail.base.conv2d_13.pointwise."
                                      "weight"] == (256, 256, 1, 1)


def test_hybrid_step_matches_the_jax_single_device_step(suite):
    jmetrics, jfinal = suite["jax"]
    got = suite["got"][0]["jax_noise"]
    assert got["step"] == jfinal["step"] == 1
    m = got["metrics"][0]
    assert m["step_skipped"] == 0.0
    for key in tlosses.LOSS_KEYS + ("total_loss", "regularization_loss"):
        np.testing.assert_allclose(m[key], jmetrics[key], rtol=LOSS_RTOL,
                                   err_msg=key)
    for key, value in got["params"].items():
        np.testing.assert_allclose(value.numpy(),
                                   jfinal["params"][key].numpy(),
                                   rtol=PARAM_RTOL, atol=PARAM_ATOL,
                                   err_msg=key)
    scale = max(float(t.abs().max()) for t in jfinal["trace"].values())
    for key, value in got["trace"].items():
        err = float((value - jfinal["trace"][key]).abs().max())
        assert err <= STEP_TOL * scale, (key, err / scale)


def test_hybrid_detect_matches_the_jax_single_device_forward(suite):
    want = suite["res50"]
    parts = [suite["got"][r]["detect"] for r in (0, 2)]
    assert suite["got"][1]["detect"] is None
    for key, (rtol, atol) in DETECT_TOL.items():
        got = torch.cat([p[key] for p in parts]).numpy()
        np.testing.assert_allclose(got, want[key], rtol=rtol, atol=atol,
                                   err_msg=key)


def _assert_resumed(got, want, step, name):
    """got's last step within RESUME_TOL of the unbroken run's step."""
    for key in tlosses.LOSS_KEYS + ("total_loss",):
        _rel_close(got["metrics"][-1][key], want["metrics"][step - 1][key],
                   RESUME_TOL, f"{name} {key}")
    if step == want["step"]:
        for key, value in got["params"].items():
            _rel_close(value.numpy(), want["params"][key].numpy(),
                       RESUME_TOL, f"{name} {key}")


def test_cross_layout_restore(suite):
    """One rank's snapshot (step 1) resumes at 2 x 2, whose snapshot (step
    2: the coordinator's alone, layout-free, the gathered state) resumes
    at one rank: the step after each within RESUME_TOL of the unbroken
    one-rank run's (its losses; the parameters after the last)."""
    inputs, got, unbroken = suite["inputs"], suite["got"], suite["unbroken"]
    resumed = got[0]["resumed"]
    assert resumed["step"] == 2 and unbroken["step"] == 3
    _assert_resumed(resumed, unbroken, 2, "1 -> 2x2")
    snap = resumed["snapshot"]
    assert snap and all(r["resumed"]["snapshot"] is None for r in got[1:])
    saved = torch.load(snap, weights_only=True)["state"]
    assert (worker.dp_worker.fingerprint(saved["params"]),
            worker.dp_worker.fingerprint(saved["trace"])) == \
        resumed["fingerprint"]
    back = _one_rank_steps(inputs, restore=snap, n=1)
    assert back["step"] == 3
    _assert_resumed(back, unbroken, 3, "2x2 -> 1")


def test_test_net_rank_function_at_model_devices_two(suite, tmp_path):
    """The 2 x 2 ranks' test_net (TP is replicated for mobile; SP on both
    canvases) gives one process's detections, at the eval tests'
    tolerances (boxes 1e-3, scores 1e-5: the split convolutions round a
    box corner ~50 px apart by 1.1e-5), and its mAP."""
    got, voc = suite["got"], suite["voc"]
    assert got[0]["test_net"] is not None
    assert all(r["test_net"] is None for r in got[1:])
    out = osp.join(voc, "output", "default", "voc_2007_test", "mobile.pt")
    with open(osp.join(out, "detections.pkl"), "rb") as f:
        four = pickle.load(f)
    assert not [p for p in os.listdir(out) if ".part" in p]
    root = tmp_path / "one"
    shutil.copytree(voc / "VOCdevkit2007", root / "VOCdevkit2007")
    argv = _voc_argv(root, str(suite["work"] / "mobile.pt"))
    one_map = test_net_cli.main(argv)
    with open(osp.join(root, "output", "default", "voc_2007_test",
                       "mobile.pt", "detections.pkl"), "rb") as f:
        one = pickle.load(f)
    assert got[0]["test_net"] == one_map
    for c in range(1, 21):
        for i in range(8):
            assert isinstance(four[c][i], np.ndarray), (c, i)
            assert four[c][i].shape == one[c][i].shape, (c, i)
            np.testing.assert_allclose(four[c][i][:, :4], one[c][i][:, :4],
                                       rtol=0, atol=1e-3)
            np.testing.assert_allclose(four[c][i][:, 4], one[c][i][:, 4],
                                       rtol=0, atol=1e-5)


def test_trainval_rank_function_at_model_devices_two(suite, tmp_path):
    """trainval_net's ranks at 2 x 2 (global batch 2) take the step one
    process takes at IMS_PER_DEVICE 2: its snapshot within 1e-4 of each
    tensor's largest."""
    assert [r["trainval_step"] for r in suite["got"]] == [1] * 4
    voc = suite["voc"]
    snap = osp.join(voc, "output", "default", "voc_2007_trainval",
                    "default", "res101_faster_rcnn_iter_1.pt")
    root = tmp_path / "one"
    shutil.copytree(voc / "VOCdevkit2007", root / "VOCdevkit2007")
    state = trainval_net.main(_trainval_argv(root, 1))
    assert int(state.step) == 1
    want = torch.load(osp.join(root, "output", "default",
                               "voc_2007_trainval", "default",
                               "res101_faster_rcnn_iter_1.pt"),
                      weights_only=True)["state"]
    four = torch.load(snap, weights_only=True)["state"]
    for part in ("params", "trace"):
        assert set(four[part]) == set(want[part])
        for key, value in four[part].items():
            _rel_close(value.numpy(), want[part][key].numpy(), STEP_TOL,
                       f"{part} {key}")


# --- the CLIs' refusals -----------------------------------------------------

@pytest.mark.parametrize("cli", [trainval_net, test_net_cli])
def test_devices_that_model_devices_does_not_divide_exit(cli):
    with pytest.raises(SystemExit, match="--devices 3: .*MODEL_DEVICES 2"):
        cli.main(["--devices", "3", "--device", "cpu", "--set",
                  "TPU.MODEL_DEVICES", "2"])


@pytest.mark.parametrize("cli", [trainval_net, test_net_cli])
def test_multi_host_flags_with_model_devices_exit(cli):
    with pytest.raises(SystemExit, match="single-host only"):
        cli.main(["--coordinator", "host0:29500", "--num-procs", "4",
                  "--proc-id", "1", "--device", "cpu", "--set",
                  "TPU.MODEL_DEVICES", "2"])
