"""The port's evaluation path against the JAX package: image prep, weights,
``test_net``, the CLIs, and what the port imports.

* prep: ``prep_im_for_blob`` + ``place_on_canvas`` on seeded uint8 images
  against the JAX package's (cv2 on float64): output shape, scale and the
  extent exact, pixels within 0.02 absolute; the same for ``_prep_batch``
  over image files (im_info and orig_hw exact);
* ``load_params``: a JAX ``save_params`` msgpack (float32, bfloat16,
  chunked) and a training snapshot load equal, bit for bit, to
  ``state_dict_from_flax``; the port's ``.pt`` round-trips;
* ``test_net`` on a mini-VOC of both orientations (TEST.SCALES (96,),
  MAX_SIZE 128, mobile at depth multiplier 0.25, batch 2 with padded
  tails), both packages with bridged weights and the JAX engine's prep
  names pointed at the port's canvases, so both see identical inputs:
  equal canvases, equal detection counts per image and class, boxes within
  1e-3 and scores within 1e-5, guarded by the separation check of
  ``test_torch_detect.py`` (the top RPN scores apart by more than 100x the
  frameworks' disagreement), equal mAP, and the JAX ``tools/reval.py`` on
  the port's pickle scores the same mAP;
* a slow, jittered decode gives the same pickle; the CLIs (``--device
  cpu``) give the in-process pickle, and ``reval --nms`` the host re-NMS;
* hygiene: the port's eval over a tree whose annotation cache the JAX
  package wrote leaves jax, the JAX package, cv2 and PIL out of
  sys.modules.
"""

import dataclasses
import importlib.util
import os
import os.path as osp
import pickle
import shutil
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from test_torch_datasets import make_voc, set_both_cfgs
from tf_faster_rcnn_tpu import config as jconfig
from tf_faster_rcnn_tpu.data import blob as jblob
from tf_faster_rcnn_tpu.datasets import pascal_voc as jvoc
from tf_faster_rcnn_tpu.datasets import voc_eval as jvoc_eval
from tf_faster_rcnn_tpu.engine import test_engine as jengine
from tf_faster_rcnn_tpu.models import network as jnet
from tf_faster_rcnn_tpu.utils import checkpoint as jckpt
from tf_faster_rcnn_torch import config as tconfig
from tf_faster_rcnn_torch.data import blob as tblob
from tf_faster_rcnn_torch.datasets import pascal_voc as tvoc
from tf_faster_rcnn_torch.engine import test_engine as tengine
from tf_faster_rcnn_torch.models import network as tnet
from tf_faster_rcnn_torch.models.init import numpy_params
from tf_faster_rcnn_torch.tools import reval as treval
from tf_faster_rcnn_torch.tools import test_net as ttest_net
from tf_faster_rcnn_torch.utils import checkpoint as tckpt
from tf_faster_rcnn_torch.utils.weights import state_dict_from_flax

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
# the mini-VOC's eval settings, as cfg keys and as the CLI's --set list
NET_CFG = {"TEST.SCALES": (96,), "TEST.MAX_SIZE": 128,
           "ANCHOR_SCALES": [2, 4], "TEST.RPN_PRE_NMS_TOP_N": 128,
           "TEST.RPN_POST_NMS_TOP_N": 16, "MOBILENET.DEPTH_MULTIPLIER": 0.25,
           "TPU.IMS_PER_DEVICE": 2}
SMALL = dict(anchor_scales=(2, 4), rpn_pre_nms_top_n=128,
             rpn_post_nms_top_n=16, depth_multiplier=0.25)
# the weights' seed: chosen so that the top RPN scores are separated far
# beyond the frameworks' float32 disagreement (asserted by the test)
SEED = 3
MAX_PER_IMAGE = 100


def _set_list(root):
    out = []
    for key, value in NET_CFG.items():
        out += [key, repr(value)]
    return out + ["DATA_DIR", str(root), "ROOT_DIR", str(root)]


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two intra-op threads: the suite runs several workers on the host's
    cores, and these small tensors gain little from more."""
    before = torch.get_num_threads()
    torch.set_num_threads(min(before, 2))
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def _port_cfg():
    """The port's cfg, reset after each test (the conftest resets only the
    JAX package's)."""
    tconfig.reset_cfg()
    yield
    tconfig.reset_cfg()


@pytest.fixture(scope="module")
def mobile():
    """Both mobile detectors (multiplier 0.25) with the same numpy-drawn
    weights: (jspec, jmodel, params, tspec, tmodel)."""
    jspec = dataclasses.replace(jnet.spec_from_cfg("mobile", 21, "TEST"),
                                **SMALL)
    tspec = dataclasses.replace(tnet.ModelSpec("mobile", 21), **SMALL)
    jmodel = jnet.FasterRCNN(jspec)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 96, 128, 3)),
                            jnp.array([[96.0, 128.0, 1.0]]))
    params = numpy_params(shapes, SEED)
    tmodel = tnet.FasterRCNN(tspec, device="cpu").eval()
    tmodel.load_state_dict(state_dict_from_flax(params), strict=True)
    return jspec, jmodel, params, tspec, tmodel


@pytest.fixture
def mini_voc(tmp_path):
    gt = make_voc(str(tmp_path))
    set_both_cfgs(DATA_DIR=str(tmp_path), ROOT_DIR=str(tmp_path), **NET_CFG)
    return tmp_path, gt


def _pickle(path):
    with open(path, "rb") as f:
        return pickle.load(f)


# -- prep ------------------------------------------------------------------

@pytest.mark.parametrize("hw,target,max_size", [
    ((375, 500), 600, 1000),     # upscale 1.6, a VOC landscape
    ((333, 500), 600, 1000),     # cv2 rounds 900.9 to 901; a floor gives 900
    ((900, 1200), 600, 1000),    # downscale 2/3
    ((480, 1280), 600, 1000),    # the MAX_SIZE cap: 0.78125, 375 x 1000
    ((100, 75), 96, 128),        # the mini-VOC's portrait
])
def test_prep_matches_jax(hw, target, max_size):
    im = np.random.RandomState(hw[0]).randint(0, 256, hw + (3,))
    im = im.astype(np.uint8)
    means = jconfig.cfg.PIXEL_MEANS
    jim, jscale = jblob.prep_im_for_blob(im.copy(), means, target, max_size)
    tim, tscale = tblob.prep_im_for_blob(torch.from_numpy(im), means, target,
                                         max_size)
    assert tscale == jscale
    assert tuple(tim.shape) == jim.shape and tim.dtype == torch.float32
    assert float(np.abs(tim.numpy() - jim).max()) <= 0.02
    canvas = (jim.shape[0] + 5, jim.shape[1] + 7, 3)
    jc = np.zeros(canvas, np.float32)
    tc = torch.zeros(canvas)
    assert tblob.place_on_canvas(tc, tim) == \
        jblob.place_on_canvas(jc, jim, False) == jim.shape[:2]
    assert float(np.abs(tc.numpy() - jc).max()) <= 0.02
    assert not tc[jim.shape[0]:].any() and not tc[:, jim.shape[1]:].any()
    with pytest.raises(ValueError, match="exceeds canvas"):
        tblob.place_on_canvas(torch.zeros(4, 4, 3), tim)


def test_prep_batch_matches_jax(tmp_path):
    rng = np.random.RandomState(0)
    paths = []
    for i, hw in enumerate(((375, 500), (333, 500), (480, 1280), (96, 96))):
        path = str(tmp_path / f"{i}.jpg")
        tblob.write_ppm(path, rng.randint(0, 256, hw + (3,)).astype(np.uint8))
        paths.append(path)
    canvas = (608, 1024)
    jimages, jinfo, jhw = jengine._prep_batch(paths, canvas)
    ims = [tblob.read_image_bgr(p) for p in paths]
    timages, tinfo, thw = tengine._prep_batch(ims, canvas, "cpu")
    np.testing.assert_array_equal(tinfo.numpy(), jinfo)
    np.testing.assert_array_equal(thw.numpy(), jhw)
    assert timages.shape == jimages.shape
    assert float(np.abs(timages.numpy() - jimages).max()) <= 0.02


def test_space_to_depth_batches_raise():
    tconfig.cfg.TPU.SPACE_TO_DEPTH = True
    with pytest.raises(NotImplementedError, match="SPACE_TO_DEPTH"):
        tblob.batch_image_shape(2, (608, 1024))


# -- weights ---------------------------------------------------------------

def _assert_state_dicts_equal(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert torch.equal(got[k], want[k]), k


def test_load_params_msgpack_bit_for_bit(mobile, tmp_path):
    _, _, params, _, tmodel = mobile
    path = str(tmp_path / "p.msgpack")
    jckpt.save_params(path, params)
    got = tckpt.load_params(path)
    _assert_state_dicts_equal(got, state_dict_from_flax(params))
    tmodel.load_state_dict(got, strict=True)


def test_load_params_snapshot_takes_params(mobile, tmp_path):
    _, _, params, _, _ = mobile
    trace = jax.tree_util.tree_map(lambda x: np.ones_like(x), params)
    state = {"params": params, "opt_state": {"0": {"trace": trace},
                                             "1": {"count": np.int32(4)}},
             "step": np.int32(4), "key": np.array([0, 7], np.uint32)}
    path = str(tmp_path / "res101_faster_rcnn_iter_4.msgpack")
    with open(path, "wb") as f:
        f.write(serialization.to_bytes(state))
    _assert_state_dicts_equal(tckpt.load_params(path),
                              state_dict_from_flax(params))


def test_load_params_bfloat16_and_chunked(mobile, tmp_path, monkeypatch):
    _, _, params, _, _ = mobile
    bf16 = jax.tree_util.tree_map(lambda x: np.asarray(x, jnp.bfloat16),
                                  params)
    path = str(tmp_path / "bf16.msgpack")
    jckpt.save_params(path, bf16)
    _assert_state_dicts_equal(tckpt.load_params(path),
                              state_dict_from_flax(bf16))
    # flax splits a leaf over MAX_CHUNK_SIZE bytes into chunks
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 4096)
    path = str(tmp_path / "chunked.msgpack")
    jckpt.save_params(path, params)
    with open(path, "rb") as f:
        assert b"__msgpack_chunked_array__" in f.read()
    _assert_state_dicts_equal(tckpt.load_params(path),
                              state_dict_from_flax(params))


def test_save_params_round_trip(mobile, tmp_path):
    tmodel = mobile[4]
    path = str(tmp_path / "w" / "mobile.pt")
    tckpt.save_params(path, tmodel)
    _assert_state_dicts_equal(tckpt.load_params(path), tmodel.state_dict())


# -- test_net --------------------------------------------------------------

def _fg(rpn_cls_score):
    x = np.asarray(rpn_cls_score, np.float64)
    e = np.exp(x - x.max(-1, keepdims=True))
    return (e / e.sum(-1, keepdims=True))[..., 1]


def _jax_reval_map(out_dir):
    """The JAX package's tools/reval.py on out_dir's detections.pkl; its mAP
    from the per-class PR files it writes there."""
    spec = importlib.util.spec_from_file_location(
        "jax_tools_reval", osp.join(REPO, "tools", "reval.py"))
    module = importlib.util.module_from_spec(spec)
    sys.path.insert(0, osp.join(REPO, "tools"))
    try:
        spec.loader.exec_module(module)
        module.main([str(out_dir), "--imdb", "voc_2007_test"])
    finally:
        sys.path.remove(osp.join(REPO, "tools"))
    aps = [_pickle(osp.join(out_dir, f"{c}_pr.pkl"))["ap"]
           for c in jvoc.VOC_CLASSES[1:]]
    return float(np.mean(aps))


def test_test_net_matches_jax(mini_voc, mobile, monkeypatch):
    root, _ = mini_voc
    jspec, jmodel, params, tspec, tmodel = mobile

    # the JAX engine builds its canvases with the port's prep
    def port_prep(im, pixel_means, target_size, max_size):
        out, scale = tblob.prep_im_for_blob(torch.from_numpy(im), pixel_means,
                                            target_size, max_size)
        return out.numpy(), scale
    monkeypatch.setattr(jengine, "prep_im_for_blob", port_prep)

    jbatches, tbatches = [], []
    jdetect = jengine.make_detect_fn(jmodel, jspec, MAX_PER_IMAGE, 0.0)
    tdetect = tengine.make_detect_fn(tmodel, tspec, MAX_PER_IMAGE, 0.0)

    def jrecord(p, image, im_info, orig_hw):
        jbatches.append((np.array(image), np.array(im_info),
                         np.array(orig_hw)))
        return jdetect(p, image, im_info, orig_hw)

    def trecord(image, im_info, orig_hw):
        tbatches.append((image.numpy().copy(), im_info.numpy().copy(),
                         orig_hw.numpy().copy()))
        return tdetect(image, im_info, orig_hw)

    jmap = jengine.test_net(jmodel, jspec, params, jvoc.pascal_voc(
        "test", "2007"), "w", max_per_image=MAX_PER_IMAGE,
        output_dir=str(root / "j"), detect_fn=jrecord)
    tmap = tengine.test_net(tmodel, tspec, tvoc.pascal_voc("test", "2007"),
                            "w", max_per_image=MAX_PER_IMAGE,
                            output_dir=str(root / "t"), detect_fn=trecord)

    # identical inputs: 3 landscape batches and 2 portrait ones, the tails
    # padded with their last image
    assert [b[0].shape for b in tbatches] == [(2, 96, 128, 3)] * 3 + [
        (2, 128, 96, 3)] * 2
    for jb, tb in zip(jbatches, tbatches, strict=True):
        for j, t in zip(jb, tb):
            np.testing.assert_array_equal(t, j)

    # the separation guard: the top RPN scores of every image must lie
    # apart by more than 100x the frameworks' largest disagreement
    japply = jax.jit(jmodel.apply)
    k = tspec.rpn_post_nms_top_n
    for image, im_info, _ in tbatches:
        jfg = _fg(japply(params, image, im_info)["rpn_cls_score"])
        with torch.no_grad():
            tfg = _fg(tmodel(torch.from_numpy(image),
                             torch.from_numpy(im_info))["rpn_cls_score"])
        disagreement = float(np.abs(jfg - tfg).max())
        for b in range(len(image)):
            ranked = np.sort(jfg[b])[::-1][:k]
            gap = float(np.min(-np.diff(ranked)))
            assert gap > 100 * disagreement, (b, gap, disagreement)

    jboxes = _pickle(root / "j" / "detections.pkl")
    tboxes = _pickle(root / "t" / "detections.pkl")
    assert len(tboxes) == 21 and all(len(row) == 8 for row in tboxes)
    n_dets = 0
    for c in range(1, 21):
        for i in range(8):
            t, j = tboxes[c][i], jboxes[c][i]
            assert t.dtype == np.float32 and t.shape == j.shape, (c, i)
            np.testing.assert_allclose(t[:, :4], j[:, :4], rtol=0, atol=1e-3)
            np.testing.assert_allclose(t[:, 4], j[:, 4], rtol=0, atol=1e-5)
            n_dets += len(t)
    assert n_dets > 0
    assert tmap == jmap and 0.0 <= tmap <= 1.0

    reval_dir = root / "jax_reval_of_port"
    reval_dir.mkdir()
    shutil.copy(root / "t" / "detections.pkl", reval_dir)
    assert _jax_reval_map(reval_dir) == tmap


def test_test_net_slow_decode_same_pickle(mini_voc, mobile, monkeypatch):
    """Batches of one whose decodes finish out of order (a slow, jittered
    decode, the whole schedule in flight) give the same pickle."""
    root, _ = mini_voc
    tspec, tmodel = mobile[3], mobile[4]
    imdb = tvoc.pascal_voc("test", "2007")
    tengine.test_net(tmodel, tspec, imdb, "fast", batch_size=1,
                     output_dir=str(root / "fast"))
    real_read = tengine.read_image_bgr
    delays = iter([0.2, 0.0, 0.15, 0.0, 0.1, 0.0, 0.05, 0.0])

    def slow_read(path):
        time.sleep(next(delays, 0.0))
        return real_read(path)

    monkeypatch.setattr(tengine, "read_image_bgr", slow_read)
    tconfig.cfg.TPU.EVAL_PREFETCH_THREADS = 6
    timers = {}
    tengine.test_net(tmodel, tspec, imdb, "slow", batch_size=1,
                     output_dir=str(root / "slow"), timers=timers)
    assert timers["im_detect"].calls == 8 and timers["misc"].calls == 8
    fast = _pickle(root / "fast" / "detections.pkl")
    slow = _pickle(root / "slow" / "detections.pkl")
    for c in range(1, 21):
        for i in range(8):
            np.testing.assert_array_equal(slow[c][i], fast[c][i],
                                          err_msg=f"class {c} image {i}")


def test_cli_test_net_and_reval(mini_voc, mobile):
    """The CLI on saved weights gives the in-process pickle and mAP, and
    reval --nms the host re-NMS of that pickle."""
    root, _ = mini_voc
    tspec, tmodel = mobile[3], mobile[4]
    weights = str(root / "mobile.pt")
    tckpt.save_params(weights, tmodel)
    cli_map = ttest_net.main(["--net", "mobile", "--imdb", "voc_2007_test",
                              "--model", weights, "--device", "cpu",
                              "--set"] + _set_list(root))
    cli_dir = root / "output" / "default" / "voc_2007_test" / "mobile.pt"
    imdb = tvoc.pascal_voc("test", "2007")
    want = tengine.test_net(tmodel, tspec, imdb, "in_process",
                            output_dir=str(root / "in_process"))
    assert cli_map == want
    got = _pickle(cli_dir / "detections.pkl")
    ref = _pickle(root / "in_process" / "detections.pkl")
    for c in range(21):
        for i in range(8):
            np.testing.assert_array_equal(np.asarray(got[c][i]),
                                          np.asarray(ref[c][i]))

    nms_map = treval.main([str(cli_dir), "--nms", "--set", "DATA_DIR",
                           str(root), "TEST.NMS", "0.1"])
    direct = imdb.evaluate_detections(tengine.apply_nms(ref, 0.1),
                                      str(root / "direct"))
    assert nms_map == direct


def test_im_detect_matches_detect_fn(mini_voc, mobile):
    root, _ = mini_voc
    tspec, tmodel = mobile[3], mobile[4]
    detect = tengine.make_detect_fn(tmodel, tspec)
    im = tblob.read_image_bgr(str(root / "VOCdevkit2007" / "VOC2007" /
                                  "JPEGImages" / "000007.jpg"))
    assert im.shape[:2] == (100, 75)
    got = tengine.im_detect(detect, im, "cpu")
    det, dv = detect(*tengine._prep_batch([im], (128, 96), "cpu"))
    np.testing.assert_array_equal(got, det[0][dv[0]].numpy())
    assert got.shape[1] == 6 and len(got) > 0


def test_port_eval_imports_neither_package(mini_voc):
    """An eval over a tree whose annotation cache the JAX package wrote
    (a pickle of its own VocObject records) reads PPM images and its own
    JSON cache, and leaves jax, flax, the JAX package, cv2 and PIL out of
    sys.modules."""
    root, _ = mini_voc
    devkit = root / "VOCdevkit2007"
    voc = devkit / "VOC2007"
    jvoc_eval._load_annotations(str(voc / "Annotations" / "{:s}.xml"),
                                str(voc / "ImageSets" / "Main" / "test.txt"),
                                str(devkit / "annotations_cache"))
    code = r"""
import sys
from tf_faster_rcnn_torch.tools import test_net
mean_ap = test_net.main(["--net", "mobile", "--imdb", "voc_2007_test",
                         "--device", "cpu", "--set"] + sys.argv[1:])
assert 0.0 <= mean_ap <= 1.0, mean_ap
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "cv2", "PIL",
                                    "tf_faster_rcnn_tpu"))
print("LOADED", bad)
"""
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    out = subprocess.run([sys.executable, "-c", code] + _set_list(root),
                         cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "LOADED []" in out.stdout, out.stdout[-2000:]
    assert sorted(os.listdir(devkit / "annotations_cache")) == [
        "test.txt_annots.json", "test.txt_annots.pkl"]
