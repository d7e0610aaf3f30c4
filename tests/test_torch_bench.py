"""The port's measurement tools (tf_faster_rcnn_torch/tools/bench.py,
bench_train.py and bench_sweep.py) against the JAX package's (the repo-root
bench.py, tools/bench_train.py and tools/bench_sweep.py), on the CPU.

(a) The port's ``synthetic_scenes`` equals the root bench.py's, for three
    seeds and shapes.
(b) The workloads: the specs, field by field over the fields both
    ``ModelSpec`` classes have, the canvases, images, im_info, orig_hw and
    GT arrays equal what the JAX tools' source computes, written out here,
    at the defaults and at experiments/cfgs/res101-lg.yml.
(c) The slice: at a tiny YAML (mobile at depth 0.25, float32, B = 2 on a
    128x160 canvas), the bench's detect function on the JAX weights,
    carried across by utils/weights.py, equals the JAX bench's ``detect``
    closure (``model.apply`` + ``postprocess_detections``, bench.py:94-101):
    class ids and the valid mask exactly, the scores and the boxes each
    within 1e-4 of their largest magnitude (float32 convolutions summed in
    another order).
(d) Each tool's ``measure(device="cpu")`` at one iteration and one window
    returns the JAX tool's keys; bench_train's step is make_train_step's (one
    step: finite losses, the state advanced); TPU.SPACE_TO_DEPTH (--s2d 1)
    is refused, naming the flag; with no device given and no CUDA device,
    the tools raise.
"""

import dataclasses
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tf_faster_rcnn_tpu import config as jcfg
from tf_faster_rcnn_tpu.engine.detect import postprocess_detections
from tf_faster_rcnn_tpu.models import network as jnet
from tf_faster_rcnn_torch import config as tcfg
from tf_faster_rcnn_torch.models.init import numpy_params
from tf_faster_rcnn_torch.models.network import ModelSpec
from tf_faster_rcnn_torch.tools import bench, bench_sweep, bench_train
from tf_faster_rcnn_torch.utils.weights import state_dict_from_flax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LG = os.path.join(ROOT, "experiments", "cfgs", "res101-lg.yml")
TINY_HW = (128, 160)
TINY_YML = """\
TRAIN:
  RPN_POST_NMS_TOP_N: 300
  RPN_BATCHSIZE: 64
  BATCH_SIZE: 32
  BG_THRESH_LO: 0.0
TPU:
  CANVAS_SIZE: [128, 160]
  COMPUTE_DTYPE: float32
MOBILENET:
  DEPTH_MULTIPLIER: 0.25
"""
BENCH_KEYS = {"metric", "value", "unit", "vs_baseline",
              "train_images_per_sec", "train_ms_per_step"}
TRAIN_KEYS = {"metric", "batch", "images_per_sec", "ms_per_step"}
SWEEP_KEYS = {"net", "batch", "s2d", "cfg", "images_per_sec"}


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(min(before, 2))
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def _reset_port_cfg():
    tcfg.reset_cfg()
    yield
    tcfg.reset_cfg()


@pytest.fixture(scope="module")
def tiny_yml(tmp_path_factory):
    path = tmp_path_factory.mktemp("bench") / "tiny.yml"
    path.write_text(TINY_YML)
    return str(path)


def _root_bench():
    """The repo-root bench.py, loaded from its file (numpy at module level
    only)."""
    spec = importlib.util.spec_from_file_location(
        "jax_root_bench", os.path.join(ROOT, "bench.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _same_spec(tspec, jspec):
    shared = ({f.name for f in dataclasses.fields(ModelSpec)}
              & {f.name for f in dataclasses.fields(jnet.ModelSpec)})
    assert len(shared) > 30
    for name in sorted(shared):
        assert getattr(tspec, name) == getattr(jspec, name), name


def _np(t):
    return t.detach().cpu().numpy()


# -- (a) the scenes ----------------------------------------------------------

@pytest.mark.parametrize("seed,shape", [(0, (8, 96, 128)), (1, (3, 200, 150)),
                                        (7, (2, 608, 1024))])
def test_synthetic_scenes_match_root_bench(seed, shape):
    want = _root_bench().synthetic_scenes(np.random.RandomState(seed), *shape)
    got = bench.synthetic_scenes(np.random.RandomState(seed), *shape)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


# -- (b) the workloads -------------------------------------------------------

def _jax_detect_target(cfg_file):
    """bench.py:67-85 (no cfg) or bench_sweep.py:27-56 (cfg): the JAX spec,
    its canvas and its images, im_info and orig_hw at B = 2."""
    jcfg.reset_cfg()
    jcfg.cfg.TPU.COMPUTE_DTYPE = "bfloat16"
    jcfg.cfg.TPU.SPACE_TO_DEPTH = cfg_file is None    # bench.py:71
    rng = np.random.RandomState(0)
    if cfg_file is None:
        spec = dataclasses.replace(jnet.spec_from_cfg("res101", 21, "TEST"),
                                   rpn_pre_nms_top_n=6000,
                                   rpn_post_nms_top_n=300)
        h, w = jcfg.canvas_buckets(jcfg.cfg.TEST)[0]
        image = _root_bench().synthetic_scenes(rng, 2, h, w)
        im_info = np.tile(np.array([[600.0, 1000.0, 1.6]], np.float32), (2, 1))
        orig_hw = np.tile(np.array([[375.0, 625.0]], np.float32), (2, 1))
        return spec, (h, w), image, im_info, orig_hw
    jcfg.cfg_from_file(cfg_file)
    spec = jnet.spec_from_cfg("res101", 21, "TEST")
    h, w = jcfg.canvas_buckets(jcfg.cfg.TEST)[0]
    image = rng.randn(2, h, w, 3).astype(np.float32) * 40.0
    ih, iw = float(h * 600 // 608), float(w * 1000 // 1024)
    im_info = np.tile(np.array([[ih, iw, 1.6]], np.float32), (2, 1))
    orig_hw = np.tile(np.array([[ih / 1.6, iw / 1.6]], np.float32), (2, 1))
    return spec, (h, w), image, im_info, orig_hw


@pytest.mark.parametrize("cfg_file", [None, LG], ids=["default", "lg"])
def test_detect_workload_matches_jax_tools(cfg_file):
    jspec, canvas, image, im_info, orig_hw = _jax_detect_target(cfg_file)
    make_image = bench.synthetic_scenes if cfg_file is None else bench.noise
    spec, model, _, inputs = bench.detect_workload(
        "res101", 2, cfg_file=cfg_file, make_image=make_image, device="cpu")
    _same_spec(spec, jspec)
    assert spec.compute_dtype == "bfloat16" and model.spec == spec
    assert (spec.rpn_pre_nms_top_n, spec.rpn_post_nms_top_n) == (
        (6000, 300) if cfg_file is None else (6000, 1000))
    assert canvas == ((608, 1024) if cfg_file is None else (800, 1344))
    for got, want in zip(inputs, (image, im_info, orig_hw)):
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(_np(got), want)


def _jax_train_target(cfg_file):
    """tools/bench_train.py:41-76 at B = 2: the JAX spec, canvas and batch
    (the image before the space-to-depth relayout, which the port does not
    make)."""
    jcfg.reset_cfg()
    jcfg.cfg.TPU.COMPUTE_DTYPE = "bfloat16"
    jcfg.cfg.TPU.SPACE_TO_DEPTH = True                 # --s2d 1, res101
    if cfg_file:
        jcfg.cfg_from_file(cfg_file)
        spec = dataclasses.replace(jnet.spec_from_cfg("res101", 21, "TRAIN"),
                                   rpn_pre_nms_top_n=6000)
        h, w = jcfg.canvas_hw(jcfg.cfg.TRAIN)
    else:
        h, w = 608, 1024
        spec = dataclasses.replace(jnet.spec_from_cfg("res101", 21, "TRAIN"),
                                   rpn_pre_nms_top_n=6000,
                                   rpn_post_nms_top_n=2000)
    b = 2
    image = np.random.RandomState(0).randn(b, h, w, 3).astype(
        np.float32) * 40.0
    ih, iw = float(h * 600 // 608), float(w * 1000 // 1024)
    batch = {
        "image": image,
        "im_info": np.tile(np.array([[ih, iw, 1.6]], np.float32), (b, 1)),
        "gt_boxes": np.tile(np.array(
            [[[40, 60, 300, 400, 7], [200, 100, 500, 330, 12]]], np.float32),
            (b, 1, 1)),
        "gt_valid": np.ones((b, 2), bool),
    }
    return spec, (h, w), batch, float(jcfg.cfg.TRAIN.WEIGHT_DECAY)


@pytest.mark.parametrize("cfg_file", [None, LG], ids=["default", "lg"])
def test_train_workload_matches_jax_tool(cfg_file):
    jspec, canvas, jbatch, decay = _jax_train_target(cfg_file)
    spec, state, _, batch = bench_train.train_workload(
        "res101", 2, cfg_file=cfg_file, device="cpu")
    _same_spec(spec, jspec)
    assert spec.mode == "TRAIN" and spec.compute_dtype == "bfloat16"
    assert (spec.rpn_pre_nms_top_n, spec.rpn_post_nms_top_n) == (6000, 2000)
    assert tuple(batch["image"].shape[1:3]) == canvas == (
        (608, 1024) if cfg_file is None else (1344, 1344))
    assert set(batch) == set(jbatch)
    for key, want in jbatch.items():
        assert _np(batch[key]).dtype == want.dtype, key
        np.testing.assert_array_equal(_np(batch[key]), want)
    # float32 parameters, the optimizer at the YAML's TRAIN settings
    assert all(p.dtype == torch.float32 for p in state.model.parameters())
    assert float(tcfg.cfg.TRAIN.WEIGHT_DECAY) == decay
    assert int(state.step) == 0 and int(state.count) == 0


# -- (c) the slice ----------------------------------------------------------

def test_bench_detect_matches_jax_bench_detect(tiny_yml):
    spec, model, detect, (image, im_info, orig_hw) = bench.detect_workload(
        "mobile", 2, cfg_file=tiny_yml, device="cpu")
    assert spec.compute_dtype == "float32"
    assert tuple(image.shape) == (2,) + TINY_HW + (3,)

    # the JAX bench's detect closure at the same cfg (bench_sweep.py --cfg)
    jcfg.cfg.TPU.COMPUTE_DTYPE = "bfloat16"
    jcfg.cfg_from_file(tiny_yml)
    jspec = jnet.spec_from_cfg("mobile", 21, "TEST")
    _same_spec(spec, jspec)
    jmodel = jnet.FasterRCNN(jspec)
    x, info, orig = _np(image), _np(im_info), _np(orig_hw)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), x[:1],
                            info[:1])
    params = numpy_params(shapes, 5)
    model.load_state_dict(state_dict_from_flax(params), strict=True)

    @jax.jit
    def jdetect(params, image, im_info, orig_hw):
        out = jmodel.apply(params, image, im_info)
        return postprocess_detections(
            out["rois"], out["roi_valid"], out["cls_prob"], out["bbox_pred"],
            im_info, orig_hw, num_classes=21,
            max_per_image=int(jcfg.cfg.TPU.MAX_PER_IMAGE),
            nms_thresh=float(jcfg.cfg.TEST.NMS))

    want_det, want_valid = (np.asarray(a) for a in jdetect(
        params, jnp.asarray(x), jnp.asarray(info), jnp.asarray(orig)))
    det, valid = (_np(a) for a in detect(image, im_info, orig_hw))
    assert det.shape == want_det.shape == (2, 100, 6)
    np.testing.assert_array_equal(valid, want_valid)
    assert valid.sum() > 20
    np.testing.assert_array_equal(det[..., 0], want_det[..., 0])
    for cols in (slice(1, 2), slice(2, 6)):            # scores, boxes
        np.testing.assert_allclose(det[..., cols], want_det[..., cols],
                                   rtol=0,
                                   atol=1e-4 * np.abs(want_det[..., cols]
                                                      ).max())


# -- (d) measure, the train step, the refusals ------------------------------

def test_bench_measure_keys(tiny_yml, capsys):
    out = bench.measure("mobile", 2, iters=1, windows=1, warmup=0,
                        cfg_file=tiny_yml, train_iters=1, device="cpu")
    assert set(out) == BENCH_KEYS
    assert out["metric"] == "r101_frcnn_600px_detection_throughput"
    assert out["unit"] == "images/sec/chip"
    assert out["vs_baseline"] == pytest.approx(out["value"] / 7.0)
    for key in ("value", "train_images_per_sec", "train_ms_per_step"):
        assert np.isfinite(out[key]) and out[key] > 0, key
    lines = capsys.readouterr().out.splitlines()
    assert ['"path": "detect"' in line for line in lines].count(True) == 1
    assert ['"path": "train"' in line for line in lines].count(True) == 1


def test_bench_train_measure_keys(tiny_yml):
    out = bench_train.measure("mobile", 2, iters=1, cfg_path=tiny_yml,
                              windows=1, warmup=0, device="cpu")
    assert set(out) == TRAIN_KEYS
    assert out["metric"] == "mobile_train_throughput" and out["batch"] == 2
    assert out["ms_per_step"] == pytest.approx(2000.0 / out["images_per_sec"])


def test_bench_sweep_measure_keys(tiny_yml):
    out = bench_sweep.measure(2, 1, warmup=0, reps=1, net="mobile",
                              cfg_file=tiny_yml, device="cpu")
    assert set(out) == SWEEP_KEYS
    assert (out["net"], out["batch"], out["s2d"], out["cfg"]) == (
        "mobile", 2, False, tiny_yml)
    assert np.isfinite(out["images_per_sec"]) and out["images_per_sec"] > 0


def test_bench_train_step_is_make_train_steps(tiny_yml):
    spec, state, step, batch = bench_train.train_workload(
        "mobile", 2, cfg_file=tiny_yml, device="cpu")
    before = {k: v.detach().clone() for k, v in state.params().items()}
    state, metrics = step(state, batch)
    assert int(state.step) == 1 and int(state.count) == 1
    for name in ("rpn_cross_entropy", "rpn_loss_box", "cross_entropy",
                 "loss_box", "total_loss"):
        assert bool(torch.isfinite(metrics[name])), name
    assert float(metrics["cross_entropy"]) > 0
    assert float(metrics["learning_rate"]) == pytest.approx(0.001)
    moved = [k for k, v in state.params().items()
             if not torch.equal(v, before[k])]
    assert "cls_score.weight" in moved and "rpn_conv.weight" in moved


@pytest.mark.parametrize("tool", ["bench", "bench_train", "bench_sweep"])
def test_s2d_refused(tool, tiny_yml):
    call = {"bench": lambda: bench.detect_workload(
                "res101", 1, s2d=True, device="cpu"),
            "bench_train": lambda: bench_train.measure(
                "res101", 1, iters=1, s2d=True, device="cpu"),
            "bench_sweep": lambda: bench_sweep.measure(
                1, 1, s2d=True, device="cpu")}[tool]
    with pytest.raises(NotImplementedError, match="TPU.SPACE_TO_DEPTH"):
        call()


def test_tools_need_a_card_unless_told():
    if torch.cuda.is_available():
        assert bench.device_for().type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bench.measure()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bench_train.measure()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bench_sweep.measure(8, 20)
