"""R-101-FPN on the port (``backbone res101_fpn``) against the benchmark's
plain float32 reference (``frcnn_bench/reference/fpn.py``) on the CPU, at a
small size: a 64 x 96 canvas, blocks of 1, 1, 2 and 1 units, a 3 x 3 crop,
a few RoIs. Also the level assignment and the one-pass pyramid crop
against a loop over the levels, the FLOP count against torch's counter,
the ResNet-101 layout the other backbones keep, and TRAIN's refusal."""

import copy
import json
import math
import os
import subprocess
import sys

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from frcnn_bench import harness  # noqa: E402
from frcnn_bench.reference import fpn as ref_fpn  # noqa: E402
from frcnn_bench.reference.model import Reference, param_table  # noqa: E402
from frcnn_bench.weights import make_weights as slim_weights  # noqa: E402
from tf_faster_rcnn_torch.config import reset_cfg  # noqa: E402
from tf_faster_rcnn_torch.models import fpn, resnet_v1  # noqa: E402
from tf_faster_rcnn_torch.models.init import init_model  # noqa: E402
from tf_faster_rcnn_torch.models.network import (FasterRCNN,  # noqa: E402
                                                 ModelSpec, spec_from_cfg)
from tf_faster_rcnn_torch.ops.anchors import anchor_grid_on  # noqa: E402
from tf_faster_rcnn_torch.ops.roi_align import (pyramid_crop,  # noqa: E402
                                                roi_crop_pool)
from tf_faster_rcnn_torch.utils import trace  # noqa: E402

UNITS = (1, 1, 2, 1)
SEED = 2**31 + 17     # larger than 32 signed bits hold, as a run's may be


@pytest.fixture(autouse=True)
def _small(monkeypatch):
    """Two torch threads; ResNet-101's blocks cut to UNITS; the port's cfg
    reset after the test."""
    before = torch.get_num_threads()
    torch.set_num_threads(min(before, 2))
    monkeypatch.setitem(resnet_v1.BLOCK_UNITS, 101, UNITS)
    yield
    torch.set_num_threads(before)
    reset_cfg()


def _cell(dtype="float32"):
    cell = harness.load_cell("r101-fpn-coco-detect-b8")
    config, c = cell.config, cell.config["cfg"]
    config["net"]["units"] = list(UNITS)
    config["num_classes"] = 6
    c["TPU"]["COMPUTE_DTYPE"] = dtype
    c["TPU"]["MAX_PER_IMAGE"] = 20
    c["TEST"].update(SCALES=[64], MAX_SIZE=96, RPN_PRE_NMS_TOP_N=60,
                     RPN_POST_NMS_TOP_N=40)
    c["POOLING_SIZE"] = 3
    cell.traffic.update(pool=12, long_side=80, short_side=[56, 72], batch=2)
    # the one sampled step is the window's first, which always runs
    cell.spec.update(sample_steps=1, sample_within=1, trace_steps=2)
    return cell


def _model(config):
    harness.port_cfg(config)
    return harness.build_program(config, "TEST",
                                 ref_fpn.make_weights(config, 3, "cpu"),
                                 "cpu")


@pytest.mark.parametrize("seed", [SEED, 7])
def test_detect_equals_the_reference_at_float32(seed):
    """RPN outputs, heads and detection scores to rounding; each level's
    NMS with the union's top cut, and the per-class NMS, replayed exactly."""
    cell = _cell()
    out = harness.load_module("entries", cell.entry).run(
        cell, seed, 0.2, False, torch.device("cpu"))
    assert out["compared_steps"] == 1 and out["failed"] == 0
    assert set(out["numbers"]) == {
        "rpn_score_err", "rpn_delta_err", "proposal_replay",
        "head_score_err", "head_delta_err", "det_score_err", "det_replay"}
    for key, value in out["numbers"].items():
        assert value <= (0.0 if "replay" in key else 1e-5), (key, value)


def test_state_dict_is_the_reference_param_table():
    config = _cell().config
    model, _ = _model(config)
    got = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    want = {k: shape for k, (shape, _) in
            ref_fpn.param_table(config).items()}
    assert got == want
    # the module order: trunk, pyramid, RPN, box head, class and box heads
    tops = list(dict.fromkeys(k.split(".")[0] for k in got))
    assert tops == ["head", "fpn", "rpn_conv", "rpn_cls_score",
                    "rpn_bbox_pred", "tail", "cls_score", "bbox_pred"]


def test_pyramid_layout_strides_first_units_in_conv1():
    head = resnet_v1.ResNetV1Head(101, 1, pyramid=True)
    assert head.out_channels == (256, 512, 1024, 2048)
    for b, stride in enumerate((1, 2, 2, 2)):
        block = getattr(head, f"block{b + 1}")
        assert block.strides == [stride] + [1] * (UNITS[b] - 1)
        unit = block.unit_1
        assert unit.conv1.conv.stride == (stride, stride)
        assert unit.conv2.conv.stride == (1, 1)
        assert unit.shortcut.conv.stride == (stride, stride)
    feats = head(torch.randn(2, 3, 64, 96), torch.tensor([[64., 96.]] * 2))
    assert [tuple(f.shape[1:]) for f in feats] == [
        (256, 16, 24), (512, 8, 12), (1024, 4, 6), (2048, 2, 3)]


def test_one_proposal_nms_launch_for_every_image_and_level(monkeypatch):
    config = _cell().config
    model, spec = _model(config)
    calls = []
    inner = fpn.nms_keep_mask

    def counted(boxes, valid, *args, **kwargs):
        calls.append(tuple(boxes.shape))
        return inner(boxes, valid, *args, **kwargs)
    monkeypatch.setattr(fpn, "nms_keep_mask", counted)
    trace.zero(fpn.NMS_INSTANCES)
    image = torch.randn(3, 64, 96, 3) * 40
    info = torch.tensor([[64., 96., 1.], [50., 80., 1.], [64., 70., 1.]])
    with torch.no_grad():
        out = model(image, info)
    assert calls == [(3 * 5, 60, 4)]
    assert trace.counts()[fpn.NMS_INSTANCES] == 15
    assert out["rois"].shape == (3, 40, 4)
    n = sum(a * b * 3 for a, b in ((16, 24), (8, 12), (4, 6), (2, 3),
                                   (1, 2)))
    assert out["rpn_cls_score"].shape == (3, n, 2)


def _loop_level(rois):
    out = torch.empty(rois.shape[:2], dtype=torch.int64)
    for b in range(rois.shape[0]):
        for r in range(rois.shape[1]):
            x1, y1, x2, y2 = rois[b, r].tolist()
            k = math.floor(4 + math.log2(math.sqrt((x2 - x1) * (y2 - y1))
                                         / 224 + 1e-8))
            out[b, r] = min(max(k, 2), 5) - 2
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pyramid_crop_equals_a_loop_over_levels(dtype):
    gen = torch.Generator().manual_seed(4)
    b, r, canvas = 2, 64, (512, 768)
    xy = torch.rand((b, r, 2), generator=gen) * torch.tensor([760., 500.])
    wh = torch.exp(torch.rand((b, r, 2), generator=gen) * 6.5) - 1.0
    rois = torch.cat([xy, xy + wh], -1)
    rois[0, 0] = torch.tensor([10., 10., 10., 10.])      # empty: level 2
    rois[0, 1] = torch.tensor([0., 0., 224., 224.])      # canonical: 4
    rois[1, 0] = torch.tensor([0., 0., 700., 500.])      # level 5
    # x2 on the last valid cell of image 1 (601 wide) at P2 and P3: the
    # sample lands on the extent's limit itself
    rois[1, 1] = torch.tensor([500., 100., 600., 160.])
    rois[1, 2] = torch.tensor([440., 100., 600., 260.])
    level = fpn.assign_levels(rois)
    assert torch.equal(level, _loop_level(rois))
    assert set(level.unique().tolist()) == {0, 1, 2, 3}
    assert int(level[0, 1]) == 2
    strides = fpn.level_strides(fpn.ROI_LEVELS)
    feats = [torch.randn((b, 8, canvas[0] // s, canvas[1] // s),
                         generator=gen).to(dtype) for s in strides]
    valid_hw = torch.tensor([[512., 768.], [400., 601.]])
    got = pyramid_crop(feats, strides, rois, level, 3, valid_hw)
    want = torch.zeros_like(got)
    for i, (f, s) in enumerate(zip(feats, strides)):
        crop = roi_crop_pool(f.permute(0, 2, 3, 1), rois, s, 3,
                             max_pool=False,
                             valid_hw=torch.ceil(valid_hw / s))
        want = torch.where((level == i)[..., None, None, None], crop, want)
    assert level[1, 1] == 0 and level[1, 2] == 1
    assert got.dtype == dtype
    assert torch.equal(got, want)


def test_flops_equal_the_counter():
    config = _cell().config
    h, w = 64, 96
    params = ref_fpn.make_weights(config, 5, "cpu")
    ref = ref_fpn.FPNReference(config, params)
    image = torch.randn(1, h, w, 3) * 50
    info = torch.tensor([[h, w, 1.0]])
    r = config["cfg"]["TEST"]["RPN_POST_NMS_TOP_N"]
    rois = torch.tensor([[[4.0, 6.0, 40.0, 50.0]] * r])
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        levels, ext = ref.features(image, info)
        ref.rpn(levels, ext)
        ref.roi_heads(levels, rois, info)
    assert counter.get_total_flops() == ref_fpn.image_flops(config, h, w)


def test_slim_layout_is_unchanged():
    """res101-voc's state_dict is the benchmark's table of it, block4 stays
    the tail on the RoIs, each block strides in its last unit's 3x3, and the
    head equals the reference's at float32."""
    cell = harness.load_cell("res101-voc-detect-b8")
    config = copy.deepcopy(cell.config)
    config["net"]["units"] = list(UNITS)
    config["cfg"]["TPU"]["COMPUTE_DTYPE"] = "float32"
    harness.port_cfg(config)
    spec = spec_from_cfg("res101", 21, "TEST")
    weights = slim_weights(config, 9, "cpu")
    model = FasterRCNN(spec, device="cpu")
    model.load_state_dict(weights, strict=True)
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == {
        k: shape for k, (shape, _) in param_table(config).items()}
    assert not hasattr(model, "fpn") and not model.head.pyramid
    for b, stride in enumerate((2, 2, 1)):
        block = getattr(model.head, f"block{b + 1}")
        assert block.strides == [1] * (UNITS[b] - 1) + [stride]
        last = getattr(block, f"unit_{UNITS[b]}")
        assert last.conv1.conv.stride == (1, 1)
        assert last.conv2.conv.stride == (stride, stride)
    image = torch.randn(2, 64, 96, 3) * 50
    info = torch.tensor([[64., 96., 1.], [48., 70., 1.]])
    with torch.no_grad():
        got = model.head(image.permute(0, 3, 1, 2), info[:, :2])
        want = Reference(config, weights).head(image, info)
    assert got.shape == (2, 1024, 4, 6)
    assert torch.allclose(got, want, rtol=1e-4, atol=1e-4)


def test_train_raises_naming_the_queue():
    cell = _cell()
    harness.port_cfg(cell.config)
    with pytest.raises(NotImplementedError, match="Queue 4"):
        spec_from_cfg("res101_fpn", 81, "TRAIN")
    with pytest.raises(NotImplementedError, match="Queue 4"):
        FasterRCNN(ModelSpec("res101_fpn", 81, mode="TRAIN"), device="cpu")


def test_canvas_must_be_a_multiple_of_32():
    model, _ = _model(_cell().config)
    with pytest.raises(ValueError, match="multiple of 32"):
        model(torch.zeros(1, 48, 96, 3), torch.tensor([[48., 96., 1.]]))


def test_init_model_draws_every_pyramid_tensor():
    model, _ = _model(_cell().config)
    init_model(model, torch.Generator().manual_seed(0))
    sd = model.state_dict()
    for name in ("fpn.lateral2.weight", "fpn.output5.bias",
                 "tail.fc6.weight", "tail.fc7.weight"):
        assert bool((sd[name] != 0).all()), name
    std = float(sd["fpn.lateral3.weight"].std())
    assert abs(std - math.sqrt(2.0 / 512)) < 0.1 * std


def test_reference_draw_keeps_the_pyramid_and_fcs_at_unit_gain():
    """The seeded draw: the trunk He-scaled, the tensors under
    init.unit_gain (the pyramid's convs, fc6, fc7) at sqrt(1 / fan_in), the
    same normal draw times sqrt(1/2); at the cell's full size that keeps
    the class logits near unit width."""
    config = _cell().config
    assert config["init"]["unit_gain"] == ["fpn.", "tail.fc6.",
                                           "tail.fc7."]
    table = ref_fpn.param_table(config)
    got = ref_fpn.make_weights(config, 11, "cpu")
    config["init"]["unit_gain"] = []
    he = ref_fpn.make_weights(config, 11, "cpu")
    for name, (shape, kind) in table.items():
        scaled = kind in ("conv", "fc") and name.startswith(
            ("fpn.", "tail.fc6.", "tail.fc7."))
        want = he[name] * math.sqrt(0.5) if scaled else he[name]
        assert torch.equal(got[name], want), name
    for name, gain in (("head.block3.unit_1.conv2.conv.weight", 2.0),
                       ("fpn.lateral3.weight", 1.0),
                       ("fpn.output2.weight", 1.0),
                       ("tail.fc6.weight", 1.0), ("tail.fc7.weight", 1.0)):
        std = float(got[name].std())
        fan_in = math.prod(table[name][0][1:])
        assert abs(std - math.sqrt(gain / fan_in)) < 0.05 * std, name


def test_reference_loads_nothing_of_the_port_or_jax():
    code = ("import sys, json; sys.path.insert(0, '.'); "
            "import frcnn_bench.reference.fpn, frcnn_bench.calibrate_fpn; "
            "print(json.dumps(sorted({m.split('.')[0] for m in "
            "sys.modules})))")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    loaded = set(json.loads(proc.stdout.strip().splitlines()[-1]))
    assert not loaded & {"jax", "jaxlib", "flax", "tf_faster_rcnn_tpu",
                         "tf_faster_rcnn_torch"}


def test_im_detect_runs_the_pyramid():
    """make_detect_fn's step and im_detect take the pyramid as they take
    every backbone: one uint8 image on its canvas, detections back."""
    import numpy as np
    from tf_faster_rcnn_torch.engine.test_engine import (im_detect,
                                                         make_detect_fn)
    model, spec = _model(_cell().config)
    im = np.random.default_rng(0).integers(0, 255, (60, 90, 3), np.uint8)
    det = im_detect(make_detect_fn(model, spec), im, "cpu", canvas=(64, 96))
    assert det.shape[1] == 6 and 0 < len(det) <= 20
    assert ((det[:, 0] >= 1) & (det[:, 0] < 6)).all()


def test_trunk_graphs_run_the_trunk_eagerly_off_the_card():
    """Off the card (and outside inference mode) the trunk runs as it is
    and no graph is kept; a deep copy of the model starts with none."""
    model, spec = _model(_cell().config)
    image = torch.randn(2, 64, 96, 3)
    info = torch.tensor([[60., 90., 1.], [64., 80., 1.]])
    with torch.inference_mode():
        got = model.trunk_graphs(model.head, spec.dtype, image, info)
        want = model.head(image.permute(0, 3, 1, 2), info[:, :2])
    assert len(got) == len(want) == 4
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert model.trunk_graphs.graphs == {}
    assert copy.deepcopy(model).trunk_graphs.graphs == {}


def test_pyramid_anchors_are_made_once_and_read_in_any_mode():
    shapes = [(16, 24), (8, 12), (4, 6), (2, 3), (1, 2)]
    with torch.inference_mode():
        first = fpn.pyramid_anchors(shapes, "cpu", (8,), (0.5, 1, 2))
    again = fpn.pyramid_anchors(shapes, torch.device("cpu"), (8,),
                                (0.5, 1, 2))
    assert again is first and not first.is_inference()
    fresh = torch.cat([anchor_grid_on(h, w, "cpu", s, (8,), (0.5, 1, 2),
                                      base_size=s)
                       for (h, w), s in zip(shapes, fpn.level_strides())])
    assert torch.equal(first, fresh)
    deltas = torch.zeros(1, len(first), 4, requires_grad=True)
    (first[None] * deltas).sum().backward()      # saved for backward
    assert torch.equal(deltas.grad[0], first)


@pytest.mark.cuda
def test_trunk_replayed_from_its_graph_equals_the_eager_trunk():
    """The first call on a canvas runs eagerly, the second captures, the
    third replays: each bit for bit the eager trunk's levels, new inputs
    included."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine)")
    config = _cell("bfloat16").config
    harness.port_cfg(config)
    dev = torch.device("cuda", 0)
    model, spec = harness.build_program(
        config, "TEST", ref_fpn.make_weights(config, 3, dev), dev)
    model.eval()
    gen = torch.Generator(device=dev).manual_seed(0)
    info = torch.tensor([[60., 90., 1.], [64., 80., 1.]], device=dev)
    with torch.inference_mode():
        for _ in range(4):
            image = torch.randn(2, 64, 96, 3, device=dev, generator=gen)
            got = [t.clone() for t in model.trunk_graphs(
                model.head, spec.dtype, image, info)]
            want = model.head(image.to(spec.dtype).permute(0, 3, 1, 2),
                              info[:, :2])
            for a, b in zip(got, want):
                assert torch.equal(a, b)
    assert len(model.trunk_graphs.graphs) == 1
