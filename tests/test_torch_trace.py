"""The port's stage spans and counters (tf_faster_rcnn_torch/utils/trace.py)
and the benchmark's reduction of them (frcnn_bench/stages.py), on the CPU
at a small size: mobile at depth multiplier 0.25 on a 96x128 canvas, two
images a step.

* Off, a detect step and a train step record no span and never reach
  ``record_function``.
* On, each records the span tree of the module's table once a step, with
  its parents and step ids, every inclusive time at least its children's;
  under ``torch.profiler`` the same names nest the same way; the outputs
  are bit-equal to those with tracing off; the exported serving program is
  the same graph.
* The reduction puts an idle gap down to the innermost span at its
  midpoint and a launch to every span it starts in, on any thread, and
  leaves ``profiling.trace``'s keys as they are.
* The K1/K2 launch counts are views of the counters.
"""

import dataclasses
import types

import numpy as np
import pytest
import torch

from frcnn_bench import profiling, stages
from tf_faster_rcnn_torch import config as tconfig
from tf_faster_rcnn_torch.data.blob import prep_batch
from tf_faster_rcnn_torch.engine import test_engine, train
from tf_faster_rcnn_torch.models import network as tnet
from tf_faster_rcnn_torch.models.init import init_model
from tf_faster_rcnn_torch.ops import nms_kernels as K
from tf_faster_rcnn_torch.utils import serving, trace

CANVAS = (96, 128)
SMALL = dict(anchor_scales=(2, 4), rpn_pre_nms_top_n=128,
             rpn_post_nms_top_n=16, depth_multiplier=0.25)
SMALL_TRAIN = dict(SMALL, rpn_post_nms_top_n=32, rpn_batchsize=32,
                   roi_batch_size=16)
MEANS = torch.tensor([102.9801, 115.9465, 122.7717])
# span -> parent ("" for none), by the kind of step
TREES = {
    "detect": {"data.prep": "", "detect.step": "",
               "model.head": "detect.step", "model.rpn": "detect.step",
               "model.roi_heads": "detect.step",
               "detect.postprocess": "detect.step"},
    "train": {"data.prep": "", "train.step": "",
              "train.forward": "train.step",
              "model.head": "train.forward", "model.rpn": "train.forward",
              "model.targets": "train.forward",
              "model.roi_heads": "train.forward",
              "train.backward": "train.step", "train.update": "train.step"},
}


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(min(before, 2))
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def _fresh_trace():
    """Every test starts and ends with tracing off and nothing recorded,
    and with the port's default cfg."""
    tconfig.reset_cfg()
    trace.disable()
    trace.reset()
    yield
    trace.disable()
    trace.reset()
    tconfig.reset_cfg()


def _images(seed):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 256, (h, w, 3), dtype=np.uint8)
            for h, w in ((72, 96), (80, 110))]


def _detect_model():
    spec = dataclasses.replace(tnet.ModelSpec("mobile", 21), **SMALL)
    model = tnet.FasterRCNN(spec, device="cpu").eval()
    init_model(model, torch.Generator().manual_seed(0))
    return model, spec


def _detect_step(model, spec):
    """Prep and one detect step, as the benchmark's loop runs them."""
    image, info, orig = prep_batch(_images(1), CANVAS, "cpu", [64, 64], 96,
                                   MEANS)
    return test_engine.make_detect_fn(model, spec, max_per_image=20)(
        image, info, orig)


def _train_setup():
    spec = dataclasses.replace(tnet.ModelSpec("mobile", 21, mode="TRAIN"),
                               **SMALL_TRAIN)
    model = tnet.FasterRCNN(spec, device="cpu")
    init_model(model, torch.Generator().manual_seed(0))
    state = train.create_train_state(spec, model,
                                     torch.Generator().manual_seed(1))
    step = train.make_train_step(model, spec, weight_decay=1e-4,
                                 mobile_weight_decay=4e-5,
                                 lr_fn=state.tx.lr_fn, nan_guard=True)
    image, info, _ = prep_batch(_images(2), CANVAS, "cpu", [64, 64], 96,
                                MEANS)
    gt = torch.tensor([[[4., 6., 40., 50., 3.], [20., 10., 60., 44., 7.]],
                       [[8., 8., 70., 60., 12.], [0., 0., 0., 0., 0.]]])
    batch = {"image": image, "im_info": info, "gt_boxes": gt,
             "gt_valid": torch.tensor([[True, True], [True, False]])}
    return model, state, step, batch


def _train_step(setup):
    model, state, step, batch = setup
    _, metrics = step(state, batch)
    return metrics


def _run(kind):
    """One step of kind; returns its outputs (and the train state)."""
    if kind == "detect":
        return _detect_step(*_detect_model())
    setup = _train_setup()
    metrics = _train_step(setup)
    assert float(metrics["step_skipped"]) == 0
    return metrics, setup[0].state_dict(), setup[1].trace


# -- the spans --------------------------------------------------------------

@pytest.mark.parametrize("kind", ["detect", "train"])
def test_off_records_nothing_and_never_calls_record_function(kind,
                                                             monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("record_function called with tracing off")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    _run(kind)
    assert trace.snapshot()["spans"] == {}


@pytest.mark.parametrize("kind", ["detect", "train"])
def test_on_without_a_profiler_never_calls_record_function(kind,
                                                           monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("record_function called with no profiler")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    trace.enable()
    _run(kind)
    trace.disable()
    assert set(trace.snapshot()["spans"]) == set(TREES[kind])


@pytest.mark.parametrize("kind", ["detect", "train"])
def test_on_records_the_span_tree_once_a_step(kind):
    trace.enable()
    _run(kind)
    trace.disable()
    spans = trace.snapshot()["spans"]
    tree = TREES[kind]
    assert set(spans) == set(tree)
    for name, parent in tree.items():
        s = spans[name]
        assert s["calls"] == 1 and s["parents"] == [parent], name
        # data.prep runs before the step it feeds: it belongs to step 0
        assert s["steps"] == ([0] if name == "data.prep" else [1]), name
        assert s["self_ms"][0] >= 0
    for name in tree:
        children = [c for c, p in tree.items() if p == name]
        assert spans[name]["ms"][0] >= sum(spans[c]["ms"][0]
                                           for c in children), name
        assert spans[name]["self_ms"][0] == pytest.approx(
            spans[name]["ms"][0] - sum(spans[c]["ms"][0] for c in children),
            abs=1e-6)


@pytest.mark.parametrize("kind", ["detect", "train"])
def test_profiler_sees_the_same_tree(kind):
    trace.enable()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _run(kind)
    trace.disable()
    tree = TREES[kind]
    ranges = sorted((e.start_ns(), -e.duration_ns(), e.name())
                    for e in prof.profiler.kineto_results.events()
                    if e.name() in tree)
    assert sorted(n for _, _, n in ranges) == sorted(tree)
    for i, (s, d, name) in enumerate(ranges):
        outer = [n for s2, d2, n in ranges[:i] if s2 - d2 >= s - d]
        assert (outer[-1] if outer else "") == tree[name], name


@pytest.mark.parametrize("kind", ["detect", "train"])
def test_outputs_are_bit_equal_with_tracing_on(kind):
    off = _run(kind)
    trace.enable()
    on = _run(kind)
    trace.disable()
    flat_off = torch.utils._pytree.tree_leaves(off)
    flat_on = torch.utils._pytree.tree_leaves(on)
    assert len(flat_off) == len(flat_on) >= 2
    for a, b in zip(flat_off, flat_on):
        assert torch.equal(a, b)


def test_export_is_the_same_graph_with_tracing_on():
    """The serving program (utils/serving.py) exported off, on, and on
    under a profiler: one graph, no profiler node, K1 and K2 once each."""
    model, spec = _detect_model()
    program = serving._DetectProgram(model, spec, 20, 0.0)
    args = (dict(model.state_dict()), torch.zeros(2, *CANVAS, 3),
            torch.tensor([[72., 96., 1.], [80., 110., 1.]]), torch.ones(2, 2))

    def graph():
        with torch.no_grad():
            nodes = torch.export.export(program, args).graph.nodes
        return [(n.op, str(n.target)) for n in nodes]
    off = graph()
    trace.enable()
    on = graph()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        profiled = graph()
    trace.disable()
    assert on == off and profiled == off
    assert not [t for _, t in off if "profiler" in t or "record" in t]
    assert [sum(t == f"frcnn.{op}.default" for _, t in off)
            for op in ("nms_keep_mask", "batched_nms_keep")] == [1, 1]


def test_buffer_keeps_the_last_steps():
    trace.enable()
    for _ in range(trace.MAX_STEPS + 6):
        with trace.span("detect.step", step=True):
            with trace.span("detect.postprocess"):
                pass
    trace.disable()
    spans = trace.snapshot()["spans"]
    assert spans["detect.step"]["steps"] == list(
        range(7, trace.MAX_STEPS + 7))
    assert spans["detect.postprocess"]["calls"] == trace.MAX_STEPS


# -- the counters -----------------------------------------------------------

def test_launch_counts_are_views_of_the_counters():
    assert not hasattr(K.nms_keep_mask_batched, "launches")
    assert not hasattr(K.batched_nms_keep, "launches")
    trace.count("k1.launches", 3)
    trace.count("k2.launches")
    trace.count("other")
    assert K.launch_counts() == {"nms_keep_mask_batched": 3,
                                 "batched_nms_keep": 1}
    K.reset_launch_counts()
    assert K.launch_counts() == {"nms_keep_mask_batched": 0,
                                 "batched_nms_keep": 0}
    assert trace.counts() == {"other": 1}
    assert trace.snapshot()["counters"] == {"other": 1}


# -- the benchmark's reduction ----------------------------------------------

class _Event:
    """A kineto event's surface, as profiling.trace and stages read it."""

    def __init__(self, name, start, end, cuda=False, thread=1):
        self._args = (name, start, end - start, cuda, thread)

    def name(self):
        return self._args[0]

    def start_ns(self):
        return self._args[1]

    def duration_ns(self):
        return self._args[2]

    def device_type(self):
        return (torch.autograd.DeviceType.CUDA if self._args[3]
                else torch.autograd.DeviceType.CPU)

    def start_thread_id(self):
        return self._args[4]


def _events():
    """Two steps of a detect loop on a toy timeline (ns): bench spans on
    the host, kernels on the device, launches on the host."""
    ev = []
    for k, t in enumerate((0, 1000)):
        ev += [_Event("bench.prep", t, t + 100),
               _Event("bench.call", t + 100, t + 700),
               _Event("bench.fetch", t + 700, t + 900),
               _Event("cudaLaunchKernel", t + 20, t + 25),
               _Event("cudaLaunchKernel", t + 150, t + 155),
               _Event("cuLaunchKernel", t + 420, t + 425),
               _Event("elementwise_kernel", t + 30, t + 90, cuda=True),
               _Event("conv_kernel", t + 160, t + 400, cuda=True),
               _Event("nms_keep_kernel", t + 430, t + 480, cuda=True),
               _Event("Memcpy DtoH", t + 700, t + 720, cuda=True)]
    return ev


def _program(ev):
    """ev with the program's spans of each step, and their device-side
    copies (range annotations over the kernels they launched)."""
    out = list(ev)
    for t in (0, 1000):
        out += [_Event("data.prep", t + 10, t + 95),
                _Event("detect.step", t + 110, t + 690),
                _Event("model.head", t + 120, t + 300),
                _Event("model.rpn", t + 300, t + 500),
                _Event("detect.postprocess", t + 500, t + 680),
                _Event("detect.step", t + 160, t + 480, cuda=True),
                _Event("model.rpn", t + 430, t + 480, cuda=True)]
    return out


def _profiled(monkeypatch, events):
    """profiling.trace on a fake profiler that yields events."""
    class Fake:
        def __init__(self, activities):
            self.profiler = types.SimpleNamespace(
                kineto_results=types.SimpleNamespace(events=lambda: events))

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False
    monkeypatch.setattr(torch.profiler, "profile", Fake)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    return profiling.trace(lambda i: None, 2)


NAMES = {"data.prep", "detect.step", "model.head", "model.rpn",
         "detect.postprocess"}


def test_reduction_leaves_the_trace_keys_as_they_are(monkeypatch):
    """With no program span, the keys are profiling.trace's own; with the
    program's spans and their device-side copies, they do not move."""
    want = _profiled(monkeypatch, _events())
    plain = stages.reduce_events(_events(), set(), 2)
    assert plain.pop("stages")["spans"] == {
        "": {"calls": 0, "idle_s": pytest.approx(want["window_s"]
                                                 - want["busy_s"]),
             "launches": 6}}
    assert plain == want
    traced = stages.reduce_events(_program(_events()), NAMES, 2)
    traced.pop("stages")
    assert traced == want
    # profiling.trace itself would count the copies as device time
    assert _profiled(monkeypatch, _program(_events()))["device_ops"] > \
        want["device_ops"]


def test_a_gap_goes_to_the_innermost_span():
    parts = stages.split(_program(_events()), NAMES)
    timeline, st = stages.reduce(parts["dev"], parts["bench"],
                                 parts["spans"], parts["launches"])
    spans = st["spans"]
    # [400, 430] idle: model.rpn inside detect.step inside bench.call
    assert spans["model.rpn"]["idle_s"] == pytest.approx(2 * 30e-9)
    # [480, 700] idle, midpoint 590: detect.postprocess
    assert spans["detect.postprocess"]["idle_s"] == pytest.approx(2 * 220e-9)
    # [90, 160] idle, midpoint 125: model.head
    assert spans["model.head"]["idle_s"] == pytest.approx(2 * 70e-9)
    assert spans["detect.step"]["idle_s"] == 0
    assert spans["detect.step"]["calls"] == 2
    # the idle under bench.call all lies under program spans
    assert st["in_bench"]["bench.call"] == pytest.approx(
        timeline["idle"]["bench.call"])
    # launches count in every span they start in
    assert spans["detect.step"]["launches"] == 4
    assert spans["model.head"]["launches"] == 2
    assert spans["model.rpn"]["launches"] == 2
    assert spans["data.prep"]["launches"] == 2
    assert spans[""]["launches"] == 0


def test_launches_from_another_thread_count_in_the_backward():
    ev = [_Event("bench.call", 0, 1000),
          _Event("train.step", 10, 990),
          _Event("train.forward", 20, 300),
          _Event("train.backward", 300, 800),
          _Event("train.update", 800, 980),
          _Event("cudaLaunchKernel", 50, 52),
          _Event("cudaLaunchKernelExC", 400, 402, thread=7),
          _Event("cudaLaunchKernel", 500, 502, thread=7),
          _Event("cudaLaunchKernel", 850, 852),
          _Event("k", 60, 900, cuda=True)]
    names = {"train.step", "train.forward", "train.backward",
             "train.update"}
    st = stages.reduce_events(ev, names, 1)["stages"]["spans"]
    assert st["train.backward"]["launches"] == 2
    assert st["train.forward"]["launches"] == 1
    assert st["train.update"]["launches"] == 1
    assert st["train.step"]["launches"] == 4
    record = {"trace": {"steps": 1, "stages": {"spans": st}}}
    assert stages.read(record, "train") == {"step_launches.train": 4.0}


def test_host_summary_and_readers():
    trace.enable()
    for _ in range(3):
        with trace.span("detect.step", step=True):
            with trace.span("model.head"):
                pass
    trace.disable()
    host = stages.host_summary(trace.snapshot(), [0.002, 0.004])
    assert host["steps"] == 3 and host["call_ms"] == pytest.approx(3.0)
    assert host["spans"]["model.head"]["calls_per_step"] == 1
    record = {"stage_host": host}
    assert stages.host_ms(record, "model.head") == \
        host["spans"]["model.head"]["ms"]
    assert stages.host_ms(record, "model.rpn") is None
    assert stages.host_ms({}, "model.head") is None
    assert stages.step_launches(record, "detect.step") is None
    assert set(stages.read(record, "detect")) == {"head_host_ms.detect"}


def test_profile_window_turns_tracing_on_for_its_steps(tmp_path):
    """TPU.PROFILE_DIR's window (engine/train_loop.py): tracing on while
    its profiler runs, off after; the trace it writes names the stages."""
    from tf_faster_rcnn_torch.engine import train_loop
    setup = _train_setup()
    profiler = train_loop._start_profiler(torch.device("cpu"))
    _train_step(setup)
    train_loop._stop_profiler(profiler, str(tmp_path), 7)
    _train_step(setup)
    # the step in the window was recorded, the one after it was not
    assert trace.snapshot()["spans"]["train.step"]["steps"] == [1]
    with open(tmp_path / "trace_iter_7.json") as f:
        chrome = f.read()
    for name in set(TREES["train"]) - {"data.prep"}:
        assert f'"name": "{name}"' in chrome, name
