"""Stage spans and counters of the port, kept in memory.

A span marks one stage of a step where its work is done::

    with span("model.rpn"):
        ...

Tracing is off by default, and an off span is one flag check: ``span``
returns a shared no-op context, with no allocation, no clock read and no
``record_function``. The code that wants the stages turns tracing on
(``enable``) and off (``disable``): the benchmark's stage account
(``frcnn_bench/stages.py``) and the training loop's ``TPU.PROFILE_DIR``
window. There is no environment variable and no cfg key.

On, a span records its name, its parent span's name, the step it belongs
to and its host start and end (``time.perf_counter_ns``). The step is a
counter that each outermost step span (``span(name, step=True)``)
advances; a span outside any step span belongs to the step last begun
(``data.prep`` runs before its step's ``detect.step``). While a
``torch.profiler`` is active, an on span also opens
``torch.profiler.record_function(name)``, so the stage shows on the
profiler's clock beside the kernels it launched. The records of the last
``MAX_STEPS`` steps are kept; older ones are dropped.

The spans, by where they are placed:

==================== ============================================ =========
span                 covers                                       parent
==================== ============================================ =========
data.prep            ``data/blob.py::prep_batch``                 (none)
detect.step          ``engine/test_engine.py::detect_step``       (none)
model.head           the backbone head (or the spatial head)      step
model.rpn            anchors, RPN convs and scores, proposals     step
model.targets        TRAIN: the noise draw and the targets        step
model.roi_heads      crop, tail, class and box heads, cls_prob    step
detect.postprocess   ``postprocess_detections``                   detect.step
train.step           ``engine/train.py::make_train_step``'s step  (none)
train.forward        ``train_loss``: forward, losses, decay       train.step
train.backward       ``autograd.grad`` and the gradient reduce    train.step
train.update         NaN guard, learning rate, optimizer, step    train.step
==================== ============================================ =========

The ``model.*`` spans' parent is ``detect.step`` in a detect step and
``train.forward`` in a train step. No span sits inside a per-layer or
per-parameter loop.

Counters (``count``) are always on: a plain integer add each. The K1 and
K2 wrappers count their kernel launches as ``k1.launches`` and
``k2.launches`` (``ops/nms_kernels.py``). A replayed CUDA graph runs no
Python, so it bumps neither spans nor counters.
"""

from __future__ import annotations

import collections
import contextlib
import threading
import time

import torch

__all__ = ["span", "enable", "disable", "reset", "snapshot", "count",
           "counts", "zero", "MAX_STEPS"]

MAX_STEPS = 64       # the steps whose span records are kept

_on = False
_OFF = contextlib.nullcontext()
_local = threading.local()        # each thread's stack of open spans
_step = 0                         # the step last begun
# step -> [(name, parent, start ns, end ns, child ns)], oldest first
_records = collections.OrderedDict()
_counters = {}


class _Span:
    __slots__ = ("name", "is_step", "sid", "t0", "child", "parent", "range")

    def __init__(self, name, is_step):
        self.name = name
        self.is_step = is_step

    def __enter__(self):
        global _step
        stack = _stack()
        self.parent = stack[-1] if stack else None
        if self.is_step and not any(s.is_step for s in stack):
            _step += 1
            _records[_step] = []
            while len(_records) > MAX_STEPS:
                _records.popitem(last=False)
        self.sid = _step
        self.child = 0
        self.range = None
        if torch.autograd._profiler_enabled():
            self.range = torch.profiler.record_function(self.name)
            self.range.__enter__()
        stack.append(self)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        _stack().pop()
        if self.range is not None:
            self.range.__exit__(*exc)
        if self.parent is not None:
            self.parent.child += t1 - self.t0
        _records.setdefault(self.sid, []).append(
            (self.name, self.parent and self.parent.name, self.t0, t1,
             self.child))
        return False


def _stack():
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def span(name: str, step: bool = False):
    """A context manager over one stage; step: the span is a whole step
    (the outermost one advances the step counter). Off: a shared no-op."""
    if not _on:
        return _OFF
    return _Span(name, step)


def enable():
    global _on
    _on = True


def disable():
    global _on
    _on = False


def reset():
    """Drop the recorded spans, restart the step counter at 0 and zero
    every counter."""
    global _step
    _records.clear()
    _step = 0
    _counters.clear()


def count(name: str, n: int = 1):
    """Add n to the counter name (always on)."""
    _counters[name] = _counters.get(name, 0) + n


def counts() -> dict:
    """Every counter's value."""
    return dict(_counters)


def zero(*names: str):
    """Set the named counters to 0."""
    for name in names:
        _counters.pop(name, None)


def snapshot() -> dict:
    """The kept records, reduced: {"spans": {name: {"calls", "parents",
    "steps", "ms", "self_ms"}}, "counters": counts()}. For each span name:
    its number of calls, the sorted names of its parents ("" for none), the
    steps it ran in, and for each of those steps its host ms inclusive and
    self (inclusive less its child spans), summed over the step's calls."""
    spans = {}
    for step, records in _records.items():
        for name, parent, t0, t1, child in records:
            s = spans.setdefault(name, {"calls": 0, "parents": set(),
                                        "per_step": {}})
            s["calls"] += 1
            s["parents"].add(parent or "")
            ms = s["per_step"].setdefault(step, [0.0, 0.0])
            ms[0] += (t1 - t0) / 1e6
            ms[1] += (t1 - t0 - child) / 1e6
    out = {}
    for name, s in spans.items():
        steps = sorted(s["per_step"])
        out[name] = {"calls": s["calls"], "parents": sorted(s["parents"]),
                     "steps": steps,
                     "ms": [s["per_step"][k][0] for k in steps],
                     "self_ms": [s["per_step"][k][1] for k in steps]}
    return {"spans": out, "counters": counts()}
