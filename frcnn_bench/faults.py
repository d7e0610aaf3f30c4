"""Faults planted under the timed path, to show that the comparison sees
them: each is a context manager that wraps a step builder of the measured
program for as long as it is open. Used by the tests and by
``calibrate.py --fault``; the benchmark's own runs never open one."""

from __future__ import annotations

import contextlib

import torch

__all__ = ["FAULTS"]


@contextlib.contextmanager
def _wrap(module_name, attr, change):
    import importlib
    module = importlib.import_module(module_name)
    make = getattr(module, attr)

    def make_broken(*args, **kw):
        step = make(*args, **kw)

        def broken(*a, **k):
            return change(step, *a, **k)
        return broken
    setattr(module, attr, make_broken)
    try:
        yield
    finally:
        setattr(module, attr, make)


def altered_answer():
    """The top detection of every image comes back under another class."""
    def change(detect, image, info, orig):
        det, dv = detect(image, info, orig)
        det = det.clone()
        det[:, 0, 0] = det[:, 0, 0] % 20 + 1       # VOC: classes 1..20
        return det, dv
    return _wrap("tf_faster_rcnn_torch.engine.test_engine", "make_detect_fn",
                 change)


def half_batch_detect():
    """The second half of each batch is never read: the first half's
    images stand in its place."""
    def change(detect, image, info, orig):
        b = image.shape[0] // 2
        return detect(torch.cat([image[:b], image[:b]]), info, orig)
    return _wrap("tf_faster_rcnn_torch.engine.test_engine", "make_detect_fn",
                 change)


def unchanged_state():
    """The train step computes, then puts the parameters and the momentum
    back as they were."""
    def change(step, state, batch, noise=None):
        params = {k: p.detach().clone() for k, p in state.params().items()}
        trace = {k: t.clone() for k, t in state.trace.items()}
        state, metrics = step(state, batch, noise)
        with torch.no_grad():
            for k, p in state.params().items():
                p.copy_(params[k])
            for k, t in state.trace.items():
                t.copy_(trace[k])
        return state, metrics
    return _wrap("tf_faster_rcnn_torch.engine.train", "make_train_step",
                 change)


def half_batch_train():
    """The train step sees the first half of the batch and its noise; its
    losses are the means over that half."""
    def change(step, state, batch, noise=None):
        b = batch["image"].shape[0] // 2
        batch = {k: v[:b] for k, v in batch.items()}
        noise = type(noise)(*(t[:b] for t in noise[:4]), dropout=None)
        return step(state, batch, noise)
    return _wrap("tf_faster_rcnn_torch.engine.train", "make_train_step",
                 change)


FAULTS = {"altered_answer": altered_answer,
          "half_batch_detect": half_batch_detect,
          "unchanged_state": unchanged_state,
          "half_batch_train": half_batch_train}
