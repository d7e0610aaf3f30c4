"""ctypes loader for the host NMS and IoU ops of ``native/nms_oracle.cpp``.

A copy of ``tf_faster_rcnn_tpu/utils/native.py`` (``nms_cpu``,
``bbox_overlaps_cpu``, and the numpy oracle ``py_cpu_nms``) that builds the same C++ source with g++ on first use
into the port's own ignored build directory, ``tf_faster_rcnn_torch/csrc/
build/``, so that the two packages never write one shared library. The build
goes to a temporary name and is renamed into place, so concurrent processes
see the whole library or none. Nothing here runs at import time.

These are host-side helpers: eval-time re-NMS of pickled detections
(``engine/test_engine.py::apply_nms``), the IoU of dataset code, and an
oracle for the NMS tests.
"""

from __future__ import annotations

import ctypes
import os
import os.path as osp
import subprocess
import threading

import numpy as np

__all__ = ["nms_cpu", "bbox_overlaps_cpu", "py_cpu_nms"]

_ROOT = osp.abspath(osp.join(osp.dirname(__file__), "..", ".."))
_SRC = osp.join(_ROOT, "native", "nms_oracle.cpp")
_LIB_PATH = osp.join(_ROOT, "tf_faster_rcnn_torch", "csrc", "build",
                     "libnms_oracle.so")

_lock = threading.Lock()
_lib = None


def _build_lib():
    os.makedirs(osp.dirname(_LIB_PATH), exist_ok=True)
    tmp = f"{_LIB_PATH}.{os.getpid()}.tmp"
    cmd = ["g++", "-O3", "-march=native", "-shared", "-fPIC", "-std=c++17",
           _SRC, "-o", tmp]
    subprocess.run(cmd, check=True, capture_output=True)
    os.replace(tmp, _LIB_PATH)


def get_lib():
    global _lib
    with _lock:
        if _lib is None:
            if (not osp.exists(_LIB_PATH)
                    or osp.getmtime(_LIB_PATH) < osp.getmtime(_SRC)):
                _build_lib()
            lib = ctypes.CDLL(_LIB_PATH)
            lib.nms_cpu.restype = ctypes.c_int
            lib.nms_cpu.argtypes = [
                ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_float,
                ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
            lib.bbox_overlaps_cpu.restype = None
            lib.bbox_overlaps_cpu.argtypes = [
                ctypes.POINTER(ctypes.c_float), ctypes.c_int,
                ctypes.POINTER(ctypes.c_float), ctypes.c_int,
                ctypes.c_int, ctypes.POINTER(ctypes.c_float)]
            _lib = lib
    return _lib


def nms_cpu(dets: np.ndarray, thresh: float, *, plus_one: bool = True,
            suppress_eq: bool = True) -> np.ndarray:
    """Greedy NMS. dets: [N, 5] (x1, y1, x2, y2, score). Returns the kept
    indices.

    (plus_one=True, suppress_eq=True) is the reference's cpu_nms;
    (plus_one=True, suppress_eq=False) its gpu_nms; (plus_one=False,
    suppress_eq=False) TF's non_max_suppression.
    """
    dets = np.ascontiguousarray(dets, dtype=np.float32)
    n = dets.shape[0]
    if n == 0:
        return np.empty((0,), dtype=np.int64)
    keep = np.empty((n,), dtype=np.int32)
    num = get_lib().nms_cpu(
        dets.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n,
        ctypes.c_float(thresh), int(plus_one), int(suppress_eq),
        keep.ctypes.data_as(ctypes.POINTER(ctypes.c_int)))
    return keep[:num].astype(np.int64)


def bbox_overlaps_cpu(boxes: np.ndarray, query: np.ndarray,
                      *, plus_one: bool = True) -> np.ndarray:
    """Dense IoU matrix [N, K] of boxes [N, 4] against query [K, 4]."""
    boxes = np.ascontiguousarray(boxes, dtype=np.float32)
    query = np.ascontiguousarray(query, dtype=np.float32)
    n, k = boxes.shape[0], query.shape[0]
    out = np.empty((n, k), dtype=np.float32)
    if n and k:
        get_lib().bbox_overlaps_cpu(
            boxes.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n,
            query.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), k,
            int(plus_one), out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    return out


def py_cpu_nms(dets: np.ndarray, thresh: float) -> list:
    """Vectorized numpy greedy NMS oracle (+1 areas, suppress at iou > thresh).

    Semantics of the reference's pure-python fallback
    (lib/nms/py_cpu_nms.py:10-38); kept as an independent second oracle for
    kernel tests.
    """
    x1, y1, x2, y2 = dets[:, 0], dets[:, 1], dets[:, 2], dets[:, 3]
    scores = dets[:, 4]
    areas = (x2 - x1 + 1) * (y2 - y1 + 1)
    order = scores.argsort()[::-1]
    keep = []
    while order.size > 0:
        i = order[0]
        keep.append(int(i))
        xx1 = np.maximum(x1[i], x1[order[1:]])
        yy1 = np.maximum(y1[i], y1[order[1:]])
        xx2 = np.minimum(x2[i], x2[order[1:]])
        yy2 = np.minimum(y2[i], y2[order[1:]])
        w = np.maximum(0.0, xx2 - xx1 + 1)
        h = np.maximum(0.0, yy2 - yy1 + 1)
        inter = w * h
        ovr = inter / (areas[i] + areas[order[1:]] - inter)
        inds = np.where(ovr <= thresh)[0]
        order = order[inds + 1]
    return keep
