"""Builds the port's CUDA kernels with nvcc and loads them with ctypes.

The sources are ``tf_faster_rcnn_torch/csrc/*.cu``; each exports a plain C
interface (pointers, ints, floats, a stream) and returns
``cudaGetLastError()``. The shared library is built on first use into
``csrc/build/`` (listed in .gitignore), under a name keyed on a hash of the
sources and flags, so an edited source rebuilds and an unchanged one loads at
once. Nothing here runs at import time: the CPU tests import every module on
a machine without nvcc.

The counterpart of ``tf_faster_rcnn_tpu/utils/native.py::get_lib``, which
builds the host NMS oracle with g++ the same way.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import os.path as osp
import shutil
import subprocess
import threading
import time

__all__ = ["NVCC_FLAGS", "get_lib", "build_info"]

_CSRC = osp.abspath(osp.join(osp.dirname(__file__), "..", "csrc"))
_BUILD_DIR = osp.join(_CSRC, "build")

# -fmad=false: the NMS IoU must round exactly as the JAX formula does, which
# an FMA-contracted `area + area' - inter` would not. No --use_fast_math
# anywhere: it would also swap the IEEE division for an approximate one.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-fmad=false", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
_SIGNATURES = {
    "frcnn_nms_max_kept": ([], _I),
    "frcnn_nms_keep": ([_P, _P, _I, _I, _F, _I, _I, _I, _P, _P, _P], _I),
    "frcnn_epilogue_fwd": ([_I, _P, _P, _I, _I, _I, _I, _P, _P, _P, _P, _F,
                            _P, _L, _L, _L, _P, _I, _I, _P], _I),
    "frcnn_epilogue_bwd": ([_I, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P,
                            _F, _P, _I, _P], _I),
}

_lock = threading.Lock()
_lib = None
_info: dict = {}


def _sources():
    return sorted(glob.glob(osp.join(_CSRC, "*.cu"))
                  + glob.glob(osp.join(_CSRC, "*.cuh")))


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    for cand in (osp.join(cuda_home, "bin", "nvcc"), shutil.which("nvcc")):
        if cand and osp.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin, "
                       "/usr/local/cuda/bin and PATH): the CUDA kernels of "
                       "tf_faster_rcnn_torch build only where the CUDA "
                       "toolkit is installed")


def _digest(sources) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sources:
        h.update(osp.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def _build(sources, lib_path):
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{lib_path}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
           *[s for s in sources if s.endswith(".cu")]]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}"
                           f"\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib_path)  # atomic: a concurrent loader sees all or none
    return time.perf_counter() - t0, proc.stdout + proc.stderr


def get_lib() -> ctypes.CDLL:
    """The kernels' shared library, built on first use."""
    global _lib
    if _lib is not None:        # every launch asks: no lock once it is loaded
        return _lib
    with _lock:
        if _lib is None:
            sources = _sources()
            lib_path = osp.join(_BUILD_DIR,
                                f"libfrcnn_kernels_{_digest(sources)}.so")
            seconds, log = 0.0, ""
            built = not osp.exists(lib_path)
            if built:
                seconds, log = _build(sources, lib_path)
            lib = ctypes.CDLL(lib_path)
            for name, (argtypes, restype) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = restype
            _info.update(path=lib_path, built=built, seconds=seconds, log=log)
            _lib = lib
    return _lib


def build_info() -> dict:
    """Where the library came from: path, whether this process built it,
    the nvcc wall time and its output (ptxas register/shared-memory report).
    Empty until get_lib() has run."""
    return dict(_info)
