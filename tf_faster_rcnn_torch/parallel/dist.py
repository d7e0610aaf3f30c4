"""Multi-process initialization and the host-side agreements.

Port of ``tf_faster_rcnn_tpu/parallel/dist.py``. Each process is one rank
and drives one device. ``initialize`` joins the ranks in a
``torch.distributed`` process group through a TCP rendezvous at the
coordinator's ``host:port``. That group carries the device collectives of
the train step (``parallel/mesh.py``): its backend is nccl on CUDA and gloo
on the CPU. An explicit ``backend="gloo"`` on CUDA lets two ranks share one
card, which NCCL refuses ("Duplicate GPU detected"). Nothing falls back from
one backend to the other.

The host-side agreements (the barriers, the eval's run token, the
preemption flags) ride a second group: gloo, with a long timeout. The JAX
barrier goes through the coordination service for the same reason: a
coordinator that spends minutes on the eval merge and the dataset
evaluation must not trip the device group's watchdog while the other ranks
wait.
"""

from __future__ import annotations

import datetime
import os
from typing import Any, Optional

import torch
import torch.distributed as tdist

__all__ = ["initialize", "shutdown", "is_initialized", "process_index",
           "process_count", "device", "on_coordinator", "barrier",
           "broadcast_object", "any_process", "local_slice"]

HOST_TIMEOUT_S = 1800

_HOST_GROUP = None
_DEVICE: Optional[torch.device] = None


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: Optional[str] = None, device=None) -> None:
    """Join the process group of a multi-process run.

    The arguments fall back to the FRCNN_COORDINATOR, FRCNN_NUM_PROCS and
    FRCNN_PROC_ID environment variables, as the JAX function's do. A no-op
    when already initialized, and for one process unless backend is given
    (a group of one, which drives the backend's path on a single device).
    device: this rank's device (default ``cuda``; a CUDA device becomes the
    current one, and its absence raises). backend None is nccl on a CUDA
    device and gloo on the CPU.
    """
    global _HOST_GROUP, _DEVICE
    if _DEVICE is not None:
        return
    coordinator_address = coordinator_address or os.environ.get(
        "FRCNN_COORDINATOR")
    if num_processes is None and "FRCNN_NUM_PROCS" in os.environ:
        num_processes = int(os.environ["FRCNN_NUM_PROCS"])
    if process_id is None and "FRCNN_PROC_ID" in os.environ:
        process_id = int(os.environ["FRCNN_PROC_ID"])
    if backend is None and (num_processes is None or num_processes <= 1):
        if coordinator_address and num_processes is None:
            raise ValueError(f"coordinator {coordinator_address} given "
                             "without the number of processes")
        return
    num_processes = 1 if num_processes is None else int(num_processes)
    if coordinator_address is None or process_id is None:
        raise ValueError(f"{num_processes} processes need the coordinator's "
                         "host:port and this process's id")
    if not 0 <= int(process_id) < num_processes:
        raise ValueError(f"process id {process_id} outside 0..."
                         f"{num_processes - 1}")
    dev = torch.device(device or "cuda")
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {dev}: torch finds no CUDA device")
        torch.cuda.set_device(dev)
        dev = torch.device("cuda", torch.cuda.current_device())
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    tdist.init_process_group(backend,
                             init_method=f"tcp://{coordinator_address}",
                             world_size=num_processes, rank=int(process_id))
    _HOST_GROUP = tdist.new_group(
        backend="gloo", timeout=datetime.timedelta(seconds=HOST_TIMEOUT_S))
    _DEVICE = dev


def shutdown() -> None:
    """Leave the process group (a no-op when not initialized)."""
    global _HOST_GROUP, _DEVICE
    if _DEVICE is None:
        return
    tdist.destroy_process_group()
    _HOST_GROUP, _DEVICE = None, None


def is_initialized() -> bool:
    return _DEVICE is not None


def process_index() -> int:
    return tdist.get_rank() if _DEVICE is not None else 0


def process_count() -> int:
    return tdist.get_world_size() if _DEVICE is not None else 1


def device() -> torch.device:
    """This rank's device, as initialize set it."""
    if _DEVICE is None:
        raise RuntimeError("parallel.dist.initialize has not run")
    return _DEVICE


def on_coordinator() -> bool:
    """True on the process that owns the host-side side effects
    (snapshots, metrics, TensorBoard events, the eval's merge)."""
    return process_index() == 0


def barrier(name: str, timeout_ms: int = 600_000) -> None:
    """Align all processes on the host group (gloo, never a device
    collective), waiting up to timeout_ms; a rank that does not arrive is
    named in the error. No-op for one process."""
    if process_count() <= 1:
        return
    try:
        tdist.monitored_barrier(
            group=_HOST_GROUP,
            timeout=datetime.timedelta(milliseconds=int(timeout_ms)))
    except RuntimeError as e:
        raise RuntimeError(f"barrier {name!r}: {e}") from e


def broadcast_object(obj: Any) -> Any:
    """Rank 0's obj (a picklable value) on every rank, over the host
    group; obj itself for one process."""
    if process_count() <= 1:
        return obj
    box = [obj]
    tdist.broadcast_object_list(box, src=0, group=_HOST_GROUP)
    return box[0]


def any_process(flag: bool) -> bool:
    """Whether flag is set on any process: an all_gather of every rank's
    flag over the host group."""
    n = process_count()
    if n <= 1:
        return bool(flag)
    flags = [torch.zeros(1, dtype=torch.int32) for _ in range(n)]
    tdist.all_gather(flags, torch.tensor([int(bool(flag))],
                                         dtype=torch.int32),
                     group=_HOST_GROUP)
    return any(int(f) for f in flags)


def local_slice(global_batch: int, index: int, count: int) -> slice:
    """The contiguous slice of a global batch that part index of count
    equal parts holds (a rank's rows); raises where count does not divide
    the batch."""
    if global_batch % count:
        raise ValueError(f"global batch {global_batch} not divisible by "
                         f"{count} processes")
    per = global_batch // count
    return slice(index * per, (index + 1) * per)
