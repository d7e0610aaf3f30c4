"""Ranks for the CLIs: how many, on which devices, and their launch.

``--devices N`` on one host starts N ranks, one device each, joined by a
TCP rendezvous on localhost (``torch.multiprocessing.spawn``): ``cuda:r``
for rank r on CUDA, where fewer than N GPUs is an error, and gloo
processes on the CPU. The multi-host flags (``--coordinator``,
``--num-procs``, ``--proc-id``) make this process one rank of a run that
spans hosts; on CUDA it drives the GPU of index proc_id modulo the host's
GPUs, unless ``--device`` names one. A rank that fails fails the launcher.
"""

from __future__ import annotations

import os
import socket
from typing import Callable

import torch

__all__ = ["free_port", "launch", "local_ranks", "rank_device"]


def local_ranks(args) -> int:
    """The ranks that this process starts on its host. Under the multi-host
    flags (or their FRCNN_* variables) it is one rank itself, and --devices
    above 1 is an error. Else --devices ranks (0 = every GPU, or one on the
    CPU); raises SystemExit where the GPUs are fewer."""
    if (args.coordinator or args.num_procs or args.proc_id is not None
            or "FRCNN_NUM_PROCS" in os.environ):
        if args.devices > 1:
            raise SystemExit(f"--devices {args.devices} starts the ranks of "
                             "one host; with the multi-host flags each "
                             "process is one rank: pass --devices 1")
        return 1
    if torch.device(args.device).type != "cuda":
        return max(1, int(args.devices))
    count = torch.cuda.device_count()
    n = int(args.devices) or count
    if n < 1 or count < n:
        raise SystemExit(f"--devices {args.devices} asks for {max(n, 1)} "
                         f"GPUs, and this host has {count} "
                         "(torch.cuda.device_count())")
    return n


def free_port() -> int:
    """A TCP port free on localhost now, for a rendezvous."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def launch(args, run: Callable):
    """Run a CLI's ``run(args)`` as its flags ask: here, as one rank of a
    multi-host run (the flags or their FRCNN_* variables) or alone; or in
    ``--devices`` ranks on this host, each a process of its own with
    args.coordinator, num_procs, proc_id and device set, and wait for all
    (raising if any fails; the others are then stopped). run must be a
    module-level function of an importable module."""
    n = local_ranks(args)
    if n == 1:
        return run(args)
    print(f"Running data-parallel over {n} ranks on {args.device}")
    torch.multiprocessing.spawn(
        _run_rank, args=(run, args, n, f"localhost:{free_port()}"),
        nprocs=n, join=True)
    return None


def _run_rank(rank, run, args, n, coordinator):
    args.coordinator, args.num_procs, args.proc_id = coordinator, n, rank
    if torch.device(args.device).type == "cuda":
        args.device = f"cuda:{rank}"
    run(args)


def rank_device(args) -> str:
    """This process's device: a multi-host rank with a bare ``cuda``
    drives the GPU of index proc_id (the flag or FRCNN_PROC_ID) modulo the
    host's GPUs; otherwise ``--device`` as given."""
    proc_id = args.proc_id
    if proc_id is None and "FRCNN_PROC_ID" in os.environ:
        proc_id = int(os.environ["FRCNN_PROC_ID"])
    dev = torch.device(args.device)
    if proc_id is None or dev.type != "cuda" or dev.index is not None:
        return args.device
    count = torch.cuda.device_count()
    if count == 0:
        raise SystemExit(f"--device {args.device}: torch finds no CUDA "
                         "device")
    return f"cuda:{int(proc_id) % count}"
