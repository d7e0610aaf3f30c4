"""Ranks for the CLIs: how many, on which devices, and their launch.

``--devices N`` on one host starts N ranks, one device each, joined by a
TCP rendezvous on localhost (``torch.multiprocessing.spawn``): ``cuda:r``
for rank r on CUDA, where fewer than N GPUs is an error, and gloo
processes on the CPU. The multi-host flags (``--coordinator``,
``--num-procs``, ``--proc-id``) make this process one rank of a run that
spans hosts; on CUDA it drives the GPU of index proc_id modulo the host's
GPUs, unless ``--device`` names one. A rank that fails fails the launcher.

TPU.MODEL_DEVICES m above 1 lays the N ranks out as an (N / m, m) mesh
(``parallel/mesh.py::make_hybrid_mesh``): an N that m does not divide
exits naming both, and so do the multi-host flags ("single-host only", as
the JAX CLIs say it).
"""

from __future__ import annotations

import os
import socket
from typing import Callable

import torch

__all__ = ["free_port", "launch", "local_ranks", "model_devices",
           "rank_device"]


def _multi_host(args) -> bool:
    return bool(args.coordinator or args.num_procs
                or args.proc_id is not None
                or "FRCNN_NUM_PROCS" in os.environ)


def local_ranks(args) -> int:
    """The ranks that this process starts on its host. Under the multi-host
    flags (or their FRCNN_* variables) it is one rank itself, and --devices
    above 1 is an error. Else --devices ranks (0 = every GPU, or one on the
    CPU); raises SystemExit where the GPUs are fewer."""
    if _multi_host(args):
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


def model_devices(args) -> int:
    """TPU.MODEL_DEVICES as the CLI's --cfg and --set leave it (applied to
    the port's cfg here, as run applies them in each rank)."""
    from tf_faster_rcnn_torch.config import cfg, cfg_from_file, cfg_from_list
    if args.cfg_file is not None:
        cfg_from_file(args.cfg_file)
    if args.set_cfgs is not None:
        cfg_from_list(args.set_cfgs)
    return max(1, int(cfg.TPU.MODEL_DEVICES))


def launch(args, run: Callable, model: int = 1):
    """Run a CLI's ``run(args)`` as its flags ask: here, as one rank of a
    multi-host run (the flags or their FRCNN_* variables) or alone; or in
    ``--devices`` ranks on this host, each a process of its own with
    args.coordinator, num_procs, proc_id and device set, and wait for all
    (raising if any fails; the others are then stopped). run must be a
    module-level function of an importable module. model: the ranks of a
    model group (TPU.MODEL_DEVICES, ``model_devices``), which must divide
    the ranks of this host; above 1, single-host only."""
    if model > 1 and _multi_host(args):
        raise SystemExit(f"TPU.MODEL_DEVICES {model} > 1 is single-host "
                         "only; multi-host runs use the data axis")
    n = local_ranks(args)
    if n % model:
        raise SystemExit(f"--devices {n}: {n} ranks do not split into model "
                         f"groups of TPU.MODEL_DEVICES {model}")
    if n == 1:
        return run(args)
    from tf_faster_rcnn_torch.parallel.mesh import layout_name
    print(f"Running {layout_name(n // model, model)} over {n} ranks on "
          f"{args.device}")
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
