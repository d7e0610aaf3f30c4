"""One rank of the port's four-process model-axis suite.

Launched by ``tests/test_torch_model_axis.py`` (``python
torch_model_axis_worker.py <rank> <port> <dir>``): joins a gloo group of
four on the CPU, lays it out as a 2 x 2 ('data', 'model') mesh, runs every
scenario back to back and writes its results to ``<dir>/rank<rank>.pkl``.
The scenarios that need no input run first, while the test writes the
inputs: the tiny vgg16 state, its batch, the JAX noise and the one-rank
snapshot to ``<dir>/inputs.pkl``, then the res50 parameters and images,
the mini-VOC and the mobile weights to ``<dir>/more_inputs.pkl``; the
test then holds the results against the JAX package and the port's one
rank. A worker imports neither JAX nor
the JAX package, and says so in its results.

Not a pytest file (no test_ prefix): it is the spawned program.
"""

import dataclasses
import os
import pickle
import sys
import time

import torch
import torch.distributed as tdist
import torch.nn.functional as F

import torch_parallel_worker as dp_worker

RANKS = 4
MODEL = 2
# the res50 TEST forward of tests/test_multichip.py::
# test_hybrid_tp_detect_matches_single_device
RES50 = dict(anchor_scales=(2, 4), rpn_pre_nms_top_n=128,
             rpn_post_nms_top_n=16)
PREFIX = "ma"
# rows of the halo-op cases: even and uneven splits over 2 and 3 ranks
HALO_ROWS = {2: (10, 9), 3: (13, 11)}


def halo_cases():
    """name -> (split op (sp, x, h) -> (rows, h), unsplit op x -> y), in
    float64 (a misplaced row shows as an O(1) error)."""
    from tf_faster_rcnn_torch.models.layers import ConvSame, mask_valid
    torch.manual_seed(0)
    dt = torch.float64
    convs = {"conv3x3 /1": ConvSame(4, 5, 3, 1, compute_dtype=dt),
             "conv3x3 /2": ConvSame(4, 5, 3, 2, compute_dtype=dt),
             "stem conv7x7 /2": ConvSame(4, 3, 7, 2, bias=False,
                                         compute_dtype=dt),
             "depthwise3x3 /2": ConvSame(4, 4, 3, 2, bias=False, groups=4,
                                         compute_dtype=dt),
             "conv1x1 /2": ConvSame(4, 5, 1, 2, bias=False,
                                    compute_dtype=dt)}
    cases = {}
    for name, conv in convs.items():
        conv.double()
        cases[name] = (lambda sp, x, h, c=conv: sp.conv(c, x, h), conv)
    valid = torch.tensor([[7.0, 6.0], [4.0, 7.0]], dtype=torch.float32)
    cases.update({
        "stem pool": (lambda sp, x, h: sp.stem_pool(x, h),
                      lambda x: F.max_pool2d(F.pad(x, (1, 1, 1, 1)), 3, 2)),
        "vgg16 SAME pool": (lambda sp, x, h: sp.same_pool(x, h),
                            lambda x: F.max_pool2d(x, 2, 2, ceil_mode=True)),
        "subsample /2": (lambda sp, x, h: sp.subsample(x, h, 2),
                         lambda x: x[:, :, ::2, ::2]),
        "mask_valid": (lambda sp, x, h: (sp.mask(x, h, valid), h),
                       lambda x: mask_valid(x, valid))})
    return cases


def halo_ops(mesh):
    """Each case on 2 and 3 row shards (the mesh's model group; a group of
    ranks 0-2): the largest |difference| of the forward and of the input
    gradient from the unsplit op, by (shards, rows, case); ranks outside
    a group report nothing for it."""
    from tf_faster_rcnn_torch.parallel.mesh import MODEL_AXIS, model_index
    from tf_faster_rcnn_torch.parallel.spatial import (SpatialPartition,
                                                       row_split)
    three = tdist.new_group([0, 1, 2])
    groups = {2: SpatialPartition(mesh.get_group(MODEL_AXIS), 2,
                                  model_index(mesh))}
    rank = tdist.get_rank()
    if rank < 3:
        groups[3] = SpatialPartition(three, 3, rank)
    errors = {}
    for count, sp in groups.items():
        for h in HALO_ROWS[count]:
            gen = torch.Generator().manual_seed(h)
            for name, (split, full) in halo_cases().items():
                x_full = torch.randn(2, 4, h, 7, generator=gen,
                                     dtype=torch.float64)
                start, stop = row_split(h, count)[sp.index]
                x = x_full[:, :, start:stop].clone().requires_grad_()
                y, h_out = split(sp, x, h)
                y = sp.gather(y, h_out)
                xf = x_full.clone().requires_grad_()
                yf = full(xf)
                g = torch.randn(yf.shape, generator=gen, dtype=torch.float64)
                (y * g).sum().backward()
                (yf * g).sum().backward()
                errors[(count, h, name)] = (
                    float((y - yf).abs().max()),
                    float((x.grad - xf.grad[:, :, start:stop]).abs().max()),
                    tuple(y.shape) == tuple(yf.shape))
    return errors


def layout_round_trip(mesh):
    """For vgg16 (fc6 on 1x1 crops), res50 and mobile (0.25): a TrainState
    with a seeded momentum laid out by shard_params, then gather_params:
    whether every tensor came back bit for bit, and each tensor's shape on
    this rank."""
    from tf_faster_rcnn_torch.engine.train import create_train_state
    from tf_faster_rcnn_torch.models.network import FasterRCNN, ModelSpec
    from tf_faster_rcnn_torch.parallel.mesh import (gather_params,
                                                    shard_params)
    out = {}
    for backbone, extra in (("vgg16", dict(pooling_size=1)),
                            ("res50", {}),
                            ("mobile", dict(depth_multiplier=0.25))):
        spec = ModelSpec(backbone, 21, mode="TRAIN", **extra)
        torch.manual_seed(1)
        model = FasterRCNN(spec, device="cpu")
        with torch.no_grad():
            for t in model.state_dict().values():
                t.copy_(torch.randn(t.shape))
        state = create_train_state(spec, model, torch.Generator(), 1)
        for t in state.trace.values():
            t.copy_(torch.randn(t.shape))
        want = state.state_dict()
        shard_params(mesh, state, backbone)
        shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
        shapes.update({"trace:" + k: tuple(v.shape)
                       for k, v in state.trace.items()})
        back = gather_params(mesh, state)
        same = all(torch.equal(back[part][k], want[part][k])
                   for part in ("params", "trace") for k in want[part])
        out[backbone] = {"lossless": same and set(back["params"]) ==
                         set(want["params"]), "shapes": shapes}
    return out


def tiny(inputs, mesh, generator_seed=11):
    """(model, state, step) of the tiny vgg16 from the bridged JAX state in
    inputs, laid out for the mesh, with the hybrid step (or one rank's
    step for no mesh)."""
    from tf_faster_rcnn_torch.config import cfg
    from tf_faster_rcnn_torch.engine import train as ttrain
    from tf_faster_rcnn_torch.models import network as tnet
    from tf_faster_rcnn_torch.parallel.mesh import shard_params
    cfg.TRAIN.LEARNING_RATE = inputs["learning_rate"]
    spec = dataclasses.replace(tnet.spec_from_cfg("vgg16", 21, "TRAIN"),
                               **dp_worker.TINY)
    model = tnet.FasterRCNN(spec, device="cpu")
    state = ttrain.create_train_state(
        spec, model, torch.Generator().manual_seed(generator_seed),
        inputs["global_batch"])
    state.load_state_dict(inputs["state"])
    step = ttrain.make_train_step(model, spec, weight_decay=1e-4,
                                  nan_guard=True, mesh=mesh)
    return model, state, step


def steps(inputs, mesh, noises=None, restore=None, snapshot_dir=None, n=1,
          trace=True):
    """n steps of the tiny vgg16 (from the inputs' state, or the snapshot
    restore, laid out after the restore as the loop does) on this rank's
    part of the global batch (its data group's images, its rows of the
    canvas), with the given global noise of each step or the state's own
    draws; returns each step's metrics, the step, the snapshot written
    (gathered, by the coordinator), the fingerprints of the layout-free
    state after, and on the coordinator its parameters (and, with trace,
    its momentum)."""
    from tf_faster_rcnn_torch.models.network import shard_noise
    from tf_faster_rcnn_torch.parallel import dist
    from tf_faster_rcnn_torch.parallel.mesh import (data_axis_size,
                                                    data_index,
                                                    gather_params,
                                                    shard_batch,
                                                    shard_params)
    from tf_faster_rcnn_torch.utils import checkpoint as ckpt
    model, state, step = tiny(inputs, mesh)
    if restore:
        ckpt.restore(state, restore)
    shard_params(mesh, state, "vgg16")
    batch = {k: torch.from_numpy(v) for k, v in inputs["batch"].items()}
    batch = shard_batch(mesh, batch, spatial=True)
    metrics = []
    for i in range(n):
        noise = None
        if noises is not None:
            noise = shard_noise(noises[i], data_index(mesh),
                                data_axis_size(mesh))
        _, m = step(state, batch, noise=noise)
        metrics.append({k: float(v) for k, v in m.items()})
    snap = None
    if snapshot_dir:
        written = ckpt.snapshot(snapshot_dir, PREFIX, state, data_state={},
                                mesh=mesh)
        snap = written and written[0]
    full = gather_params(mesh, state)
    out = {"metrics": metrics, "step": int(state.step), "snapshot": snap,
           "canvas_h": batch.get("canvas_h"),
           "rows": tuple(batch["image"].shape),
           "fingerprint": (dp_worker.fingerprint(full["params"]),
                           dp_worker.fingerprint(full["trace"]))}
    if dist.process_index() == 0:
        out["params"] = full["params"]
        if trace:
            out["trace"] = full["trace"]
    return out


def hybrid_detect(inputs, mesh):
    """The res50 TEST forward, tensor parallel and spatially partitioned,
    on this data group's images: its outputs, on model rank 0."""
    from tf_faster_rcnn_torch.models.network import FasterRCNN, ModelSpec
    from tf_faster_rcnn_torch.parallel.mesh import (model_index,
                                                    shard_batch,
                                                    shard_model)
    model = FasterRCNN(ModelSpec("res50", 21, **RES50), device="cpu").eval()
    model.load_state_dict(inputs["res50_params"])
    shard_model(mesh, model, "res50")
    batch = shard_batch(mesh, {k: torch.from_numpy(v) for k, v in
                               inputs["res50_batch"].items()}, spatial=True)
    with torch.no_grad():
        out = model(batch["image"], batch["im_info"],
                    canvas_h=batch["canvas_h"])
    if model_index(mesh):
        return None
    return {k: out[k] for k in ("cls_prob", "bbox_pred", "rois",
                                "roi_valid")}


def wait_for_inputs(work, name, timeout_s=600):
    """The inputs the test writes (atomically) to work/name while the
    ranks run the scenarios that need none."""
    path = os.path.join(work, name)
    deadline = time.time() + timeout_s
    while not os.path.exists(path):
        if time.time() > deadline:
            raise TimeoutError(f"{path} never appeared")
        time.sleep(0.1)
    with open(path, "rb") as f:
        return pickle.load(f)


def cli_args(parse, argv, port, rank):
    """A CLI's flags as one of its spawned ranks holds them
    (parallel/launch.py::_run_rank)."""
    args = parse(argv)
    args.coordinator, args.num_procs, args.proc_id = (f"localhost:{port}",
                                                      RANKS, rank)
    return args


def main():
    rank, port, work = sys.argv[1:4]
    rank = int(rank)
    torch.set_num_threads(2)
    from tf_faster_rcnn_torch import config as tconfig
    from tf_faster_rcnn_torch.parallel import dist
    from tf_faster_rcnn_torch.parallel.launch import free_port
    from tf_faster_rcnn_torch.parallel.mesh import make_hybrid_mesh
    from tf_faster_rcnn_torch.tools import test_net, trainval_net
    out = {"rank": rank, "seconds": {}}
    clock = [time.perf_counter()]

    def lap(name):
        now = time.perf_counter()
        out["seconds"][name] = now - clock[0]
        clock[0] = now

    dist.initialize(f"localhost:{port}", RANKS, rank, device="cpu")
    try:
        mesh = make_hybrid_mesh(MODEL)
        out["coords"] = (mesh.get_local_rank("data"),
                         mesh.get_local_rank("model"))
        lap("start")
        out["halo"] = halo_ops(mesh)
        lap("halo")
        out["layout"] = layout_round_trip(mesh)
        lap("layout")
        inputs = wait_for_inputs(work, "inputs.pkl")
        lap("inputs")
        out["jax_noise"] = steps(inputs, mesh, noises=inputs["jax_noise"])
        lap("jax_noise")
        # one rank's snapshot resumed at 2 x 2, whose snapshot one rank
        # resumes in turn
        out["resumed"] = steps(inputs, mesh, restore=inputs["snap_1"],
                               snapshot_dir=os.path.join(work, "snap_2x2"),
                               trace=False)
        lap("restore")
        inputs.update(wait_for_inputs(work, "more_inputs.pkl"))
        lap("more inputs")
        out["detect"] = hybrid_detect(inputs, mesh)
        lap("detect")
        # the CLIs' rendezvous ports, picked now: a port picked at the
        # start could be taken by a connection of this group meanwhile
        test_port, train_port = dist.broadcast_object(
            [free_port(), free_port()] if rank == 0 else None)
    finally:
        dist.shutdown()
    # the CLIs' rank function, as --devices 4 runs it in each rank
    tconfig.reset_cfg()
    out["test_net"] = test_net.run(cli_args(
        test_net.parse_args, inputs["test_net_argv"], test_port, rank))
    lap("test_net")
    tconfig.reset_cfg()
    state = trainval_net.run(cli_args(
        trainval_net.build_parser().parse_args, inputs["trainval_argv"],
        train_port, rank))
    out["trainval_step"] = int(state.step)
    lap("trainval_net")
    out["imported"] = sorted(m for m in sys.modules if m == "jax" or
                             m.startswith(("jax.", "tf_faster_rcnn_tpu")))
    with open(os.path.join(work, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    print(f"rank {rank} done", flush=True)


if __name__ == "__main__":
    main()
