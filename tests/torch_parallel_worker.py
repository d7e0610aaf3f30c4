"""One rank of the port's two-process data-parallel suite.

Launched by ``tests/test_torch_parallel.py`` (``python
torch_parallel_worker.py <rank> <ranks> <port> <cli port> <dir>``): joins a
gloo group on the CPU and runs every scenario back to back, then writes its
results to ``<dir>/rank<rank>.pkl``. The inputs (the tiny vgg16 state, its
batch and the JAX noise, the 1-process snapshot, the mini-VOC and the
mobile weights) are written to ``<dir>`` by the test, which holds the
results against the JAX package and the port's single process. A worker
imports neither JAX nor the JAX package, and says so in its results.

Not a pytest file (no test_ prefix): it is the spawned program.
"""

import dataclasses
import hashlib
import os
import pickle
import sys

import torch

# the tiny vgg16 of tests/test_multichip.py::_tiny_setup, fc6 on 3x3 crops
TINY = dict(anchor_scales=(2, 4), rpn_pre_nms_top_n=256,
            rpn_post_nms_top_n=32, roi_batch_size=16, rpn_batchsize=32,
            pooling_size=3)
PREFIX = "dp"


def tiny(inputs, generator_seed):
    """(spec, model, state, step) of the tiny vgg16 from the bridged JAX
    state in inputs, on the CPU, with the data-parallel step when a
    process group is up."""
    from tf_faster_rcnn_torch.config import cfg
    from tf_faster_rcnn_torch.engine import train as ttrain
    from tf_faster_rcnn_torch.models import network as tnet
    from tf_faster_rcnn_torch.parallel import dist
    from tf_faster_rcnn_torch.parallel.mesh import make_mesh
    cfg.TRAIN.LEARNING_RATE = inputs["learning_rate"]
    spec = dataclasses.replace(tnet.spec_from_cfg("vgg16", 21, "TRAIN"),
                               **TINY)
    model = tnet.FasterRCNN(spec, device="cpu")
    state = ttrain.create_train_state(
        spec, model, torch.Generator().manual_seed(generator_seed),
        inputs["global_batch"])
    state.load_state_dict(inputs["state"])
    mesh = make_mesh() if dist.is_initialized() else None
    step = ttrain.make_train_step(model, spec, weight_decay=1e-4,
                                  nan_guard=True, mesh=mesh)
    return spec, model, state, step, mesh


def fingerprint(tensors):
    """A digest of named tensors' bytes, to tell two ranks' states apart
    without writing both."""
    digest = hashlib.sha1()
    for name in sorted(tensors):
        digest.update(name.encode())
        digest.update(tensors[name].numpy().tobytes())
    return digest.hexdigest()


def steps(inputs, noises=None, restore=None, snapshot_dir=None,
          generator_seed=11, n=2, keep=True):
    """n train steps from the inputs' state (or the snapshot restore) on
    this process's rows of the global batch, with the given global noise
    of each step or the state's own draws; returns each step's metrics,
    the step, the snapshot written, the fingerprint of the parameters and
    momentum, and with keep the parameters and momentum themselves."""
    from tf_faster_rcnn_torch.models.network import shard_noise
    from tf_faster_rcnn_torch.parallel.mesh import (data_axis_size,
                                                    data_index, shard_batch)
    from tf_faster_rcnn_torch.utils import checkpoint as ckpt
    _, model, state, step, mesh = tiny(inputs, generator_seed)
    if restore:
        ckpt.restore(state, restore)
    batch = {k: torch.from_numpy(v) for k, v in inputs["batch"].items()}
    if mesh is not None:
        batch = shard_batch(mesh, batch)
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
        written = ckpt.snapshot(snapshot_dir, PREFIX, state, data_state={})
        snap = written and written[0]
    params = {k: v.detach().clone() for k, v in model.named_parameters()}
    trace = {k: v.clone() for k, v in state.trace.items()}
    out = {"metrics": metrics, "step": int(state.step), "snapshot": snap,
           "fingerprint": (fingerprint(params), fingerprint(trace))}
    if keep:
        out.update(params=params, trace=trace)
    return out


def striped_eval(inputs, out_dir):
    """test_net over the mini-VOC's test split on the mobile weights."""
    from tf_faster_rcnn_torch import config as tconfig
    from tf_faster_rcnn_torch.datasets.pascal_voc import pascal_voc
    from tf_faster_rcnn_torch.engine.test_engine import test_net
    from tf_faster_rcnn_torch.models import network as tnet
    tconfig.reset_cfg()
    root = inputs["voc"]
    _set(dict(inputs["eval_cfg"], DATA_DIR=root, ROOT_DIR=root))
    spec = dataclasses.replace(tnet.ModelSpec("mobile", 21),
                               **inputs["eval_spec"])
    model = tnet.FasterRCNN(spec, device="cpu").eval()
    model.load_state_dict(torch.load(inputs["weights"], weights_only=True))
    return test_net(model, spec, pascal_voc("test", "2007"), "w",
                    max_per_image=100, output_dir=out_dir)


def _set(kv):
    from tf_faster_rcnn_torch.config import cfg
    for key, value in kv.items():
        *path, leaf = key.split(".")
        node = cfg
        for p in path:
            node = node[p]
        node[leaf] = value


def train_with_eval(root, loop_cfg, out_dir, tb_dir, iters):
    """train_net (mobile) on the mini-VOC's trainval split, with its
    flipped entries, and the in-training eval on its test split."""
    from tf_faster_rcnn_torch import config as tconfig
    from tf_faster_rcnn_torch.data.roidb import prepare_roidb
    from tf_faster_rcnn_torch.datasets.factory import get_imdb
    from tf_faster_rcnn_torch.engine import train_loop as tloop
    tconfig.reset_cfg()
    _set(dict(loop_cfg, DATA_DIR=root, ROOT_DIR=root))
    imdb = get_imdb("voc_2007_trainval")
    imdb.set_proposal_method("gt")
    imdb.append_flipped_images()
    prepare_roidb(imdb)
    valimdb = get_imdb("voc_2007_test")
    valimdb.set_proposal_method("gt")
    prepare_roidb(valimdb)
    state = tloop.train_net("mobile", imdb, imdb.roidb, valimdb.roidb,
                            out_dir, tb_dir, max_iters=iters,
                            valimdb=valimdb, device="cpu")
    return int(state.step)


def main():
    rank, ranks, port, cli_port, work = sys.argv[1:6]
    rank, ranks = int(rank), int(ranks)
    torch.set_num_threads(2)
    from tf_faster_rcnn_torch import config as tconfig
    from tf_faster_rcnn_torch.parallel import dist
    from tf_faster_rcnn_torch.tools import trainval_net
    with open(os.path.join(work, "inputs.pkl"), "rb") as f:
        inputs = pickle.load(f)
    out = {"rank": rank}
    dist.initialize(f"localhost:{port}", ranks, rank, device="cpu")
    # the coordinator's tensors are compared; the other rank's fingerprint
    keep = rank == 0
    try:
        out["jax_noise"] = steps(inputs, noises=inputs["jax_noise"],
                                 keep=keep)
        out["own_noise"] = steps(inputs, snapshot_dir=os.path.join(
            work, "snap_2p"), keep=keep)
        out["restored"] = steps(inputs, restore=inputs["snap_1p"], n=1,
                                keep=keep)
        out["eval_map"] = striped_eval(inputs, os.path.join(work,
                                                            "eval_2p"))
        out["loop_step"] = train_with_eval(
            inputs["voc"], inputs["loop_cfg_2p"],
            os.path.join(work, "loop_2p"), os.path.join(work, "loop_2p_tb"),
            inputs["loop_iters"])
    finally:
        dist.shutdown()
    # the CLI brings up its own group from its flags
    tconfig.reset_cfg()
    cli = ["--net", "mobile", "--imdb", "voc_2007_trainval", "--imdbval",
           "voc_2007_test", "--iters", str(inputs["cli_iters"]), "--device",
           "cpu", "--coordinator", f"localhost:{cli_port}", "--num-procs",
           str(ranks), "--proc-id", str(rank), "--set"] + inputs["cli_set"]
    state = trainval_net.main(cli)
    out["cli_step"] = int(state.step)
    out["imported"] = sorted(m for m in sys.modules if m == "jax" or
                             m.startswith(("jax.", "tf_faster_rcnn_tpu")))
    with open(os.path.join(work, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    print(f"rank {rank} done", flush=True)


if __name__ == "__main__":
    main()
