"""The training loop: the SolverWrapper of the reference, on one device.

Port of ``tf_faster_rcnn_tpu/engine/train_loop.py``. The flow is the
reference's (lib/model/train_val.py:27-378): filter the roidbs, build the
train and val data layers (the val layer time-seeded), build the model and
the train state, initialize from ImageNet weights (``--weight``, through the
slim import surgery) or resume from the newest snapshot, then the hot loop:
a train step, the loss display every DISPLAY steps, a val-loss summary every
SUMMARY_INTERVAL seconds, a snapshot every SNAPSHOT_ITERS with SNAPSHOT_KEPT
kept, and, beyond the reference, the in-training validation mAP every
TPU.EVAL_ITERS with the best parameters kept, the NaN guard's patience, and
SIGTERM preemption (finish the step, snapshot, stop). The learning rate is a
function of the optimizer's count (``engine/train.py``), so a resume needs
no LR bookkeeping.

The loop syncs with the device where the JAX loop does: once a step to read
``step_skipped`` for the guard's patience, and at the DISPLAY and summary
reads. Every device launch stays on the calling thread; the prefetch thread
only decodes (``data/loader.py``).

Observability, as in the JAX loop: losses and LR to stdout in the
reference's format, to ``metrics.jsonl`` (``utils/metrics.py``), and to
TensorBoard event files in train and val sibling dirs
(``utils/tb_writer.py``): scalar losses, the parameters' histograms under
their flax paths (``utils/weights.py::flax_from_state_dict``, so runs of both
packages share tags), and the GT-boxes image. ``TPU.PROFILE_DIR`` writes a
``torch.profiler`` trace of five steps.

Not ported: the JAX loop's device mesh and multi-process branches, which
raise (ROADMAP.md, Queue A: parallelism).
"""

from __future__ import annotations

import os
import shutil
import signal
import time

import numpy as np
import torch

from tf_faster_rcnn_torch.config import cfg
from tf_faster_rcnn_torch.data.loader import (PrefetchingDataLayer,
                                              RoIDataLayer)
from tf_faster_rcnn_torch.data.roidb import filter_roidb, prepare_roidb
from tf_faster_rcnn_torch.engine.losses import detection_losses
from tf_faster_rcnn_torch.engine.train import (create_train_state,
                                               make_train_step, scale_recipe)
from tf_faster_rcnn_torch.models.init import reference_init
from tf_faster_rcnn_torch.models.network import (DTYPES, FasterRCNN,
                                                 spec_from_cfg)
from tf_faster_rcnn_torch.utils import checkpoint as ckpt
from tf_faster_rcnn_torch.utils.metrics import MetricsWriter
from tf_faster_rcnn_torch.utils.tb_writer import TBEventWriter
from tf_faster_rcnn_torch.utils.timer import Timer
from tf_faster_rcnn_torch.utils.weights import (flatten_tree,
                                                flax_from_state_dict)

__all__ = ["SolverWrapper", "get_training_roidb", "train_net"]

PROFILE_STEPS = 5


class SolverWrapper(object):
    def __init__(self, network_name, imdb, roidb, valroidb, output_dir,
                 tb_dir, pretrained_model=None, valimdb=None, device="cuda"):
        self.net_name = network_name
        self.imdb = imdb
        self.roidb = roidb
        self.valroidb = valroidb
        self.valimdb = valimdb
        self.output_dir = output_dir
        self.tb_dir = tb_dir
        self.pretrained_model = pretrained_model
        self.device = torch.device(device)
        self._best_map = -1.0
        self._skip_streak = 0
        self._eval_model = None
        self._last_eval_dir = None

    def construct(self):
        np.random.seed(cfg.RNG_SEED)
        ckpt.check_backend()
        self.spec = spec_from_cfg(self.net_name, self.imdb.num_classes,
                                  "TRAIN")
        self.model = FasterRCNN(self.spec, device=self.device)
        self.batch_size = b = int(cfg.TPU.IMS_PER_DEVICE)
        # the JAX package's initializers give every tensor a value; a
        # checkpoint then overwrites what it holds (an ImageNet one lacks
        # the detection heads, which keep this draw)
        reference_init(self.model,
                       torch.Generator().manual_seed(cfg.RNG_SEED))
        if self.pretrained_model:
            from tf_faster_rcnn_torch.utils.slim_import import \
                load_pretrained_into
            load_pretrained_into(self.model, self.pretrained_model,
                                 self.net_name)
            print(f"Loaded pretrained weights from {self.pretrained_model}")
        else:
            self._warn_random_init()
        self.state = create_train_state(
            self.spec, self.model,
            torch.Generator(device=self.device).manual_seed(
                cfg.RNG_SEED + 1),
            batch_size=b)
        self.recipe = scale_recipe(b)
        if self.recipe["scale"] > 1:
            print(f"Batched recipe: global batch {b} -> LR "
                  f"{self.recipe['learning_rate']:g}, stepsize "
                  f"{self.recipe['stepsizes']}, warmup "
                  f"{self.recipe['warmup_steps']} steps (reference units /"
                  f" {self.recipe['scale']})")
        self.step_fn = make_train_step(
            self.model, self.spec,
            weight_decay=float(cfg.TRAIN.WEIGHT_DECAY),
            bias_decay=bool(cfg.TRAIN.BIAS_DECAY),
            mobile_weight_decay=float(cfg.MOBILENET.WEIGHT_DECAY),
            regu_depth=bool(cfg.MOBILENET.REGU_DEPTH),
            lr_fn=self.state.tx.lr_fn,
            nan_guard=bool(cfg.TPU.NAN_GUARD))

    def _warn_random_init(self):
        """The JAX loop's warnings for a run without pretrained weights: a
        frozen prefix never leaves its random state."""
        for match, knob, n in (
                ("res", "RESNET.FIXED_BLOCKS", self.spec.fixed_blocks),
                ("mobile", "MOBILENET.FIXED_LAYERS", self.spec.fixed_layers)):
            if self.net_name.startswith(match) and n > 0:
                unit = "blocks" if "BLOCKS" in knob else "layers"
                print(f"WARNING: training from RANDOM init with the first "
                      f"{n} backbone {unit} frozen ({knob}={n}); the frozen "
                      f"prefix never leaves its random state. Pass --set "
                      f"{knob} 0 unless this is deliberate.")
        for match, frozen in (("vgg16", "conv1/conv2"),
                              ("res", "conv1 stem")):
            if self.net_name.startswith(match):
                print(f"WARNING: {self.net_name}'s {frozen} is ALWAYS frozen "
                      f"(matching the reference) and will stay at its "
                      f"random init for this from-scratch run: a permanent "
                      f"lossy projection of the input. Use a pretrained "
                      f"model for production quality.")

    @torch.no_grad()
    def _val_losses(self, batch, it):
        """The TRAIN-mode losses on a val batch, with sampling noise from a
        generator seeded with it (never the train state's generator, so a
        resumed run draws what an unbroken one draws)."""
        gen = torch.Generator(device=self.device).manual_seed(int(it))
        out = self.model(batch["image"], batch["im_info"],
                         batch["gt_boxes"], batch["gt_valid"], generator=gen)
        return detection_losses(out)

    def _eval_map(self, it, writer):
        """In-training validation mAP (TPU.EVAL_ITERS): the TEST-mode eval
        engine on valimdb with the live parameters. The TEST model and its
        detect function are built once per run."""
        from tf_faster_rcnn_torch.engine.test_engine import (make_detect_fn,
                                                             test_net)
        if self._eval_model is None:
            self._eval_spec = spec_from_cfg(
                self.net_name, self.valimdb.num_classes, "TEST")
            self._eval_model = FasterRCNN(self._eval_spec,
                                          device=self.device).eval()
            self._eval_model.to(DTYPES[str(cfg.TPU.PARAM_DTYPE)])
            self._eval_detect_fn = make_detect_fn(
                self._eval_model, self._eval_spec,
                int(cfg.TPU.MAX_PER_IMAGE))
        self._eval_model.load_state_dict(self.model.state_dict(), strict=True)
        out_dir = os.path.join(self.output_dir, f"val_eval_iter_{it}")
        mean_ap = test_net(self._eval_model, self._eval_spec, self.valimdb,
                           f"iter_{it}",
                           max_per_image=int(cfg.TPU.MAX_PER_IMAGE),
                           output_dir=out_dir,
                           detect_fn=self._eval_detect_fn)
        # keep only the newest eval's artifacts
        if self._last_eval_dir and os.path.isdir(self._last_eval_dir):
            shutil.rmtree(self._last_eval_dir, ignore_errors=True)
        self._last_eval_dir = out_dir
        mean_ap = float(np.asarray(mean_ap).ravel()[0])
        print(f"iter {it}: validation mAP = {mean_ap:.4f}")
        writer.write(it, {"val_mAP": mean_ap})
        self.tb_writer_val.add_scalar("VAL/mAP", mean_ap, it)
        if mean_ap > self._best_map:
            self._best_map = mean_ap
            best = os.path.join(self.output_dir,
                                f"{cfg.TRAIN.SNAPSHOT_PREFIX}_best.pt")
            ckpt.save_params(best, self.model)
            print(f"iter {it}: new best mAP {mean_ap:.4f} -> {best}")
        return mean_ap

    def _write_gt_image(self, batch, it):
        """The GT-boxes image summary (the reference's GROUND_TRUTH image,
        network.py:47-55) as a PNG in the metrics dir and an event."""
        try:
            from PIL import Image

            from tf_faster_rcnn_torch.utils.visualization import \
                draw_bounding_boxes
            img = batch["image"][0].float().cpu().numpy() + cfg.PIXEL_MEANS
            img = img[:, :, ::-1]  # BGR -> RGB
            gt = batch["gt_boxes"][0].cpu().numpy()
            gv = batch["gt_valid"][0].cpu().numpy()
            info = batch["im_info"][0].cpu().numpy()
            out = draw_bounding_boxes(img, gt[gv], (info[0], info[1], 1.0))
            out = np.uint8(np.clip(out, 0, 255))
            Image.fromarray(out).save(
                os.path.join(self.tb_dir, f"gt_image_iter_{it}.png"))
            self.tb_writer.add_image("GROUND_TRUTH", out, it)
        except Exception as e:   # a summary must not stop training
            print(f"gt image summary skipped: {e!r}")

    def _write_param_histograms(self, it):
        """Histograms of every parameter and FrozenBN array under its flax
        path (network.py:442-447), as the JAX loop tags them."""
        tree = flax_from_state_dict(self.model.state_dict())
        for path, leaf in flatten_tree(tree):
            self.tb_writer.add_histogram("TRAIN/" + "/".join(path), leaf, it)

    def snapshot(self):
        prefix = cfg.TRAIN.SNAPSHOT_PREFIX
        ckpt.snapshot(self.output_dir, prefix, self.state,
                      {"train": self.data_layer.get_state(),
                       "val": self.data_layer_val.get_state()},
                      extra_meta={"best_map": self._best_map})
        ckpt.remove_old_snapshots(self.output_dir, prefix,
                                  int(cfg.TRAIN.SNAPSHOT_KEPT))

    def _restore(self):
        prev = ckpt.find_previous(self.output_dir, cfg.TRAIN.SNAPSHOT_PREFIX)
        if prev is None:
            return
        step, sp, mp = prev
        ckpt.restore(self.state, sp)
        meta = ckpt.restore_meta(mp)
        self.data_layer.set_state(meta["data_state"]["train"])
        self.data_layer_val.set_state(meta["data_state"]["val"])
        np.random.set_state(meta["np_rng_state"])
        # a worse eval after the resume must not replace the best params
        self._best_map = float(meta.get("best_map", -1.0))
        print(f"Restored from iter {step}")

    def _check_guard(self, metrics, it):
        """The NaN guard's patience: count consecutive skipped steps (one
        host sync a step); at TPU.NAN_GUARD_PATIENCE, snapshot and raise."""
        if "step_skipped" not in metrics or \
                float(metrics["step_skipped"]) == 0.0:
            self._skip_streak = 0
            return
        self._skip_streak += 1
        print(f"WARNING: iter {it}: non-finite loss/grads — update skipped "
              f"({self._skip_streak} consecutive)")
        patience = int(cfg.TPU.NAN_GUARD_PATIENCE)
        if patience and self._skip_streak >= patience:
            self.snapshot()
            raise RuntimeError(
                f"training diverged: {self._skip_streak} consecutive "
                f"non-finite steps (snapshot saved at iter {it})")

    def _summary(self, metrics, batch, it, writer):
        m = {k: float(v) for k, v in metrics.items()}
        val_batch = self.data_layer_val.forward()
        val_batch.pop("orig_hw")
        vm = {k: float(v) for k, v in self._val_losses(val_batch, it).items()}
        writer.write(it, m, prefix="train")
        self.tb_writer.add_scalars(m, it)
        writer.write(it, vm, prefix="val")
        self.tb_writer_val.add_scalars(vm, it)
        self._write_gt_image(batch, it)
        self._write_param_histograms(it)
        self.tb_writer.flush()
        self.tb_writer_val.flush()

    def train_model(self, max_iters):
        """``max_iters`` is in reference units (images, the experiment
        scripts' ITERS); a batch of B runs ceil(max_iters / B) steps over
        the same image budget (scale_recipe)."""
        self.construct()
        max_iters = self.recipe["iters"](max_iters)
        snapshot_iters = self.recipe["iters"](cfg.TRAIN.SNAPSHOT_ITERS)
        eval_iters = 0
        if int(cfg.TPU.EVAL_ITERS) > 0 and self.valimdb is not None:
            eval_iters = self.recipe["iters"](cfg.TPU.EVAL_ITERS)
        self.data_layer = RoIDataLayer(self.roidb, batch_size=self.batch_size,
                                       device=self.device)
        self.data_layer_val = RoIDataLayer(self.valroidb, random=True,
                                           batch_size=self.batch_size,
                                           device=self.device)
        if int(cfg.TPU.PREFETCH) > 0:
            self.data_layer = PrefetchingDataLayer(
                self.data_layer, depth=int(cfg.TPU.PREFETCH))
        writer = MetricsWriter(self.tb_dir)
        # TensorBoard event files in train/val sibling dirs, as in the
        # reference (train_val.py:149-151)
        self.tb_writer = TBEventWriter(self.tb_dir)
        self.tb_writer_val = TBEventWriter(self.tb_dir + "_val")
        # preemption: finish the step in flight, snapshot, stop, so the
        # same command resumes from here
        preempted = []

        def _on_sigterm(signum, frame):
            preempted.append(signum)
            print("SIGTERM received: will snapshot and stop after the "
                  "current step")
        try:
            prev_handler = signal.signal(signal.SIGTERM, _on_sigterm)
        except ValueError:           # not the main thread
            prev_handler = None
        try:
            self._restore()
            it = self._loop(max_iters, snapshot_iters, eval_iters, writer,
                            preempted)
            if preempted:
                self.snapshot()
                print(f"preempted at iter {it}: snapshot written, resume "
                      f"with the same command")
            elif max_iters % snapshot_iters != 0:
                self.snapshot()
        finally:
            if prev_handler is not None:
                signal.signal(signal.SIGTERM, prev_handler)
            writer.close()
            self.tb_writer.close()
            self.tb_writer_val.close()
            if isinstance(self.data_layer, PrefetchingDataLayer):
                self.data_layer.close()
        return self.state

    def _loop(self, max_iters, snapshot_iters, eval_iters, writer,
              preempted):
        timer = Timer()
        last_summary_time = time.time()
        it = int(self.state.step)
        profile_dir = str(cfg.TPU.PROFILE_DIR)
        profile_start = it + min(10, max(max_iters - it - 1, 0))
        profiler = None
        while it < max_iters and not preempted:
            if profile_dir and profiler is None and it >= profile_start:
                profiler = _start_profiler(self.device)
            elif profiler is not None and it >= profile_start + PROFILE_STEPS:
                _stop_profiler(profiler, profile_dir, it)
                profiler, profile_dir = None, ""
            timer.tic()
            batch = self.data_layer.forward()
            batch.pop("orig_hw")
            _, metrics = self.step_fn(self.state, batch)
            it += 1
            self._check_guard(metrics, it)
            timer.toc()

            now = time.time()
            if it == 1 or now - last_summary_time > cfg.TRAIN.SUMMARY_INTERVAL:
                self._summary(metrics, batch, it, writer)
                last_summary_time = now

            if it % cfg.TRAIN.DISPLAY == 0:
                m = {k: float(v) for k, v in metrics.items()}
                print('iter: %d / %d, total loss: %.6f\n '
                      '>>> rpn_loss_cls: %.6f\n '
                      '>>> rpn_loss_box: %.6f\n '
                      '>>> loss_cls: %.6f\n '
                      '>>> loss_box: %.6f\n >>> lr: %f' %
                      (it, max_iters, m["total_loss"],
                       m["rpn_cross_entropy"], m["rpn_loss_box"],
                       m["cross_entropy"], m["loss_box"],
                       m.get("learning_rate", 0.0)))
                print('speed: {:.3f}s / iter'.format(timer.average_time))

            if it % snapshot_iters == 0:
                self.snapshot()
            if eval_iters and it % eval_iters == 0:
                self._eval_map(it, writer)
        if profiler is not None:     # the loop ended inside the window
            _stop_profiler(profiler, profile_dir, it)
        return it


def _start_profiler(device):
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    profiler = torch.profiler.profile(activities=acts)
    profiler.start()
    return profiler


def _stop_profiler(profiler, profile_dir, it):
    profiler.stop()
    os.makedirs(profile_dir, exist_ok=True)
    path = os.path.join(profile_dir, f"trace_iter_{it}.json")
    profiler.export_chrome_trace(path)
    print(f"Wrote profiler trace to {path}")


def get_training_roidb(imdb):
    """Flip-augment and enrich (reference train_val.py:324-335)."""
    if cfg.TRAIN.USE_FLIPPED:
        print('Appending horizontally-flipped training examples...')
        imdb.append_flipped_images()
        print('done')
    print('Preparing training data...')
    prepare_roidb(imdb)
    print('done')
    return imdb.roidb


def train_net(network_name, imdb, roidb, valroidb, output_dir, tb_dir,
              pretrained_model=None, max_iters=40000, mesh=None,
              valimdb=None, device="cuda"):
    """Train a Faster R-CNN network on one device (reference
    train_val.py:363-378); returns the final TrainState. ``valimdb``
    enables the in-training validation mAP (TPU.EVAL_ITERS)."""
    if mesh is not None or (torch.distributed.is_available()
                            and torch.distributed.is_initialized()
                            and torch.distributed.get_world_size() > 1):
        raise NotImplementedError(
            "training over a device mesh or several processes is not "
            "ported yet (ROADMAP.md, Queue A: parallelism)")
    roidb = filter_roidb(roidb)
    valroidb = filter_roidb(valroidb)
    sw = SolverWrapper(network_name, imdb, roidb, valroidb, output_dir,
                       tb_dir, pretrained_model=pretrained_model,
                       valimdb=valimdb, device=device)
    print('Solving...')
    state = sw.train_model(max_iters)
    print('done solving')
    return state
