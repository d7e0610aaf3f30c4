"""The train entry: ``make_train_step``'s step, built as
``engine/train_loop.py::train_net`` builds it (its weight decays, its
learning-rate schedule over the global batch, the NaN guard), on batches of
the pool prepared on the card with flips, and the GT rows at the image's
scale, padded to TPU.MAX_GT. The sampling noise of each step is drawn by
the benchmark from the seed and passed to the step.

Set-up drives the step through its first three steps on distinct images,
through the window's own call and feed, and keeps what the comparison
needs: the losses, the momentum after step 1 (the gradient as the
optimizer got it), the parameters' change over the three, and the
proposals each step drew its RoIs from. The reference follows the three
steps from the same weights, images, GT and noise once the window is over.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from frcnn_bench import compare, harness, profiling, roofline
from frcnn_bench.detect_loop import scaled_extent
from frcnn_bench.flops import image_flops
from frcnn_bench.peaks import peak
from frcnn_bench.reference.model import (Reference, prep_images, sgd_step,
                                         trainable)
from frcnn_bench.reference.nms import greedy_keep
from frcnn_bench.traffic.scenes import make_pool
from frcnn_bench.weights import make_weights

RECORDED = 3          # the steps the reference follows
# the numbers compared in a train cell (compare.py)
NUMBERS = ("proposal_replay", "loss_err", "grad_err", "update_err")
LOSSES = ("rpn_cross_entropy", "rpn_loss_box", "cross_entropy", "loss_box",
          "regularization_loss", "total_loss")


def _gt_rows(pool, idx, flips, target, max_size, max_gt):
    """GT rows [B, max_gt, 5] at each image's scale (flipped where the
    image is) and their validity [B, max_gt]."""
    gt = np.zeros((len(idx), max_gt, 5), np.float32)
    valid = np.zeros((len(idx), max_gt), bool)
    for b, k in enumerate(idx):
        h, w = pool.images[k].shape[:2]
        rows = pool.gt[k][:max_gt].copy()
        if flips[b]:
            x1 = rows[:, 0].copy()
            rows[:, 0] = w - rows[:, 2] - 1
            rows[:, 2] = w - x1 - 1
        rows[:, :4] *= scaled_extent(h, w, target, max_size)[2]
        gt[b, :len(rows)] = rows
        valid[b, :len(rows)] = True
    return gt, valid


def run(cell, seed, seconds, trace, device):
    """One run of a train cell; returns the entry's dict for run.py."""
    from tf_faster_rcnn_torch.config import bucket_index, canvas_buckets
    from tf_faster_rcnn_torch.data.blob import prep_batch, upload
    from tf_faster_rcnn_torch.engine import train as port_train
    from tf_faster_rcnn_torch.models.network import TrainNoise

    config, traffic = cell.config, cell.traffic
    c = config["cfg"]
    cfg = harness.port_cfg(config)
    batch = int(traffic["batch"])
    weights = make_weights(config, seed, device, "TRAIN")
    model, spec = harness.build_program(config, "TRAIN", weights, device)
    del weights
    state = port_train.create_train_state(
        spec, model, torch.Generator(device=device).manual_seed(int(seed)),
        batch_size=batch)
    step_fn = port_train.make_train_step(
        model, spec, weight_decay=float(cfg.TRAIN.WEIGHT_DECAY),
        bias_decay=bool(cfg.TRAIN.BIAS_DECAY),
        mobile_weight_decay=float(cfg.MOBILENET.WEIGHT_DECAY),
        regu_depth=bool(cfg.MOBILENET.REGU_DEPTH),
        lr_fn=state.tx.lr_fn, nan_guard=bool(cfg.TPU.NAN_GUARD))
    pool = make_pool(traffic, config["num_classes"], seed, device)
    buckets = canvas_buckets(cfg.TRAIN)
    means = upload(np.asarray(c["PIXEL_MEANS"], np.float32), device)
    target, max_size = c["TRAIN"]["SCALES"][0], c["TRAIN"]["MAX_SIZE"]
    max_gt = int(c["TPU"]["MAX_GT"])
    vgg = config["net"]["family"] == "vgg16"
    n_rois = int(c["TRAIN"]["RPN_POST_NMS_TOP_N"])
    noise_gen = torch.Generator(device=device).manual_seed(int(seed) + 1)
    flops_of = [image_flops(config, *scaled_extent(*im.shape[:2], target,
                                                   max_size)[:2], "TRAIN")
                for im in pool.images]

    def images_of(i):
        return [(i * batch + j) % len(pool) for j in range(batch)]

    def canvas_of(idx):
        kinds = {bucket_index(*pool.images[k].shape[:2], buckets)
                 for k in idx}
        if len(kinds) != 1:
            raise ValueError("a batch mixes orientations")
        return buckets[kinds.pop()]

    def feed(i):
        idx = images_of(i)
        ims = [pool.images[k] for k in idx]
        flips = [pool.flipped[k] for k in idx]
        gt, gv = _gt_rows(pool, idx, flips, target, max_size, max_gt)
        return idx, ims, flips, gt, gv

    def draw(canvas):
        n_anchors = (canvas[0] // 16) * (canvas[1] // 16) * len(
            c["ANCHOR_SCALES"]) * len(c["ANCHOR_RATIOS"])
        noise = [torch.rand((batch, n), generator=noise_gen, device=device)
                 for n in (n_anchors, n_anchors, n_rois, n_rois)]
        keep = None
        if vgg:
            width = config["net"]["fc"]
            keep = tuple(torch.rand((batch * c["TRAIN"]["BATCH_SIZE"],
                                     width), generator=noise_gen,
                                    device=device) < 0.5 for _ in range(2))
        return TrainNoise(*noise, dropout=keep)

    def step(i, spans=False, keep=None):
        idx, ims, flips, gt, gv = feed(i)
        canvas = canvas_of(idx)
        with profiling.span("bench.prep", spans):
            image, info, _ = prep_batch(ims, canvas, device,
                                        [target] * batch, max_size, means,
                                        flipped=flips)
            data = {"image": image, "im_info": info,
                    "gt_boxes": upload(gt, device),
                    "gt_valid": upload(gv, device)}
            noise = draw(canvas)
        with profiling.span("bench.call", spans):
            c0 = time.perf_counter()
            _, metrics = step_fn(state, data, noise)
            c1 = time.perf_counter()
        if keep is not None:
            keep.append({"feed": (idx, flips, gt, gv, canvas),
                         "noise": noise})
        return metrics, c1 - c0

    # set-up: the three recorded steps, the proposals tapped on the model
    params = state.params()
    start = {n: p.detach().clone() for n, p in params.items()}
    tapped = []
    inner = model._proposals

    def proposals(anchors, rpn_bbox, fg_scores, im_info, fw, *rest):
        out = inner(anchors, rpn_bbox, fg_scores, im_info, fw, *rest)
        tapped.append({"rois": out[0].detach().clone(),
                       "scores": out[1].detach().clone(),
                       "valid": out[2].clone(), "deltas": rpn_bbox.clone(),
                       "fg": fg_scores.clone(), "im_info": im_info.clone(),
                       "fw": int(fw)})
        return out
    model._proposals = proposals
    recorded, losses = [], []
    for i in range(RECORDED):
        metrics, _ = step(i, keep=recorded)
        losses.append({k: float(metrics[k]) for k in LOSSES})
        if i == 0:
            grad_norms = {n: float(state.trace[n].norm()) for n in params}
    update_norms = {n: float((p.detach() - start[n]).norm())
                    for n, p in params.items()}
    del model._proposals, start
    if device.type == "cuda":
        torch.cuda.synchronize(device)

    skipped, enq = [], []
    t_window = time.perf_counter()
    i = RECORDED
    while True:
        metrics, call = step(i)
        skipped.append(metrics["step_skipped"])
        enq.append(call)
        i += 1
        if time.perf_counter() - t_window >= seconds:
            break
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    window_s = time.perf_counter() - t_window
    steps = i - RECORDED
    n_skipped = int(torch.stack(skipped).sum())
    flops = sum(flops_of[k] for j in range(RECORDED, i)
                for k in images_of(j))
    tr = None
    if trace and device.type == "cuda":
        first = i
        tr = profiling.trace(lambda j: step(first + j, spans=True),
                             int(cell.spec["trace_steps"]))
    memory = (torch.cuda.max_memory_allocated(device)
              if device.type == "cuda" else 0)
    del state, step_fn, model, params, inner
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    kind = harness.card(device)["kind"] if device.type == "cuda" else ""
    numbers, bounds = follow(config, seed, device, pool, recorded, tapped,
                             losses, grad_norms, update_norms, batch,
                             kind if trace else "")
    record = {
        "steps": steps, "batch": batch, "window_s": window_s,
        "images_per_s": steps * batch / window_s,
        "host_enqueue_ms": 1e3 * float(np.mean(enq)),
        "flops_per_s": flops / window_s, "trace": tr,
        "k1_bound_s": bounds, "k2_bound_s": [], "nms_per_step": 1,
        "kind": kind, "peak_bf16_flop_s": peak(kind, "bf16_flop_s"),
    }
    return {"attempted": steps * batch, "failed": n_skipped * batch,
            "t_window": t_window, "memory_peak_bytes": int(memory),
            "numbers": numbers, "record": record,
            "compared_steps": len(recorded)}


def follow(config, seed, device, pool, recorded, tapped, prog_losses,
           prog_grad_norms, prog_update_norms, batch, kind):
    """The reference through the recorded steps: (numbers, K1 bound
    seconds of each step, when kind names a card with peaks)."""
    c = config["cfg"]
    t = c["TRAIN"]
    params = make_weights(config, seed, device, "TRAIN")
    names = [n for n in params if trainable(config, n)]
    for n in names:
        params[n].requires_grad_(True)
    ref = Reference(config, params)
    trace_v, ref_losses, numbers, bounds = {}, [], {}, []
    start = {n: params[n].detach().clone() for n in names}
    for s, rec in enumerate(recorded):
        idx, flips, gt, gv, canvas = rec["feed"]
        ims = [pool.images[k] for k in idx]
        image, info, _ = prep_images(ims, canvas, t["SCALES"][0],
                                     t["MAX_SIZE"], c["PIXEL_MEANS"], device,
                                     flipped=flips)
        noise = rec["noise"]
        tap = tapped[s]
        rois, valid = tap["rois"], tap["valid"]
        if rois.shape[0] != len(ims):
            return {k: float("inf") for k in NUMBERS}, []
        total, losses, (feat, pairs, deltas) = ref.train_loss(
            image, info, torch.from_numpy(gt).to(device),
            torch.from_numpy(gv).to(device),
            {"anchor_fg": noise.anchor_fg, "anchor_bg": noise.anchor_bg,
             "roi_fg": noise.roi_fg, "roi_bg": noise.roi_bg,
             "dropout": noise.dropout}, (rois, valid))
        grads = torch.autograd.grad(total, [params[n] for n in names])
        ref_losses.append({k: float(v.detach()) for k, v in losses.items()})
        with torch.no_grad():
            # K1's stage replayed on the program's own RPN outputs
            fw = tap["fw"]
            fh = tap["deltas"].shape[1] // (fw * ref.a)
            pboxes, pinside = ref.decode_anchors(fh, fw, tap["deltas"],
                                                 tap["im_info"])
            r_rois, r_scores, r_ok = ref.proposals(pboxes, tap["fg"],
                                                   pinside, "TRAIN")
            numbers["proposal_replay"] = max(
                numbers.get("proposal_replay", 0.0), compare.replay_diff(
                    torch.cat([rois, tap["scores"][..., None]], -1), valid,
                    torch.cat([r_rois, r_scores[..., None]], -1), r_ok))
            if kind and peak(kind, "f32_flop_s"):
                boxes, fg, inside = ref.anchor_boxes(feat, pairs, deltas,
                                                     info)
                _, sb, sv = ref.candidates(boxes, fg, inside,
                                           t["RPN_PRE_NMS_TOP_N"])
                keep = greedy_keep(sb, sv, t["RPN_NMS_THRESH"], False)
                bounds.append(roofline.bound_s(
                    keep, sb, sv, t["RPN_NMS_THRESH"],
                    peak(kind, "f32_flop_s"), peak(kind, "hbm_bytes_s"),
                    max_keep=t["RPN_POST_NMS_TOP_N"])[0])
        del feat, pairs, deltas, total
        g = dict(zip(names, grads))
        if s == 0:
            ref_grad_norms = {n: float(v.norm()) for n, v in g.items()}
        sgd_step(config, params, g, trace_v, s, batch)
        if s == 0:
            ref_v1 = {n: float(v.norm()) for n, v in trace_v.items()}
    ref_update = {n: float((params[n].detach() - start[n]).norm())
                  for n in names}
    numbers["loss_err"] = compare.loss_err(prog_losses, ref_losses)
    numbers["grad_err"] = compare.leaf_err(prog_grad_norms, ref_v1,
                                           ref_grad_norms)
    numbers["update_err"] = compare.leaf_err(prog_update_norms, ref_update,
                                             ref_grad_norms)
    return numbers, bounds
