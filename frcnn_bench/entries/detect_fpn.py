"""The detect entry of a feature-pyramid configuration (R-101-FPN): the
closed loop of ``detect_loop.py`` over the pyramid's reference, FLOP count
and weights (``reference/fpn.py``).

A step takes the next images of the pool, builds their canvas on the card
with the program's ``prep_batch``, runs ``make_detect_fn``'s function and
fetches the detections in one copy. On the sampled steps the tap keeps the
model's outputs; after the window the reference recomputes them from the
same images and weights, and the numbers of ``detect_loop.NUMBERS`` are
compared: ``rpn_*`` over the five levels end to end, ``proposal_replay``
(each level's NMS and the union's top cut replayed on the program's own RPN
outputs), ``head_*`` on the program's RoIs through the reference's level
assignment and crop, ``det_score_err`` and ``det_replay``. With --trace 1
the traced span is ``stages.trace``'s, so the record carries the program's
stage spans (``stage_host``) beside the profiler's reduction. A program
that cannot build the configuration's backbone refuses before any work.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from frcnn_bench import compare, harness, profiling, roofline, stages
from frcnn_bench.detect_loop import NUMBERS, _sample, scaled_extent
from frcnn_bench.peaks import peak
from frcnn_bench.reference.fpn import FPNReference, image_flops, make_weights
from frcnn_bench.reference.model import NEG, prep_images
from frcnn_bench.reference.nms import greedy_keep
from frcnn_bench.traffic.scenes import make_pool

__all__ = ["run", "judge", "control_outputs"]


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(cell, seed, seconds, trace, device):
    """One run of the cell: set-up, the window, the traced span (with
    trace), and the comparison. Returns the entry's dict for run.py."""
    from tf_faster_rcnn_torch.config import bucket_index, canvas_buckets
    from tf_faster_rcnn_torch.data.blob import prep_batch, upload
    from tf_faster_rcnn_torch.engine import test_engine
    from tf_faster_rcnn_torch.models.network import spec_from_cfg

    config, traffic = cell.config, cell.traffic
    cfg = harness.port_cfg(config)
    spec_from_cfg(config["backbone"], config["num_classes"], "TEST")
    test = config["cfg"]["TEST"]
    weights = make_weights(config, seed, device)
    model, spec = harness.build_program(config, "TEST", weights, device)
    del weights
    model.eval()
    detect = test_engine.make_detect_fn(model, spec)
    tap = harness.Tap(model)
    pool = make_pool(traffic, config["num_classes"], seed, device)
    buckets = canvas_buckets(cfg.TEST)
    means = upload(np.asarray(config["cfg"]["PIXEL_MEANS"], np.float32),
                   device)
    batch = int(traffic["batch"])
    target, max_size = test["SCALES"][0], test["MAX_SIZE"]
    flops_of = [image_flops(config, *scaled_extent(*im.shape[:2], target,
                                                   max_size)[:2])
                for im in pool.images]

    def images_of(i):
        return [(i * batch + j) % len(pool) for j in range(batch)]

    def canvas_of(i):
        kinds = {bucket_index(*pool.images[k].shape[:2], buckets)
                 for k in images_of(i)}
        if len(kinds) != 1:
            raise ValueError("a batch mixes orientations: a traffic mix of "
                             "batches holds one (portrait_share 0)")
        return buckets[kinds.pop()]

    def step(i, spans=False):
        ims = [pool.images[k] for k in images_of(i)]
        canvas = canvas_of(i)
        t0 = time.perf_counter()
        with profiling.span("bench.prep", spans):
            image, info, orig = prep_batch(ims, canvas, device,
                                           [target] * len(ims), max_size,
                                           means)
        with profiling.span("bench.call", spans):
            c0 = time.perf_counter()
            det, dv = detect(image, info, orig)
            c1 = time.perf_counter()
        with profiling.span("bench.fetch", spans):
            out = torch.cat([det, dv[..., None].to(det.dtype)],
                            dim=-1).cpu().numpy()
        return out, time.perf_counter() - t0, c1 - c0

    # warm-up: two steps on each canvas the traffic uses
    warmed = {}
    for i in range(len(pool)):
        key = canvas_of(i)
        if warmed.get(key, 0) < 2:
            step(i)
            warmed[key] = warmed.get(key, 0) + 1
        if all(v >= 2 for v in warmed.values()) and i >= 2 * len(buckets):
            break
    _sync(device)
    sample = _sample(cell, seed, lambda i: buckets.index(canvas_of(i)))
    outs, lat, enq, flops = {}, [], [], 0
    failed = 0
    t_window = time.perf_counter()
    i = 0
    while True:
        if i in sample:
            tap.armed = i
        out, dt, call = step(i)
        if not np.isfinite(out).all():
            failed += batch
        if i in sample:
            outs[i] = out
        lat.append(dt)
        enq.append(call)
        flops += sum(flops_of[k] for k in images_of(i))
        i += 1
        if time.perf_counter() - t_window >= seconds:
            break
    window_s = time.perf_counter() - t_window
    steps = i
    tr = None
    if trace and device.type == "cuda":
        first, calls = steps, []

        def traced(j):
            calls.append(step(first + j, spans=True)[2])
        tr = stages.trace(traced, int(cell.spec["trace_steps"]),
                          calls=calls) or None
    memory = (torch.cuda.max_memory_allocated(device)
              if device.type == "cuda" else 0)
    kept = tap.kept
    tap.close()
    del model, detect, tap
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    ref = FPNReference(config, make_weights(config, seed, device))
    numbers, k1_bounds, k2_bounds = {}, [], []
    kind = harness.card(device)["kind"] if device.type == "cuda" else ""
    for i in sample:
        if i not in kept:
            continue
        ims = [pool.images[k] for k in images_of(i)]
        prog = dict(kept[i])
        det = torch.from_numpy(outs[i]).to(device)
        prog["det"], prog["det_valid"] = det[..., :6], det[..., 6] > 0
        got, bounds = judge(ref, ims, canvas_of(i), prog, kind,
                            want_bounds=trace)
        for name, v in got.items():
            numbers[name] = max(numbers.get(name, 0.0), v)
        if bounds:
            k1_bounds.append(bounds[0])
            k2_bounds.append(bounds[1])
    images = steps * batch
    lat_ms = sorted(1e3 * x for x in lat)
    record = {
        "steps": steps, "batch": batch, "window_s": window_s,
        "images_per_s": images / window_s,
        "latency_p95_ms": float(np.percentile(lat_ms, 95)),
        "host_enqueue_ms": 1e3 * float(np.mean(enq)),
        "flops_per_s": flops / window_s,
        "trace": tr, "stage_host": (tr or {}).get("stage_host"),
        "k1_bound_s": k1_bounds, "k2_bound_s": k2_bounds,
        "nms_per_step": 2, "kind": kind,
        "peak_bf16_flop_s": peak(kind, "bf16_flop_s"),
    }
    return {"attempted": images, "failed": failed, "t_window": t_window,
            "memory_peak_bytes": int(memory), "numbers": numbers,
            "record": record, "compared_steps": len(kept)}


def _level_instances(ref, cands):
    """The per-level candidates as the program's one NMS call takes them:
    boxes [B * L, pre_n, 4] and valid [B * L, pre_n], padded invalid where
    a level has fewer anchors."""
    pre_n = ref.c["TEST"]["RPN_PRE_NMS_TOP_N"]
    boxes, valid = [], []
    for _, sb, sv in cands:
        pad = pre_n - sb.shape[1]
        boxes.append(torch.nn.functional.pad(sb, (0, 0, 0, pad)))
        valid.append(torch.nn.functional.pad(sv, (0, pad)))
    b = boxes[0].shape[0]
    return (torch.stack(boxes, 1).reshape(b * len(cands), pre_n, 4),
            torch.stack(valid, 1).reshape(b * len(cands), pre_n))


def det_score_err(det, valid, roi, prob):
    """compare.det_score_err's number, each returned detection (det [B, M,
    6], valid [B, M]) held to the reference's score prob [B, R, K] of its
    class and RoI (roi [B, M], from the replay of the program's own
    postprocess, exact where det_replay is 0); infinite for a class out of
    range. compare.py finds the RoI by the nearest box, and across the
    pyramid's levels two RoIs may hold one box with two scores."""
    cls = det[..., 0].long()
    if bool(((cls < 1) | (cls >= prob.shape[-1]))[valid].any()):
        return float("inf")
    ref = torch.gather(prob, 1, roi[..., None].expand(-1, -1, prob.shape[-1]))
    ref = torch.gather(ref, 2, cls.clamp(min=0)[..., None])[..., 0]
    err = (torch.log(det[..., 1].clamp(min=1e-30))
           - torch.log(ref.clamp(min=1e-30))).abs()
    return float(err[valid].max()) if bool(valid.any()) else 0.0


def judge(ref, ims, canvas, prog, kind, want_bounds=False):
    """The compared numbers of one step, from the program's outputs prog
    (the tap's keys plus det, det_valid) on the uint8 images ims placed on
    canvas; with want_bounds also the bound seconds of the step's two NMS
    launches (the per-level proposal NMS, the per-class NMS), counted on
    the reference's own inputs."""
    test = ref.c["TEST"]
    dev = prog["rois"].device
    if any(t.shape[0] != len(ims) for t in prog.values()):
        return {k: float("inf") for k in NUMBERS}, None
    with torch.no_grad():
        image, info, orig = prep_images(ims, canvas, test["SCALES"][0],
                                        test["MAX_SIZE"],
                                        ref.c["PIXEL_MEANS"], dev)
        levels, ext = ref.features(image, info)
        pairs, deltas = ref.rpn(levels, ext)
        out = {"rpn_score_err": compare.rel_max(prog["rpn_cls_score"],
                                                pairs),
               "rpn_delta_err": compare.rel_max(prog["rpn_bbox_pred"],
                                                deltas)}
        # the proposal stage replayed on the program's own RPN outputs
        shapes = [tuple(p.shape[-2:]) for p in levels]
        pboxes, pinside, sizes = ref.decode_levels(
            shapes, prog["rpn_bbox_pred"], info)
        pfg = torch.softmax(prog["rpn_cls_score"], dim=-1)[..., 1]
        rois, scores, ok = ref.proposals(pboxes, pfg, pinside, sizes)
        out["proposal_replay"] = compare.replay_diff(
            torch.cat([prog["rois"], prog["roi_scores"][..., None]], -1),
            prog["roi_valid"], torch.cat([rois, scores[..., None]], -1), ok)
        cls, box = ref.roi_heads(levels, prog["rois"], info)
        out.update(compare.head_numbers(prog["cls_score"], prog["bbox_pred"],
                                        cls, box, prog["roi_valid"]))
        prob = torch.softmax(cls, dim=-1)
        pb, ps = ref.class_boxes(prog["rois"], prob, box, info, orig)
        # the per-class NMS and the top cut replayed on the program's head,
        # which names each detection's RoI
        rdet, rdv, roi = ref.postprocess_rois(
            prog["rois"], prog["roi_valid"],
            torch.softmax(prog["cls_score"], dim=-1), prog["bbox_pred"],
            info, orig)
        out["det_replay"] = compare.replay_diff(prog["det"],
                                                prog["det_valid"], rdet, rdv)
        out["det_score_err"] = det_score_err(prog["det"], prog["det_valid"],
                                             roi, prob)
        bounds = None
        if want_bounds and peak(kind, "f32_flop_s"):
            f32, hbm = peak(kind, "f32_flop_s"), peak(kind, "hbm_bytes_s")
            boxes, inside, sizes = ref.decode_levels(shapes, deltas, info)
            fg = torch.softmax(pairs, dim=-1)[..., 1]
            sb, sv = _level_instances(
                ref, ref.level_candidates(boxes, fg, inside, sizes))
            keep = greedy_keep(sb, sv, test["RPN_NMS_THRESH"], False)
            k1 = roofline.bound_s(keep, sb, sv, test["RPN_NMS_THRESH"], f32,
                                  hbm, max_keep=test["RPN_POST_NMS_TOP_N"])
            b, kc, r = ps.shape
            s = torch.where(prog["roi_valid"][:, None] & (ps > 0), ps,
                            torch.full_like(ps, NEG)).reshape(b * kc, r)
            top, order = torch.sort(s, dim=1, descending=True, stable=True)
            cb = torch.gather(pb.reshape(b * kc, r, 4), 1,
                              order[..., None].expand(-1, -1, 4))
            cv = top > NEG / 2
            keep2 = greedy_keep(cb, cv, test["NMS"], True)
            k2 = roofline.bound_s(keep2, cb, cv, test["NMS"], f32, hbm,
                                  plus_one=True)
            bounds = (k1[0], k2[0])
    return out, bounds


def control_outputs(ref_low, ims, canvas, device):
    """The reference at a lower precision in the program's place: its
    outputs under the tap's keys."""
    test = ref_low.c["TEST"]
    with torch.no_grad():
        image, info, orig = prep_images(ims, canvas, test["SCALES"][0],
                                        test["MAX_SIZE"],
                                        ref_low.c["PIXEL_MEANS"], device)
        return ref_low.detect(image, info, orig)
