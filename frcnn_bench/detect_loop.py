"""The closed detect loop of the ``detect`` and ``request`` entries, and its
comparison with the reference.

A step takes the next images of the pool (uint8 BGR on the host), builds
their canvas on the card with the program's ``data/blob.py::prep_batch``
at TEST.SCALES[0] capped by TEST.MAX_SIZE, runs ``make_detect_fn``'s
function, and fetches the detections to the host in one copy, as
``test_net`` does. A step's images count when their detections are on the
host. On the sampled steps the tap keeps the model's outputs; after the
window the reference recomputes them from the same images and weights.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from frcnn_bench import compare, harness, profiling, roofline
from frcnn_bench.flops import image_flops
from frcnn_bench.peaks import peak
from frcnn_bench.reference.model import NEG, Reference, prep_images
from frcnn_bench.reference.nms import greedy_keep
from frcnn_bench.traffic.scenes import make_pool
from frcnn_bench.weights import make_weights

__all__ = ["run", "judge", "control_outputs", "scaled_extent", "NUMBERS"]

# the numbers compared in a detect cell (compare.py)
NUMBERS = ("rpn_score_err", "rpn_delta_err", "proposal_replay",
           "head_score_err", "head_delta_err", "det_score_err",
           "det_replay")


def scaled_extent(h, w, target, max_size):
    """The reference's resize of an h x w image: (scaled h, scaled w,
    scale)."""
    scale = float(target) / min(h, w)
    if round(scale * max(h, w)) > max_size:
        scale = float(max_size) / max(h, w)
    return int(round(h * scale)), int(round(w * scale)), scale


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _sample(cell, seed, buckets_of):
    """The window's steps whose outputs are compared: drawn from the seed
    among the first ``sample_within`` steps, spread over the orientations
    the traffic holds."""
    rng = np.random.default_rng([int(seed), 2])
    within = int(cell.spec["sample_within"])
    n = int(cell.spec["sample_steps"])
    by_bucket = {}
    for i in range(within):
        by_bucket.setdefault(buckets_of(i), []).append(i)
    groups = list(by_bucket.values())
    picks = []
    for g, steps in enumerate(groups):
        k = n // len(groups) + (1 if g < n % len(groups) else 0)
        picks += list(rng.choice(steps, size=min(k, len(steps)),
                                 replace=False))
    return sorted(int(i) for i in picks)


def run(cell, seed, seconds, trace, device):
    """One run of a detect cell: set-up, the window, the traced span (with
    trace), and the comparison. Returns the entry's dict for run.py."""
    from tf_faster_rcnn_torch.config import bucket_index, canvas_buckets
    from tf_faster_rcnn_torch.data.blob import prep_batch, upload
    from tf_faster_rcnn_torch.engine import test_engine

    config, traffic = cell.config, cell.traffic
    cfg = harness.port_cfg(config)
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
                                                   max_size)[:2], "TEST")
                for im in pool.images]

    def images_of(i):
        return [(i * batch + j) % len(pool) for j in range(batch)]

    def canvas_of(i):
        hw = [pool.images[k].shape[:2] for k in images_of(i)]
        kinds = {bucket_index(h, w, buckets) for h, w in hw}
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
    if trace:
        first = steps
        n_trace = int(cell.spec["trace_steps"])

        def traced(j):
            step(first + j, spans=True)
        tr = profiling.trace(traced, n_trace) if device.type == "cuda" \
            else None
    memory = (torch.cuda.max_memory_allocated(device)
              if device.type == "cuda" else 0)
    kept = tap.kept
    tap.close()
    del model, detect, tap
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    ref = Reference(config, make_weights(config, seed, device))
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
        "trace": tr, "k1_bound_s": k1_bounds, "k2_bound_s": k2_bounds,
        "nms_per_step": 2, "kind": kind,
        "peak_bf16_flop_s": peak(kind, "bf16_flop_s"),
    }
    return {"attempted": images, "failed": failed, "t_window": t_window,
            "memory_peak_bytes": int(memory), "numbers": numbers,
            "record": record, "compared_steps": len(kept)}


def judge(ref, ims, canvas, prog, kind, want_bounds=False):
    """The compared numbers of one step (compare.py), from the program's
    outputs prog (the tap's keys plus det, det_valid) on the uint8 images
    ims placed on canvas; with want_bounds also the K1 and K2 bound
    seconds of the step, counted on the reference's own inputs."""
    c = ref.c
    test = c["TEST"]
    dev = prog["rois"].device
    if any(t.shape[0] != len(ims) for t in prog.values()):
        return {k: float("inf") for k in NUMBERS}, None
    with torch.no_grad():
        image, info, orig = _prep(ref, ims, canvas, dev)
        feat = ref.head(image, info)
        pairs, deltas = ref.rpn(feat)
        out = {"rpn_score_err": compare.rel_max(prog["rpn_cls_score"],
                                                pairs),
               "rpn_delta_err": compare.rel_max(prog["rpn_bbox_pred"],
                                                deltas)}
        # K1's stage replayed on the program's own RPN outputs
        fh, fw = feat.shape[-2:]
        pboxes, pinside = ref.decode_anchors(fh, fw, prog["rpn_bbox_pred"],
                                             info)
        pfg = torch.softmax(prog["rpn_cls_score"], dim=-1)[..., 1]
        rois, scores, ok = ref.proposals(pboxes, pfg, pinside, "TEST")
        out["proposal_replay"] = compare.replay_diff(
            torch.cat([prog["rois"], prog["roi_scores"][..., None]], -1),
            prog["roi_valid"], torch.cat([rois, scores[..., None]], -1), ok)
        cls, box = ref.roi_heads(feat, prog["rois"], info, test=True)
        out.update(compare.head_numbers(prog["cls_score"], prog["bbox_pred"],
                                        cls, box, prog["roi_valid"]))
        pb, ps = ref.class_boxes(prog["rois"], torch.softmax(cls, dim=-1),
                                 box, info, orig)
        out["det_score_err"] = compare.det_score_err(
            prog["det"], prog["det_valid"], pb, ps)
        # K2's stage (and the top cut) replayed on the program's own head
        rdet, rdv = ref.postprocess(
            prog["rois"], prog["roi_valid"],
            torch.softmax(prog["cls_score"], dim=-1), prog["bbox_pred"],
            info, orig)
        out["det_replay"] = compare.replay_diff(prog["det"],
                                                prog["det_valid"], rdet, rdv)
        bounds = None
        if want_bounds and peak(kind, "f32_flop_s"):
            f32, hbm = peak(kind, "f32_flop_s"), peak(kind, "hbm_bytes_s")
            boxes, fg, inside = ref.anchor_boxes(feat, pairs, deltas, info)
            _, sb, sv = ref.candidates(boxes, fg, inside,
                                       test["RPN_PRE_NMS_TOP_N"])
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


def _prep(ref, ims, canvas, device):
    test = ref.c["TEST"]
    return prep_images(ims, canvas, test["SCALES"][0], test["MAX_SIZE"],
                       ref.c["PIXEL_MEANS"], device)


def control_outputs(ref_low, ims, canvas, device):
    """The reference at a lower precision in the program's place: its
    outputs under the tap's keys."""
    with torch.no_grad():
        image, info, orig = _prep(ref_low, ims, canvas, device)
        return ref_low.detect(image, info, orig)

