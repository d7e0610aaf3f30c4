"""Evaluation engine: batched detection over an imdb, detections.pkl, the
dataset's evaluation, and the host re-NMS of reval.

Port of ``tf_faster_rcnn_tpu/engine/test_engine.py`` (``make_detect_fn``,
``im_detect``, ``test_net`` on one device, ``apply_nms``). The flow is the
reference's (lib/model/test.py): prepare each image at TEST.SCALES[0] capped
by TEST.MAX_SIZE, detect, per-class NMS at TEST.NMS, cap at max_per_image,
write detections.pkl, run imdb.evaluate_detections. As in the JAX package,
images run in fixed-shape batches grouped by orientation bucket, the last
batch filled by repeating its last image, and the postprocess runs on the
device.

The work splits three ways. Worker threads only decode image files into
uint8 arrays, in a bounded window of batches consumed in schedule order.
The main thread uploads each image and builds the batch's canvases on the
model's device (``data/blob.py``: mean subtraction, resize, canvas write),
launches the detect step, and copies the detections back: one host sync
per batch. The host then files them into ``all_boxes``.

In a multi-process run (``parallel/dist.py``) each rank takes the stripe
``schedule[rank::ranks]`` of the batch schedule on its own device, with no
device collective. The ranks other than 0 write their detections to part
files named by rank 0's run token; rank 0 merges them, writes
``detections.pkl`` and evaluates, and the others return None after the
closing barrier. The output dir is shared, as for the snapshots.

With a mesh that has a 'model' axis (``parallel/mesh.py``), the batches are
striped over the data groups instead of the processes: every rank of a
model group runs the same batch, its RoI head tensor parallel and, under
TPU.SPATIAL_PARTITION, the backbone head on its rows of the canvas
(``split_canvas``); only model rank 0 of each group writes a part file.
"""

from __future__ import annotations

import os
import pickle
import time
import uuid
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np
import torch

from tf_faster_rcnn_torch.config import (bucket_index, canvas_buckets, cfg,
                                         get_output_dir)
from tf_faster_rcnn_torch.data.blob import (image_size, prep_batch,
                                            read_image_bgr, upload)
from tf_faster_rcnn_torch.engine.detect import postprocess_detections
from tf_faster_rcnn_torch.parallel import dist
from tf_faster_rcnn_torch.parallel.mesh import (data_axis_size, data_index,
                                                model_index, split_canvas)
from tf_faster_rcnn_torch.utils.native import nms_cpu
from tf_faster_rcnn_torch.utils.timer import Timer
from tf_faster_rcnn_torch.utils.trace import span

__all__ = ["make_detect_fn", "detect_step", "im_detect", "test_net",
           "apply_nms"]


def make_detect_fn(model, spec, max_per_image: Optional[int] = None,
                   score_thresh: float = 0.0):
    """(image, im_info, orig_hw) -> (detections, valid), under
    torch.inference_mode. The postprocess settings come from spec
    (spec_from_cfg snapshots TEST.NMS, TEST.BBOX_REG and TPU.MAX_PER_IMAGE);
    max_per_image, when given, replaces the spec's.

    image [B, H, W, 3], im_info [B, 3] and orig_hw [B, 2] are tensors on the
    model's device. detections: [B, max_per_image, 6] as (cls, score, x1,
    y1, x2, y2) in original image coordinates; valid: [B, max_per_image].
    canvas_h: where image holds this model rank's rows of a canvas of
    canvas_h rows (FasterRCNN.forward).
    """
    mpi = int(max_per_image or spec.max_per_image)

    @torch.inference_mode()
    def detect(image, im_info, orig_hw, canvas_h=None):
        return detect_step(model, spec, mpi, score_thresh, image, im_info,
                           orig_hw, canvas_h=canvas_h)

    return detect


def detect_step(model, spec, max_per_image: int, score_thresh: float,
                image, im_info, orig_hw, top_pad=None, canvas_h=None):
    """One detect step, the body of make_detect_fn's function and of the
    exported program (utils/serving.py): model(image, im_info, top_pad=...)
    and the postprocess at spec's settings. model is the FasterRCNN or a
    callable with its forward's signature; canvas_h, where given, goes to
    the forward (image then holds rows of the canvas)."""
    with span("detect.step", step=True):
        if canvas_h is None:
            out = model(image, im_info, top_pad=top_pad)
        else:
            out = model(image, im_info, top_pad=top_pad, canvas_h=canvas_h)
        with span("detect.postprocess"):
            return postprocess_detections(
                out["rois"], out["roi_valid"], out["cls_prob"],
                out["bbox_pred"], im_info, orig_hw,
                num_classes=spec.num_classes, max_per_image=max_per_image,
                nms_thresh=spec.nms_thresh, score_thresh=score_thresh,
                bbox_reg=spec.bbox_reg)


def _pixel_means(device) -> torch.Tensor:
    return upload(np.asarray(cfg.PIXEL_MEANS, np.float32).reshape(3), device)


def _prep_batch(ims, canvas, device, pixel_means=None):
    """The canvases of a batch of decoded uint8 BGR images at the TEST
    scale, built on device (``data/blob.py::prep_batch``)."""
    if pixel_means is None:
        pixel_means = _pixel_means(device)
    return prep_batch(ims, canvas, device, [cfg.TEST.SCALES[0]] * len(ims),
                      cfg.TEST.MAX_SIZE, pixel_means)


def _fetch(det, dv):
    """Both outputs of a detect step on the host, in one copy."""
    out = torch.cat([det, dv[..., None].to(det.dtype)], dim=-1).cpu().numpy()
    return out[..., :6], out[..., 6] > 0


def im_detect(detect_fn, im, device, canvas=None):
    """Single-image detection (demo-style) of a uint8 BGR array on device.
    Returns the valid rows of the detection slab, [N, 6] as (cls, score,
    x1, y1, x2, y2)."""
    if canvas is None:
        buckets = canvas_buckets(cfg.TEST)
        canvas = buckets[bucket_index(im.shape[0], im.shape[1], buckets)]
    det, dv = _fetch(*detect_fn(*_prep_batch([im], canvas, device)))
    return det[0][dv[0]]


def _slab_to_all_boxes(det, dv, num_classes):
    """Fixed detection slab -> the reference all_boxes row (per-class [N,5]
    arrays of (x1,y1,x2,y2,score))."""
    per_class = [[] for _ in range(num_classes)]
    for row, ok in zip(det, dv):
        if not ok:
            continue
        c = int(row[0])
        per_class[c].append([row[2], row[3], row[4], row[5], row[1]])
    return [np.array(v, np.float32).reshape(-1, 5) for v in per_class]


def test_net(model, spec, imdb, weights_filename, max_per_image: int = 100,
             thresh: float = 0.0, batch_size: Optional[int] = None,
             output_dir: Optional[str] = None, detect_fn=None,
             timers: Optional[dict] = None, mesh=None):
    """Evaluate a model on an imdb on the model's device; writes
    detections.pkl, runs the dataset's evaluator and returns its result
    (mAP for VOC, AP for COCO). In a multi-process run every rank calls it
    and detects its stripe of the batches (module docstring); rank 0
    returns the result, the others None.

    batch_size defaults to TPU.IMS_PER_DEVICE, the images of a batch on
    each rank. detect_fn defaults to
    make_detect_fn(model, spec, max_per_image, thresh). timers, when given,
    is filled with the 'im_detect' and 'misc' Timers (per batch). mesh:
    the run's mesh, whose data groups the batches are striped over (module
    docstring); None stripes them over the processes.
    """
    np.random.seed(cfg.RNG_SEED)
    device = next(model.parameters()).device
    num_images = imdb.num_images
    num_classes = imdb.num_classes
    all_boxes = [[[] for _ in range(num_images)]
                 for _ in range(num_classes)]
    output_dir = output_dir or get_output_dir(imdb, weights_filename)
    os.makedirs(output_dir, exist_ok=True)
    buckets = canvas_buckets(cfg.TEST)
    b = batch_size or max(1, int(cfg.TPU.IMS_PER_DEVICE))
    detect_fn = detect_fn or make_detect_fn(model, spec, max_per_image,
                                            thresh)
    _t = {'im_detect': Timer(), 'misc': Timer()}
    if timers is not None:
        timers.update(_t)

    # one canvas per orientation bucket, every batch on the tight canvas of
    # its orientation; the header is enough, since a uniform resize keeps
    # the orientation
    if len(buckets) > 1:
        groups = [[] for _ in buckets]
        for i in range(num_images):
            ih, iw = image_size(imdb.image_path_at(i))
            groups[bucket_index(ih, iw, buckets)].append(i)
    else:
        groups = [list(range(num_images))]
    schedule = [(k, grp[s:s + b])
                for k, grp in enumerate(groups)
                for s in range(0, len(grp), b)]
    if mesh is None:
        pid, pcount, writer = dist.process_index(), dist.process_count(), True
    else:
        pid, pcount = data_index(mesh), data_axis_size(mesh)
        writer = model_index(mesh) == 0
    spatial = bool(cfg.TPU.SPATIAL_PARTITION)
    schedule = schedule[pid::pcount]
    run_token = None
    if dist.process_count() > 1:
        # rank 0's token names this run's part files, so a rerun into the
        # same dir can never merge an earlier run's leftovers
        run_token = dist.broadcast_object(
            uuid.uuid4().hex[:16] if pid == 0 else None)

    # workers decode a bounded window of batches ahead, consumed strictly in
    # schedule order, so one slow decode cannot stall the device behind an
    # idle pipeline; all device work stays on this thread
    n_workers = max(1, int(cfg.TPU.EVAL_PREFETCH_THREADS))
    window = n_workers + 2
    pixel_means = _pixel_means(device)

    def _decode(item):
        k, idx = item
        # fixed batch shape: repeat the last image to fill the tail
        paths = [imdb.image_path_at(i) for i in idx]
        paths += paths[-1:] * (b - len(idx))
        return k, idx, [read_image_bgr(p) for p in paths]

    pool = ThreadPoolExecutor(max_workers=n_workers,
                              thread_name_prefix="decode")
    try:
        pending = [pool.submit(_decode, item) for item in schedule[:window]]
        next_submit = window
        done = 0
        for _ in schedule:
            _t['im_detect'].tic()
            k, idx, ims = pending.pop(0).result()
            if next_submit < len(schedule):
                pending.append(pool.submit(_decode, schedule[next_submit]))
                next_submit += 1
            images, im_info, orig_hw = _prep_batch(ims, buckets[k], device,
                                                   pixel_means)
            rows = split_canvas(mesh, {"image": images}, spatial)
            kw = {"canvas_h": rows["canvas_h"]} if "canvas_h" in rows else {}
            det, dv = _fetch(*detect_fn(rows["image"], im_info, orig_hw,
                                        **kw))
            _t['im_detect'].toc()

            _t['misc'].tic()
            for j, i in enumerate(idx):
                boxes = _slab_to_all_boxes(det[j], dv[j], num_classes)
                for c in range(1, num_classes):
                    all_boxes[c][i] = boxes[c]
            _t['misc'].toc()
            # reference cadence: one line per image (test.py:158-160); the
            # times are per batch
            for _ in idx:
                done += 1
                print('im_detect: {:d}/{:d} {:.3f}s {:.3f}s'.format(
                    done, num_images,
                    _t['im_detect'].average_time, _t['misc'].average_time))
    finally:
        # cancel queued decodes on every exit path
        pool.shutdown(wait=False, cancel_futures=True)

    det_file = os.path.join(output_dir, 'detections.pkl')
    if dist.process_count() > 1:
        all_boxes = _merge_parts(det_file, all_boxes, pid, pcount,
                                 num_classes, num_images, run_token, writer)
        if all_boxes is None:
            # wait out rank 0's merge and evaluation on the host group, so
            # a caller that goes back to device collectives (the
            # in-training eval) cannot run ahead of it
            dist.barrier(f"testnet_{run_token}", timeout_ms=1_800_000)
            return None
    with open(det_file, 'wb') as f:
        pickle.dump(all_boxes, f, pickle.HIGHEST_PROTOCOL)
    print('Evaluating detections')
    mean = imdb.evaluate_detections(all_boxes, output_dir)
    if dist.process_count() > 1:
        dist.barrier(f"testnet_{run_token}", timeout_ms=1_800_000)
    return mean


def _merge_parts(det_file, all_boxes, pid, pcount, num_classes, num_images,
                 token, writer=True, timeout_s=900.0):
    """Stripes other than 0 write their all_boxes to a token-named part
    file, atomically, and return None (one writer a stripe: a rank that is
    not returns None at once); stripe 0's writer waits for every part,
    merges and removes them, and returns the merged all_boxes. A detected
    entry is a numpy array (maybe empty), an undetected one the initial
    []."""
    def part(p):
        return f'{det_file}.{token}.part{p}'

    if not writer:
        return None
    if pid != 0:
        path = part(pid)
        with open(path + '.tmp', 'wb') as f:
            pickle.dump(all_boxes, f, pickle.HIGHEST_PROTOCOL)
        os.replace(path + '.tmp', path)
        print(f'wrote {path}')
        return None
    parts = [part(p) for p in range(1, pcount)]
    deadline = time.time() + timeout_s
    while not all(os.path.exists(p) for p in parts):
        if time.time() > deadline:
            missing = [p for p in parts if not os.path.exists(p)]
            raise RuntimeError(f'eval parts never arrived: {missing}')
        time.sleep(0.2)
    for p in parts:
        with open(p, 'rb') as f:
            other = pickle.load(f)
        for c in range(num_classes):
            for i in range(num_images):
                if isinstance(other[c][i], np.ndarray):
                    all_boxes[c][i] = other[c][i]
        os.unlink(p)
    return all_boxes


def apply_nms(all_boxes, thresh):
    """Host-side per-class NMS over pickled detections (the reval path,
    reference test.py:109-136), through the native C++ op with the
    reference's gpu_nms semantics (+1 IoU, suppress at >)."""
    num_classes = len(all_boxes)
    num_images = len(all_boxes[0])
    nms_boxes = [[[] for _ in range(num_images)]
                 for _ in range(num_classes)]
    for cls_ind in range(num_classes):
        for im_ind in range(num_images):
            dets = all_boxes[cls_ind][im_ind]
            if len(dets) == 0:
                continue
            dets = np.asarray(dets, np.float32)
            x1, y1 = dets[:, 0], dets[:, 1]
            x2, y2 = dets[:, 2], dets[:, 3]
            inds = np.where((x2 > x1) & (y2 > y1))[0]
            dets = dets[inds, :]
            if dets.size == 0:
                continue
            keep = nms_cpu(dets, thresh, plus_one=True, suppress_eq=False)
            if len(keep) == 0:
                continue
            nms_boxes[cls_ind][im_ind] = dets[keep, :].copy()
    return nms_boxes
