"""Training data layer: epoch permutations, cursors, fixed-shape minibatches.

Port of ``tf_faster_rcnn_tpu/data/loader.py``. The sampling is the JAX
layer's, draw for draw, from the same ``np.random.RandomState(RNG_SEED)``
stream, so both layers choose the same images and scales: the epoch
permutation with optional aspect-ratio grouping (same-orientation pairs,
odd tail held out), the cursor and the tiny-roidb wrap, the canvas of each
batch (its orientation bucket, or the union canvas for a mixed batch), one
scale draw per batch, the crowd-box exclusion under USE_ALL_GT False and the
TPU.MAX_GT truncation. The iteration state round-trips through
``get_state`` / ``set_state`` in the JAX layer's format, so a JAX run's
cursors continue here. In a multi-process run every process holds that same
state and decodes only its slice of each global batch (``process_index``,
``process_count``); the prefetcher wraps the sliced layer.

The work splits in two, as on the eval path: ``next_host_batch`` draws the
indices and scales and decodes the images into uint8 arrays on the host (no
device work, so a worker thread may run it); ``to_device`` uploads them and
does the pixel work on the device (``data/blob.py::prep_batch``: a flipped
entry is flipped there with ``torch.flip``, then mean subtraction, the
cv2-exact resize and the canvas write). ``forward`` is the two in turn.
``PrefetchingDataLayer`` runs ``next_host_batch`` in a thread and keeps every
device launch on the caller's thread.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from tf_faster_rcnn_torch.config import (bucket_index, canvas_buckets, cfg,
                                         mixed_canvas)
from tf_faster_rcnn_torch.data.blob import (im_scale, prep_batch,
                                            read_image_bgr, upload)
from tf_faster_rcnn_torch.parallel import dist
from tf_faster_rcnn_torch.parallel.dist import local_slice

__all__ = ["HostBatch", "PrefetchingDataLayer", "RoIDataLayer",
           "decode_minibatch"]

_TRUNC_WARNED = False


class HostBatch(NamedTuple):
    """A minibatch as the host prepares it: the decoded uint8 BGR images
    (not yet flipped), each entry's flip flag and target size, the canvas,
    and the gt rows already in the scaled image's coordinates, padded to
    max_gt with a validity mask."""
    images: List[np.ndarray]
    flipped: List[bool]
    target_sizes: List[int]
    canvas: Tuple[int, int]
    gt_boxes: np.ndarray
    gt_valid: np.ndarray


def _gt_rows(entry, scale, max_gt, gt_boxes, gt_valid):
    if cfg.TRAIN.USE_ALL_GT:
        gt_inds = np.where(entry['gt_classes'] != 0)[0]
    else:
        # exclude crowd boxes (gt_overlaps row max == -1, coco.py:158)
        gt_inds = np.where(
            (entry['gt_classes'] != 0)
            & np.all(entry['gt_overlaps'].toarray() > -1.0, axis=1))[0]
    n = min(len(gt_inds), max_gt)
    if len(gt_inds) > max_gt:
        # dropped objects would otherwise train as background: make the
        # truncation loud so TPU.MAX_GT gets raised for dense datasets
        global _TRUNC_WARNED
        if not _TRUNC_WARNED:
            print(f"WARNING: image {entry.get('image', '?')} has "
                  f"{len(gt_inds)} gt boxes > TPU.MAX_GT={max_gt}; "
                  f"truncating (raise cfg.TPU.MAX_GT). Further "
                  f"truncations will not be logged.")
            _TRUNC_WARNED = True
    sel = gt_inds[:n]
    gt_boxes[:n, :4] = entry['boxes'][sel, :].astype(np.float32) * scale
    gt_boxes[:n, 4] = entry['gt_classes'][sel]
    gt_valid[:n] = True


def decode_minibatch(roidb_entries, canvas_hw: Tuple[int, int], max_gt: int,
                     target_sizes) -> HostBatch:
    """The host half of a minibatch: decode each entry's image and build its
    gt rows at the scale its shape and target size give."""
    b = len(roidb_entries)
    images = [read_image_bgr(entry['image']) for entry in roidb_entries]
    gt_boxes = np.zeros((b, max_gt, 5), np.float32)
    gt_valid = np.zeros((b, max_gt), bool)
    for i, (entry, im) in enumerate(zip(roidb_entries, images)):
        scale = im_scale(im.shape[0], im.shape[1], target_sizes[i],
                         cfg.TRAIN.MAX_SIZE)
        _gt_rows(entry, scale, max_gt, gt_boxes[i], gt_valid[i])
    return HostBatch(images, [bool(e.get('flipped', False))
                              for e in roidb_entries],
                     [int(s) for s in target_sizes], tuple(canvas_hw),
                     gt_boxes, gt_valid)


class RoIDataLayer(object):
    """Fast R-CNN style data layer with checkpointable iteration state."""

    def __init__(self, roidb, random=False, batch_size: Optional[int] = None,
                 device="cuda", process_index: int = 0,
                 process_count: int = 1):
        """``batch_size`` images per batch (TRAIN.IMS_PER_BATCH when None),
        the global batch. Each batch runs on its orientation bucket's canvas
        (a batch that mixes orientations on the union canvas). ``random``: a
        time-seeded shuffle, as the reference's validation layer.

        process_count > 1 (the JAX layer's process slicing): every process
        holds the same iteration state and makes every draw at the global
        batch's size (the permutation, the canvas from the global index
        list, the scales), and decodes only its contiguous slice of each
        batch, the process_index-th of process_count; the global batch must
        divide. A random layer is then seeded from RNG_SEED and its shuffle
        count instead of the clock, so that every process shuffles alike;
        so it is in any run of several processes, whose model ranks
        (parallel/mesh.py) share a data index and must draw alike. The
        model ranks of a data group pass its data index and data size."""
        self._batch = batch_size or int(cfg.TRAIN.IMS_PER_BATCH)
        self._part = local_slice(self._batch, process_index, process_count)
        self._pcount = int(process_count)
        self._roidb = roidb
        self._random = random
        self._buckets = canvas_buckets(cfg.TRAIN)
        self._mixed = mixed_canvas(self._buckets)
        self._max_gt = int(cfg.TPU.MAX_GT)
        self._device = torch.device(device)
        self._pixel_means = None
        self._rng = np.random.RandomState(cfg.RNG_SEED)
        self._n_shuffles = 0
        self._shuffle_roidb_inds()

    def _shuffle_roidb_inds(self):
        """Permute the roidb, optionally grouping by aspect ratio
        (layer.py:32-62)."""
        if self._random:
            # time-seeded shuffle for the validation layer (layer.py:37-41);
            # processes of one run must shuffle alike, so not by the clock
            # (the model ranks of a data group too)
            if self._pcount > 1 or dist.process_count() > 1:
                seed = (cfg.RNG_SEED + 0x5EED + self._n_shuffles) % (2 ** 31)
            else:
                seed = int(time.time() * 1000) % 4096
            self._rng = np.random.RandomState(seed)
        self._n_shuffles += 1
        if cfg.TRAIN.ASPECT_GROUPING:
            # permute each orientation group, concatenate, shuffle at pair
            # granularity: odd group sizes straddle exactly one mixed pair,
            # and an odd total holds the last index out
            landscape = np.array(
                [r['width'] >= r['height'] for r in self._roidb])
            order = np.concatenate(
                [self._rng.permutation(np.flatnonzero(landscape)),
                 self._rng.permutation(np.flatnonzero(~landscape))])
            tail = order[len(order) & ~1:]
            pairs = order[:len(order) & ~1].reshape(-1, 2)
            self._perm = np.concatenate(
                [pairs[self._rng.permutation(len(pairs))].ravel(), tail])
        else:
            self._perm = self._rng.permutation(np.arange(len(self._roidb)))
        self._cur = 0

    def _get_next_minibatch_inds(self):
        if self._cur + self._batch > len(self._roidb):
            self._shuffle_roidb_inds()
        if self._batch > len(self._roidb):
            # tiny roidb: wrap so the batch shape stays fixed
            reps = -(-self._batch // len(self._roidb))
            db_inds = np.tile(self._perm, reps)[:self._batch]
            self._cur = len(self._roidb)  # force a reshuffle next time
            return db_inds
        db_inds = self._perm[self._cur:self._cur + self._batch]
        self._cur += self._batch
        return db_inds

    def _batch_canvas(self, db_inds):
        if len(self._buckets) == 1:
            return self._buckets[0]
        entries = [self._roidb[int(i)] for i in db_inds]
        if not all('width' in e and 'height' in e for e in entries):
            return self._mixed  # no size metadata (prepare_roidb not run)
        ks = {bucket_index(e['height'], e['width'], self._buckets)
              for e in entries}
        return self._buckets[ks.pop()] if len(ks) == 1 else self._mixed

    def next_host_batch(self) -> HostBatch:
        """Advance the iteration state by one batch and decode this
        process's slice of it, on the host only."""
        db_inds = self._get_next_minibatch_inds()
        canvas = self._batch_canvas(db_inds)
        # one batch-sized draw, as the JAX layer makes it
        scales = cfg.TRAIN.SCALES
        scale_inds = self._rng.randint(0, len(scales), size=len(db_inds))
        db_inds, scale_inds = db_inds[self._part], scale_inds[self._part]
        entries = [self._roidb[int(i)] for i in db_inds]
        return decode_minibatch(entries, canvas, self._max_gt,
                                [scales[int(i)] for i in scale_inds])

    def to_device(self, host: HostBatch) -> Dict:
        """The device half, on the thread that launches the model: image
        [B, H, W, 3] float32, im_info [B, 3], gt_boxes [B, G, 5], gt_valid
        [B, G] and orig_hw [B, 2], all on the layer's device."""
        if self._pixel_means is None:
            self._pixel_means = upload(
                np.asarray(cfg.PIXEL_MEANS, np.float32).reshape(3),
                self._device)
        image, im_info, orig_hw = prep_batch(
            host.images, host.canvas, self._device, host.target_sizes,
            cfg.TRAIN.MAX_SIZE, self._pixel_means, host.flipped)
        return {"image": image, "im_info": im_info,
                "gt_boxes": upload(host.gt_boxes, self._device),
                "gt_valid": upload(host.gt_valid, self._device),
                "orig_hw": orig_hw}

    def forward(self) -> Dict:
        return self.to_device(self.next_host_batch())

    # --- checkpointable iteration state, the JAX layer's format (the
    # reference pickles its cursors and permutations, train_val.py:57-78)

    def get_state(self) -> Dict:
        return {"cur": self._cur, "perm": np.asarray(self._perm),
                "rng_state": self._rng.get_state(),
                "n_shuffles": self._n_shuffles}

    def set_state(self, state: Dict):
        self._cur = int(state["cur"])
        self._perm = np.asarray(state["perm"])
        self._rng.set_state(state["rng_state"])
        self._n_shuffles = int(state.get("n_shuffles", 0))


class PrefetchingDataLayer(object):
    """A background thread that decodes the next batches of a RoIDataLayer
    while the device runs: up to ``depth`` HostBatches wait in a bounded
    queue, and ``forward`` does the device half on the caller's thread.

    get_state() is the JAX wrapper's: the inner layer's state from before
    the batch most recently handed out (before any, the state it started
    from or was set to), so a resume replays that batch and loses nothing
    prefetched past it. set_state() drains the queue,
    and a batch that the worker built from the old state while set_state
    ran is dropped by its stale generation tag. An exception in the worker
    is raised by the next forward()."""

    def __init__(self, inner: RoIDataLayer, depth: int = 2):
        self._inner = inner
        self._last_state = inner.get_state()
        self._queue = queue.Queue(maxsize=depth)
        self._lock = threading.Lock()
        self._gen = 0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True,
                                        name="roidata-prefetch")
        self._thread.start()

    def _worker(self):
        while not self._stop.is_set():
            try:
                with self._lock:
                    gen = self._gen
                    state = self._inner.get_state()
                    host = self._inner.next_host_batch()
                item = (gen, state, host, None)
            except Exception as e:   # handed to forward(), which raises it
                item = (None, None, None, e)
            # put outside the lock: a blocking put while holding it would
            # deadlock against set_state's drain
            while not self._stop.is_set():
                try:
                    self._queue.put(item, timeout=0.5)
                    break
                except queue.Full:
                    continue
            if item[3] is not None:
                return

    def forward(self) -> Dict:
        while True:
            gen, state, host, error = self._queue.get()
            if error is not None:
                raise RuntimeError("the prefetch thread failed") from error
            if gen == self._gen:
                self._last_state = state
                return self._inner.to_device(host)

    def get_state(self) -> Dict:
        return self._last_state

    def set_state(self, state: Dict):
        with self._lock:
            self._gen += 1
            self._drain()
            self._inner.set_state(state)
            self._last_state = state

    def _drain(self):
        while True:
            try:
                self._queue.get_nowait()
            except queue.Empty:
                return

    def close(self):
        self._stop.set()
        self._drain()
        self._thread.join(timeout=10)
