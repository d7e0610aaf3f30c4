"""Image-database (imdb) base class.

A copy of ``tf_faster_rcnn_tpu/datasets/imdb.py`` that reads image widths
from the file header (``data/blob.py::image_size``) instead of opening each
image with PIL, and computes IoU through the port's own ``utils/native.py``.

API parity with the reference imdb abstraction (reference
lib/datasets/imdb.py:20-260): a named dataset exposing a class list, an
image index, a lazily built roidb, horizontal-flip augmentation, proposal
recall evaluation with COCO-style area buckets, external-proposal roidb
construction/merging, and the competition_mode hook. The implementation is
this framework's own: typed annotations (datasets/annotations.py) build the
records, the dense IoU goes through the native C++ op, and the greedy
recall matching runs on the full overlap matrix.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import scipy.sparse

from tf_faster_rcnn_torch.config import cfg
from tf_faster_rcnn_torch.data.blob import image_size
from tf_faster_rcnn_torch.datasets.annotations import flipped_entry
from tf_faster_rcnn_torch.utils.native import bbox_overlaps_cpu

# COCO-style proposal-recall area buckets: name -> (lo, hi) in px^2,
# inclusive on both ends (reference imdb.py:136-145).
AREA_BUCKETS = {
    'all': (0.0, 1e10),
    'small': (0.0, 32.0 ** 2),
    'medium': (32.0 ** 2, 96.0 ** 2),
    'large': (96.0 ** 2, 1e10),
    '96-128': (96.0 ** 2, 128.0 ** 2),
    '128-256': (128.0 ** 2, 256.0 ** 2),
    '256-512': (256.0 ** 2, 512.0 ** 2),
    '512-inf': (512.0 ** 2, 1e10),
}


def _greedy_match_scores(iou: np.ndarray) -> np.ndarray:
    """Greedy one-to-one proposal<->gt matching.

    Repeatedly claims the globally best (proposal, gt) pair and retires both,
    returning the matched IoU per gt (0 for gts left unmatched). Ties break
    like the reference's column-max-then-argmax scan (imdb.py:180-196):
    lowest gt index first, then lowest proposal index.
    """
    iou = iou.astype(np.float64, copy=True)
    num_props, num_gt = iou.shape
    matched = np.zeros(num_gt)
    for _ in range(min(num_gt, num_props)):
        # argmax over the gt-major flattening == first gt column holding the
        # global max, then the first proposal row within that column
        flat = int(np.argmax(iou.T))
        gt_idx, prop_idx = divmod(flat, num_props)
        matched[gt_idx] = iou[prop_idx, gt_idx]
        iou[prop_idx, :] = -1.0
        iou[:, gt_idx] = -1.0
    return matched


class imdb:
    """Named dataset: class list + image index + lazily built roidb."""

    def __init__(self, name, classes=None):
        self._name = name
        self._classes = list(classes) if classes else []
        self._image_index = []
        self._roidb = None
        self._roidb_handler = self.default_roidb
        self._obj_proposer = 'gt'
        self.config = {}

    # -- identity --------------------------------------------------------

    @property
    def name(self):
        return self._name

    @property
    def classes(self):
        return self._classes

    @property
    def num_classes(self):
        return len(self._classes)

    @property
    def image_index(self):
        return self._image_index

    @property
    def num_images(self):
        return len(self._image_index)

    # -- roidb plumbing --------------------------------------------------

    @property
    def roidb_handler(self):
        return self._roidb_handler

    @roidb_handler.setter
    def roidb_handler(self, fn):
        self._roidb_handler = fn

    def set_proposal_method(self, method):
        self.roidb_handler = getattr(self, f'{method}_roidb')

    @property
    def roidb(self):
        if self._roidb is None:
            self._roidb = self.roidb_handler()
        return self._roidb

    @property
    def cache_path(self):
        path = Path(cfg.DATA_DIR).resolve() / 'cache'
        path.mkdir(parents=True, exist_ok=True)
        return str(path)

    # -- subclass surface ------------------------------------------------

    def image_path_at(self, i):
        raise NotImplementedError

    def default_roidb(self):
        raise NotImplementedError

    def evaluate_detections(self, all_boxes, output_dir=None):
        """all_boxes[class][image] is [] or a float array [#dets, 5] of
        (x1, y1, x2, y2, score)."""
        raise NotImplementedError

    def competition_mode(self, on):
        pass

    # -- augmentation ----------------------------------------------------

    def _get_widths(self):
        return [image_size(self.image_path_at(i))[1]
                for i in range(self.num_images)]

    def append_flipped_images(self):
        """Double the roidb with horizontally mirrored views; the image
        index doubles in lockstep (loader reads `flipped` to mirror pixels
        at batch time)."""
        widths = self._get_widths()
        base = list(self.roidb)
        for entry, width in zip(base, widths):
            self.roidb.append(flipped_entry(entry, width))
        self._image_index = self._image_index * 2

    # -- proposal recall -------------------------------------------------

    def evaluate_recall(self, candidate_boxes=None, thresholds=None,
                        area='all', limit=None):
        """Average recall of proposals against gt over IoU thresholds
        0.5:0.05:0.95, restricted to one area bucket (reference
        imdb.py:126-214). With candidate_boxes=None, the roidb's own
        non-gt (class 0) boxes act as the proposals."""
        if area not in AREA_BUCKETS:
            raise KeyError(f'unknown area bucket {area!r}; '
                           f'have {sorted(AREA_BUCKETS)}')
        lo, hi = AREA_BUCKETS[area]

        matched_all = []
        total_gt = 0
        for i, entry in enumerate(self.roidb):
            # gt = positive-class, non-crowd (crowd rows have overlap -1,
            # so their row max is < 1)
            affinity = entry['gt_overlaps'].toarray()
            is_gt = (entry['gt_classes'] > 0) & (affinity.max(axis=1) == 1)
            in_bucket = ((entry['seg_areas'] >= lo)
                         & (entry['seg_areas'] <= hi))
            gt_boxes = entry['boxes'][is_gt & in_bucket]
            total_gt += len(gt_boxes)

            if candidate_boxes is None:
                props = entry['boxes'][entry['gt_classes'] == 0]
            else:
                props = candidate_boxes[i]
            if limit is not None:
                props = props[:limit]
            if len(props) == 0:
                continue

            iou = bbox_overlaps_cpu(np.ascontiguousarray(props, np.float32),
                                    np.ascontiguousarray(gt_boxes,
                                                         np.float32))
            matched_all.append(_greedy_match_scores(iou))

        matched = (np.concatenate(matched_all) if matched_all
                   else np.zeros(0))
        matched.sort()
        if thresholds is None:
            thresholds = np.arange(0.5, 0.95 + 1e-5, 0.05)
        thresholds = np.asarray(thresholds)
        recalls = np.array([(matched >= t).sum() / float(total_gt)
                            for t in thresholds])
        return {'ar': recalls.mean(), 'recalls': recalls,
                'thresholds': thresholds, 'gt_overlaps': matched}

    # -- external proposals ----------------------------------------------

    def _proposal_entry(self, boxes, gt_entry):
        """Roidb record for external proposal boxes: class-affinity is the
        best IoU against the gt of the matching class, labels are all
        background (reference imdb.py:216-245)."""
        n = len(boxes)
        affinity = np.zeros((n, self.num_classes), dtype=np.float32)
        if gt_entry is not None and gt_entry['boxes'].size:
            iou = bbox_overlaps_cpu(
                np.ascontiguousarray(boxes, np.float32),
                np.ascontiguousarray(gt_entry['boxes'], np.float32))
            best = iou.max(axis=1)
            best_gt = iou.argmax(axis=1)
            hit = best > 0
            affinity[hit, gt_entry['gt_classes'][best_gt[hit]]] = best[hit]
        return {
            'boxes': boxes,
            'gt_classes': np.zeros((n,), dtype=np.int32),
            'gt_overlaps': scipy.sparse.csr_matrix(affinity),
            'seg_areas': np.zeros((n,), dtype=np.float32),
            'flipped': False,
        }

    def create_roidb_from_box_list(self, box_list, gt_roidb):
        if len(box_list) != self.num_images:
            raise ValueError('need one box array per image: '
                             f'{len(box_list)} != {self.num_images}')
        gts = gt_roidb if gt_roidb is not None else [None] * len(box_list)
        return [self._proposal_entry(boxes, gt)
                for boxes, gt in zip(box_list, gts)]

    @staticmethod
    def merge_roidbs(a, b):
        """Concatenate per-image records of two parallel roidbs (gt +
        proposals)."""
        if len(a) != len(b):
            raise ValueError('roidb length mismatch')
        joiners = {
            'boxes': np.vstack,
            'gt_classes': np.hstack,
            'seg_areas': np.hstack,
            'gt_overlaps': scipy.sparse.vstack,
        }
        for ea, eb in zip(a, b):
            for key, join in joiners.items():
                ea[key] = join((ea[key], eb[key]))
        return a
