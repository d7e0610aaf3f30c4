"""PASCAL VOC detection metric.

A copy of ``tf_faster_rcnn_tpu/datasets/voc_eval.py`` whose annotation cache
is a JSON file of its own (``<split>.txt_annots.json``: per image, the
reference's lists of dicts), not the JAX package's pickle of ``VocObject``
records: unpickling that file would import the JAX package, and a JSON file
can run no code.

Implements the VOCdevkit evaluation protocol (what reference
lib/datasets/voc_eval.py:69-214 computes): detections of one class, sorted
by confidence, are greedily matched against unclaimed ground truth at
IoU > threshold in the legacy +1-width convention; difficult objects never
count as TP or FP; AP is either the VOC07 11-point sample or the
precision-envelope area under the PR curve (VOC2010+).

The implementation is this framework's own: annotations parse into typed
records, per-image matching state lives in a small class, and the AP
formulas are vectorized.
"""

from __future__ import annotations

import json
import os
import xml.etree.ElementTree as ET
from dataclasses import dataclass
from pathlib import Path

import numpy as np


# -- annotation parsing ---------------------------------------------------

@dataclass(frozen=True)
class VocObject:
    name: str
    box: tuple          # (x1, y1, x2, y2), 1-based devkit ints
    difficult: bool
    truncated: bool = False
    pose: str = ''


def _read_voc_xml(path) -> list[VocObject]:
    objects = []
    for node in ET.parse(path).findall('object'):
        def text(tag, default=None, node=node):
            child = node.find(tag)
            return child.text if child is not None else default
        corners = node.find('bndbox')
        box = tuple(int(float(corners.find(tag).text))
                    for tag in ('xmin', 'ymin', 'xmax', 'ymax'))
        objects.append(VocObject(
            name=text('name'),
            box=box,
            difficult=bool(int(text('difficult', '0'))),
            truncated=bool(int(text('truncated', '0'))),
            pose=text('pose', '') or ''))
    return objects


def parse_rec(filename):
    """Reference-shaped view of one annotation file: a list of dicts with
    name/pose/truncated/difficult/bbox keys (reference voc_eval.py:15-32)."""
    return [{'name': o.name, 'pose': o.pose,
             'truncated': int(o.truncated), 'difficult': int(o.difficult),
             'bbox': list(o.box)} for o in _read_voc_xml(filename)]


# -- AP formulas ----------------------------------------------------------

def voc_ap(rec, prec, use_07_metric=False):
    """AP from a PR curve."""
    rec, prec = np.asarray(rec, float), np.asarray(prec, float)
    if use_07_metric:
        # VOC07: mean of max precision at recall >= t for 11 sample points
        samples = [prec[rec >= t].max(initial=0.0)
                   for t in np.linspace(0.0, 1.0, 11)]
        return float(np.mean(samples))
    if rec.size == 0:
        return 0.0
    # VOC2010+: area under the monotone precision envelope
    envelope = np.maximum.accumulate(prec[::-1])[::-1]
    recall_steps = np.diff(rec, prepend=0.0)
    return float(np.sum(recall_steps * envelope))


# -- greedy matching ------------------------------------------------------

def _iou_against(box, others):
    """IoU of one box against an [N, 4] array, +1-width convention."""
    lo = np.maximum(others[:, :2], box[:2])
    hi = np.minimum(others[:, 2:], box[2:])
    wh = np.clip(hi - lo + 1.0, 0.0, None)
    inter = wh[:, 0] * wh[:, 1]
    def area(b):
        return (b[..., 2] - b[..., 0] + 1.0) * (b[..., 3] - b[..., 1] + 1.0)
    return inter / (area(box) + area(others) - inter)


class _ImageGt:
    """Unclaimed ground-truth pool for one (image, class)."""

    def __init__(self, boxes: np.ndarray, difficult: np.ndarray):
        self.boxes = boxes.astype(float)
        self.difficult = difficult
        self.claimed = np.zeros(len(boxes), dtype=bool)

    @property
    def num_scoring(self) -> int:
        return int((~self.difficult).sum())

    def match(self, det_box, thresh) -> bool:
        """True if det_box claims a fresh gt (TP); False if it is a false
        positive. Difficult gts absorb the detection without scoring."""
        if len(self.boxes) == 0:
            return False
        iou = _iou_against(np.asarray(det_box, float), self.boxes)
        best = int(iou.argmax())
        if iou[best] <= thresh:
            return False
        if self.difficult[best]:
            return None     # ignored: neither TP nor FP
        if self.claimed[best]:
            return False
        self.claimed[best] = True
        return True


# -- evaluation -----------------------------------------------------------

def _load_annotations(annopath, imagesetfile, cachedir):
    """Parse (or load cached) annotations for every image in the set."""
    cachedir = Path(cachedir)
    cachedir.mkdir(parents=True, exist_ok=True)
    image_names = [ln.strip() for ln in
                   Path(imagesetfile).read_text().splitlines() if ln.strip()]
    cache = cachedir / f'{Path(imagesetfile).name}_annots.json'
    if cache.exists():
        records = json.loads(cache.read_text())
        parsed = {k: [VocObject(name=d['name'], box=tuple(d['bbox']),
                                difficult=bool(d['difficult']),
                                truncated=bool(d['truncated']),
                                pose=d['pose']) for d in v]
                  for k, v in records.items()}
        return image_names, parsed
    parsed = {}
    for i, name in enumerate(image_names):
        parsed[name] = _read_voc_xml(annopath.format(name))
        if i % 500 == 0:
            print(f'[voc_eval] parsed {i + 1}/{len(image_names)} annotations')
    records = {k: [{'name': o.name, 'pose': o.pose,
                    'truncated': int(o.truncated),
                    'difficult': int(o.difficult), 'bbox': list(o.box)}
                   for o in v] for k, v in parsed.items()}
    tmp = cache.with_name(f'{cache.name}.{os.getpid()}.tmp')
    tmp.write_text(json.dumps(records))
    os.replace(tmp, cache)
    return image_names, parsed


def voc_eval(detpath, annopath, imagesetfile, classname, cachedir,
             ovthresh=0.5, use_07_metric=False, use_diff=False):
    """Evaluate one class. Returns (recall, precision, ap).

    detpath.format(classname) names a devkit-layout results file whose lines
    are 'image_id score x1 y1 x2 y2' with 1-based coordinates;
    annopath.format(image_id) names the XML annotation.
    """
    image_names, parsed = _load_annotations(annopath, imagesetfile, cachedir)

    gt_pool = {}
    for name in image_names:
        this_class = [o for o in parsed[name] if o.name == classname]
        boxes = np.array([o.box for o in this_class], float).reshape(-1, 4)
        if use_diff:
            difficult = np.zeros(len(this_class), dtype=bool)
        else:
            difficult = np.array([o.difficult for o in this_class], bool)
        gt_pool[name] = _ImageGt(boxes, difficult)
    num_positives = sum(gt.num_scoring for gt in gt_pool.values())

    # detections: one line per box, confidence-descending across all images
    records = []
    for line in Path(detpath.format(classname)).read_text().splitlines():
        fields = line.split()
        if fields:
            records.append((fields[0], float(fields[1]),
                            tuple(float(v) for v in fields[2:6])))
    records.sort(key=lambda r: -r[1])

    is_tp = np.zeros(len(records), dtype=bool)
    is_fp = np.zeros(len(records), dtype=bool)
    for i, (image_id, _score, box) in enumerate(records):
        verdict = gt_pool[image_id].match(box, ovthresh)
        if verdict is True:
            is_tp[i] = True
        elif verdict is False:
            is_fp[i] = True
        # verdict None: matched a difficult gt — ignored entirely

    tp = np.cumsum(is_tp)
    fp = np.cumsum(is_fp)
    recall = tp / float(max(num_positives, 1))
    precision = tp / np.maximum(tp + fp, np.finfo(np.float64).eps)
    return recall, precision, voc_ap(recall, precision, use_07_metric)
