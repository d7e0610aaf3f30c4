"""Typed per-image annotations and the roidb record format.

A copy of ``tf_faster_rcnn_tpu/datasets/annotations.py``; the roidb caches it
writes hold only plain types (dicts, numpy arrays, scipy sparse matrices), so
either package reads the other's.

This is the framework's own annotation model: each dataset parses its native
format (VOC XML, COCO json) into a list of `BoxAnnotation` per image, and the
shared builders here turn those into the roidb dicts the data pipeline
consumes (data/roidb.py, data/loader.py). The record layout is behaviorally
compatible with the reference's roidb entries (reference
lib/datasets/imdb.py, lib/datasets/pascal_voc.py:141-185,
lib/datasets/coco.py:123-179) — boxes are 0-based inclusive pixel
coordinates, class 0 is background, crowd regions carry gt_overlaps == -1 so
training-target sampling can exclude them — but the construction path is
ours.
"""

from __future__ import annotations

import os
import pickle
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Sequence

import numpy as np
import scipy.sparse


@dataclass(frozen=True)
class BoxAnnotation:
    """One annotated region: 0-based inclusive [x1, y1, x2, y2] pixels."""

    x1: float
    y1: float
    x2: float
    y2: float
    label: int                   # index into the dataset's class list; 0 = bg
    area: float = 0.0            # segmentation area if known, else box area
    crowd: bool = False          # COCO iscrowd — excluded from matching
    difficult: bool = False      # VOC difficult — excluded from eval by default

    def pixel_area(self) -> float:
        return (self.x2 - self.x1 + 1.0) * (self.y2 - self.y1 + 1.0)


def build_roidb_entry(objects: Sequence[BoxAnnotation], num_classes: int,
                      extra: dict | None = None) -> dict:
    """Pack typed annotations into one roidb record.

    gt_overlaps is the sparse [num_objects, num_classes] class-affinity
    matrix: one-hot 1.0 at the object's label, or a full -1 row for crowd
    regions (the loader's gt filter and imdb.evaluate_recall key off the
    sign, matching reference coco.py:162-168).
    """
    n = len(objects)
    boxes = np.zeros((n, 4), dtype=np.uint16)
    labels = np.zeros((n,), dtype=np.int32)
    affinity = np.zeros((n, num_classes), dtype=np.float32)
    areas = np.zeros((n,), dtype=np.float32)
    for i, obj in enumerate(objects):
        boxes[i] = (obj.x1, obj.y1, obj.x2, obj.y2)
        labels[i] = obj.label
        areas[i] = obj.area if obj.area else obj.pixel_area()
        if obj.crowd:
            affinity[i] = -1.0
        else:
            affinity[i, obj.label] = 1.0
    entry = {
        'boxes': boxes,
        'gt_classes': labels,
        'gt_overlaps': scipy.sparse.csr_matrix(affinity),
        'seg_areas': areas,
        'flipped': False,
    }
    if extra:
        entry.update(extra)
    return entry


def flipped_entry(entry: dict, width: int) -> dict:
    """A horizontally mirrored view of a roidb record (x coords reflected
    about the image midline in the 0-based inclusive convention)."""
    boxes = entry['boxes'].copy()
    boxes[:, [0, 2]] = width - 1 - entry['boxes'][:, [2, 0]]
    if not (boxes[:, 2] >= boxes[:, 0]).all():
        raise ValueError('flip produced an inverted box; bad source width?')
    out = dict(entry)
    out['boxes'] = boxes
    out['flipped'] = True
    return out


def cached_build(cache_file: str | Path, build: Callable[[], object],
                 what: str = 'roidb'):
    """Build-or-load with a pickle cache (the reference caches gt roidbs the
    same way, pascal_voc.py:98-120). The cache is written under a name of
    this process's own and then renamed into place, so another process
    (a data-parallel rank building the same roidb) never reads it half
    written."""
    cache_file = Path(cache_file)
    if cache_file.exists():
        with cache_file.open('rb') as f:
            data = pickle.load(f)
        print(f'[cache] {what} <- {cache_file}')
        return data
    data = build()
    cache_file.parent.mkdir(parents=True, exist_ok=True)
    part = cache_file.with_name(f'{cache_file.name}.{os.getpid()}.part')
    with part.open('wb') as f:
        pickle.dump(data, f, pickle.HIGHEST_PROTOCOL)
    os.replace(part, cache_file)
    print(f'[cache] {what} -> {cache_file}')
    return data
