"""MS COCO dataset.

A copy of ``tf_faster_rcnn_tpu/datasets/coco.py`` on the port's config,
which saves the evaluation's arrays (``detection_results.pkl``) as a dict of
plain types, not the evaluator object, so that reading the file imports
neither package.

Covers what the reference COCO binding covers (reference
lib/datasets/coco.py:27-316): the minival/valminusminival views onto
val2014 images, annotation sanitization (clip to the image, drop
empty-area), crowd regions carried with gt_overlaps == -1 so target
sampling can exclude them under TRAIN.USE_ALL_GT=False, width-from-metadata
flip augmentation, bbox-results json in the official format, and COCOeval
bbox evaluation with a per-category AP report. Implementation is ours:
annotations parse into typed records (datasets/annotations.py) and the
COCO api object is wrapped behind small helpers. Real pycocotools is used
when installed; otherwise the bundled pure-numpy pycoco_lite backend.
"""

from __future__ import annotations

import json
import pickle
import uuid
from pathlib import Path

import numpy as np

from tf_faster_rcnn_torch.config import cfg
from tf_faster_rcnn_torch.datasets import ds_utils
from tf_faster_rcnn_torch.datasets.annotations import (BoxAnnotation,
                                                     build_roidb_entry,
                                                     cached_build,
                                                     flipped_entry)
from tf_faster_rcnn_torch.datasets.imdb import imdb

# split views that share another split's image files (reference coco.py:52-60)
SPLIT_VIEWS = {
    'minival2014': 'val2014',
    'valminusminival2014': 'val2014',
    'test-dev2015': 'test2015',
}


def coco_api():
    """(COCO, COCOeval) classes — real pycocotools when available, else the
    bundled pure-numpy implementation."""
    try:
        from pycocotools.coco import COCO
        from pycocotools.cocoeval import COCOeval
    except ImportError:
        from tf_faster_rcnn_torch.datasets.pycoco_lite import COCO, COCOeval
    return COCO, COCOeval


def _clip_xywh_box(bbox, width, height):
    """COCO [x, y, w, h] float box -> clipped 0-based inclusive corners, or
    None when nothing remains inside the image (reference coco.py:132-141
    keeps a box iff x2 >= x1 and y2 >= y1 after clipping)."""
    x1 = max(0.0, bbox[0])
    y1 = max(0.0, bbox[1])
    x2 = min(width - 1.0, x1 + max(0.0, bbox[2] - 1.0))
    y2 = min(height - 1.0, y1 + max(0.0, bbox[3] - 1.0))
    if x2 < x1 or y2 < y1:
        return None
    return x1, y1, x2, y2


class coco(imdb):
    def __init__(self, image_set, year):
        super().__init__(f'coco_{year}_{image_set}')
        self._year = year
        self._image_set = image_set
        self._root = Path(cfg.DATA_DIR) / 'coco'
        # image files live under the view target, e.g. minival2014 -> val2014
        self._data_name = SPLIT_VIEWS.get(image_set + year, image_set + year)

        COCO, _ = coco_api()
        self._COCO = COCO(str(self._annotation_file()))
        categories = self._COCO.loadCats(self._COCO.getCatIds())
        self._classes = (['__background__']
                         + [cat['name'] for cat in categories])
        # bidirectional label <-> COCO category id maps
        self._cat_id_of = {cat['name']: cat['id'] for cat in categories}
        self._label_of_cat_id = {cat['id']: label for label, cat in
                                 enumerate(categories, start=1)}
        self._image_index = self._COCO.getImgIds()
        self.set_proposal_method('gt')
        self.competition_mode(False)

    def _annotation_file(self) -> Path:
        kind = 'image_info' if 'test' in self._image_set else 'instances'
        return (self._root / 'annotations'
                / f'{kind}_{self._image_set}{self._year}.json')

    # -- images ----------------------------------------------------------

    def image_path_from_index(self, image_id):
        # e.g. images/train2014/COCO_train2014_000000119993.jpg
        path = (self._root / 'images' / self._data_name
                / f'COCO_{self._data_name}_{image_id:012d}.jpg')
        if not path.exists():
            raise FileNotFoundError(f'image missing: {path}')
        return str(path)

    def image_path_at(self, i):
        return self.image_path_from_index(self._image_index[i])

    def _image_meta(self, image_id):
        return self._COCO.loadImgs(image_id)[0]

    def _get_widths(self):
        return [meta['width']
                for meta in self._COCO.loadImgs(self._image_index)]

    # -- annotations -> roidb --------------------------------------------

    def _annotation_entry(self, image_id):
        """One image's COCO annotations -> roidb record (reference
        coco.py:123-179). Crowd regions keep their boxes but mark every
        class with affinity -1."""
        meta = self._image_meta(image_id)
        width, height = meta['width'], meta['height']
        objects = []
        for ann in self._COCO.loadAnns(
                self._COCO.getAnnIds(imgIds=image_id, iscrowd=None)):
            corners = _clip_xywh_box(ann['bbox'], width, height)
            if corners is None or ann['area'] <= 0:
                continue
            objects.append(BoxAnnotation(
                *corners,
                label=self._label_of_cat_id[ann['category_id']],
                area=float(ann['area']),
                crowd=bool(ann['iscrowd'])))
        entry = build_roidb_entry(objects, self.num_classes,
                                  extra={'width': width, 'height': height})
        # the clip above guarantees this; keep the reference's hard check
        # (reference coco.py:172 -> ds_utils.validate_boxes)
        ds_utils.validate_boxes(entry['boxes'], width=width, height=height)
        return entry

    def gt_roidb(self):
        cache = Path(self.cache_path) / f'{self.name}_gt_roidb.pkl'
        return cached_build(
            cache,
            lambda: [self._annotation_entry(i) for i in self._image_index],
            what=f'{self.name} gt roidb')

    def append_flipped_images(self):
        """Mirror using the annotation's width — COCO metadata is trusted,
        no image open needed (reference coco.py:184-203)."""
        widths = self._get_widths()
        base = list(self.roidb)
        for entry, width in zip(base, widths):
            self.roidb.append(flipped_entry(entry, width))
        self._image_index = self._image_index * 2

    # -- results json -----------------------------------------------------

    def _results_records(self, all_boxes):
        """Flatten all_boxes[class][image] into official COCO result dicts
        (xywh, +1-width convention on the way out)."""
        records = []
        for label, classname in enumerate(self.classes):
            if classname == '__background__':
                continue
            cat_id = self._cat_id_of[classname]
            for im_ind, image_id in enumerate(self.image_index):
                dets = np.asarray(all_boxes[label][im_ind], dtype=float)
                for det in dets.reshape(-1, 5):
                    x1, y1, x2, y2, score = det
                    records.append({
                        'image_id': int(image_id),
                        'category_id': cat_id,
                        'bbox': [x1, y1, x2 - x1 + 1, y2 - y1 + 1],
                        'score': score,
                    })
        return records

    def _write_results_json(self, all_boxes, res_file: Path):
        records = self._results_records(all_boxes)
        print(f'[coco] writing {len(records)} detections -> {res_file}')
        with res_file.open('w') as f:
            json.dump(records, f)

    # -- evaluation -------------------------------------------------------

    def _category_ap_report(self, coco_eval):
        """Mean and per-category AP over IoU .50:.95 at area=all,
        maxDets=100 (precision table axes: iou, recall, class, area,
        maxDets)."""
        iou_thrs = coco_eval.params.iouThrs
        span = slice(int(np.flatnonzero(np.isclose(iou_thrs, 0.5))[0]),
                     int(np.flatnonzero(np.isclose(iou_thrs, 0.95))[0]) + 1)
        table = coco_eval.eval['precision'][span, :, :, 0, 2]

        def mean_valid(x):
            x = x[x > -1]
            return float(x.mean()) if x.size else float('nan')

        print('[coco] AP@[0.50:0.95] overall: '
              f'{100 * mean_valid(table):.1f}')
        for label, classname in enumerate(self.classes[1:]):
            print(f'[coco] AP {classname:>20s}: '
                  f'{100 * mean_valid(table[:, :, label]):.1f}')
        print('[coco] summary:')
        coco_eval.summarize()

    def _run_coco_eval(self, res_file: Path, output_dir: Path):
        _, COCOeval = coco_api()
        detections = self._COCO.loadRes(str(res_file))
        evaluator = COCOeval(self._COCO, detections)
        evaluator.params.useSegm = False
        evaluator.evaluate()
        evaluator.accumulate()
        self._category_ap_report(evaluator)
        p = evaluator.params
        results = {key: np.asarray(evaluator.eval[key])
                   for key in ('precision', 'recall', 'scores')
                   if key in evaluator.eval}
        results.update(stats=np.asarray(evaluator.stats),
                       iouThrs=np.asarray(p.iouThrs),
                       recThrs=np.asarray(p.recThrs),
                       maxDets=list(p.maxDets), areaRng=list(p.areaRng),
                       catIds=list(p.catIds), imgIds=list(p.imgIds))
        with (output_dir / 'detection_results.pkl').open('wb') as f:
            pickle.dump(results, f, pickle.HIGHEST_PROTOCOL)
        return evaluator

    def evaluate_detections(self, all_boxes, output_dir):
        """Returns COCO AP@[0.5:0.95] (stats[0]); None for gt-less test
        splits, which only get their results json written."""
        output_dir = Path(output_dir)
        output_dir.mkdir(parents=True, exist_ok=True)
        salt = f'_{uuid.uuid4().hex}' if self.config['use_salt'] else ''
        res_file = (output_dir / f'detections_{self._image_set}'
                    f'{self._year}_results{salt}.json')
        self._write_results_json(all_boxes, res_file)
        ap = None
        if 'test' not in self._image_set:
            evaluator = self._run_coco_eval(res_file, output_dir)
            stats = getattr(evaluator, 'stats', None)
            if stats is not None and len(stats):
                ap = float(stats[0])
        if self.config['cleanup']:
            res_file.unlink(missing_ok=True)
        return ap

    def competition_mode(self, on):
        self.config = {'use_salt': not on, 'cleanup': not on}
