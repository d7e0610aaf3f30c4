"""PASCAL VOC dataset.

A copy of ``tf_faster_rcnn_tpu/datasets/pascal_voc.py`` on the port's config
and ``voc_eval``. The MATLAB evaluation runs the devkit wrapper that lives in
the JAX package's directory: a data directory, not an import.

Covers what the reference VOC binding covers (reference
lib/datasets/pascal_voc.py:26-299): the 20 VOC classes + background, the
VOCdevkit directory protocol, XML annotations parsed to 0-based pixel
coordinates with difficult-object filtering, a pickle-cached gt roidb,
salted comp4 results files written in the devkit layout, per-class python
evaluation + mAP, the optional MATLAB devkit evaluation, and
competition_mode. Structured our way: a pathlib layout object owns every
devkit path, annotations parse into typed records (datasets/annotations.py),
and eval results come back as a class->AP mapping.
"""

from __future__ import annotations

import pickle
import subprocess
import uuid
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from tf_faster_rcnn_torch.config import cfg
from tf_faster_rcnn_torch.datasets.annotations import (BoxAnnotation,
                                                     build_roidb_entry,
                                                     cached_build)
from tf_faster_rcnn_torch.datasets.imdb import imdb
from tf_faster_rcnn_torch.datasets.voc_eval import _read_voc_xml, voc_eval

VOC_CLASSES = ('__background__',
               'aeroplane', 'bicycle', 'bird', 'boat',
               'bottle', 'bus', 'car', 'cat', 'chair',
               'cow', 'diningtable', 'dog', 'horse',
               'motorbike', 'person', 'pottedplant',
               'sheep', 'sofa', 'train', 'tvmonitor')


@dataclass(frozen=True)
class VocLayout:
    """Path protocol of a VOCdevkit tree."""

    devkit: Path
    year: str

    @property
    def data(self) -> Path:
        return self.devkit / f'VOC{self.year}'

    def image(self, image_id: str) -> Path:
        return self.data / 'JPEGImages' / f'{image_id}.jpg'

    def annotation(self, image_id: str) -> Path:
        return self.data / 'Annotations' / f'{image_id}.xml'

    def split_file(self, split: str) -> Path:
        return self.data / 'ImageSets' / 'Main' / f'{split}.txt'

    def results_file(self, comp_id: str, split: str, classname: str) -> Path:
        # e.g. results/VOC2007/Main/comp4_det_test_aeroplane.txt
        folder = self.devkit / 'results' / f'VOC{self.year}' / 'Main'
        folder.mkdir(parents=True, exist_ok=True)
        return folder / f'{comp_id}_det_{split}_{classname}.txt'

    @property
    def eval_cache(self) -> Path:
        return self.devkit / 'annotations_cache'


class pascal_voc(imdb):
    def __init__(self, image_set, year, use_diff=False):
        suffix = '_diff' if use_diff else ''
        super().__init__(f'voc_{year}_{image_set}{suffix}',
                         classes=list(VOC_CLASSES))
        self._year = year
        self._image_set = image_set
        self._layout = VocLayout(Path(cfg.DATA_DIR) / f'VOCdevkit{year}',
                                 year)
        self._label_of = {name: i for i, name in enumerate(self.classes)}
        self._salt = uuid.uuid4().hex
        self.config = {'cleanup': True, 'use_salt': True,
                       'use_diff': use_diff, 'matlab_eval': False,
                       'rpn_file': None}
        for required in (self._layout.devkit, self._layout.data):
            if not required.exists():
                raise FileNotFoundError(f'VOCdevkit path missing: {required}')
        self._image_index = self._read_split()
        self._roidb_handler = self.gt_roidb

    def _read_split(self):
        split = self._layout.split_file(self._image_set)
        if not split.exists():
            raise FileNotFoundError(f'image set listing missing: {split}')
        return [ln.strip() for ln in split.read_text().splitlines()
                if ln.strip()]

    # -- images ----------------------------------------------------------

    def image_path_at(self, i):
        return self.image_path_from_index(self._image_index[i])

    def image_path_from_index(self, image_id):
        path = self._layout.image(image_id)
        if not path.exists():
            raise FileNotFoundError(f'image missing: {path}')
        return str(path)

    # -- annotations -> roidb --------------------------------------------

    def _annotation_entry(self, image_id):
        """One image's XML -> roidb record. Devkit coordinates are 1-based;
        the roidb stores 0-based inclusive pixels (reference
        pascal_voc.py:141-185)."""
        keep_difficult = self.config['use_diff']
        objects = []
        for obj in _read_voc_xml(self._layout.annotation(image_id)):
            if obj.difficult and not keep_difficult:
                continue
            x1, y1, x2, y2 = (float(v) - 1.0 for v in obj.box)
            objects.append(BoxAnnotation(
                x1, y1, x2, y2,
                label=self._label_of[obj.name.lower().strip()],
                difficult=obj.difficult))
        return build_roidb_entry(objects, self.num_classes)

    def gt_roidb(self):
        cache = Path(self.cache_path) / f'{self.name}_gt_roidb.pkl'
        return cached_build(
            cache,
            lambda: [self._annotation_entry(i) for i in self.image_index],
            what=f'{self.name} gt roidb')

    def rpn_roidb(self):
        """Legacy external-proposal mode: merge pickled RPN boxes with gt
        (gt is unavailable for the 2012 test split)."""
        has_gt = int(self._year) == 2007 or self._image_set != 'test'
        gt = self.gt_roidb() if has_gt else None
        rpn_file = self.config['rpn_file']
        if rpn_file is None or not Path(rpn_file).exists():
            raise FileNotFoundError(f'rpn proposal pickle: {rpn_file}')
        with open(rpn_file, 'rb') as f:
            box_list = pickle.load(f)
        proposals = self.create_roidb_from_box_list(box_list, gt)
        return imdb.merge_roidbs(gt, proposals) if has_gt else proposals

    # -- results files ----------------------------------------------------

    def _comp_id(self):
        return ('comp4_' + self._salt) if self.config['use_salt'] else 'comp4'

    def _results_path(self, classname):
        return self._layout.results_file(self._comp_id(), self._image_set,
                                         classname)

    def _foreground_classes(self):
        return [(i, c) for i, c in enumerate(self.classes)
                if c != '__background__']

    def _write_results(self, all_boxes):
        """Devkit-layout per-class results files; coordinates go back out
        1-based (reference pascal_voc.py:187-219)."""
        for cls_ind, classname in self._foreground_classes():
            lines = []
            for im_ind, image_id in enumerate(self.image_index):
                dets = all_boxes[cls_ind][im_ind]
                if len(dets) == 0:
                    continue
                for x1, y1, x2, y2, score in np.asarray(dets, float):
                    lines.append(f'{image_id} {score:.3f} {x1 + 1:.1f} '
                                 f'{y1 + 1:.1f} {x2 + 1:.1f} {y2 + 1:.1f}')
            path = self._results_path(classname)
            path.write_text(''.join(ln + '\n' for ln in lines))
            print(f'[voc] wrote {len(lines)} {classname} detections '
                  f'-> {path.name}')

    # -- evaluation -------------------------------------------------------

    def _python_eval(self, output_dir='output'):
        """Per-class voc_eval + mAP; PR curves pickled per class. The
        11-point metric applies to pre-2010 sets."""
        eleven_point = int(self._year) < 2010
        out = Path(output_dir)
        out.mkdir(parents=True, exist_ok=True)
        ap_of = {}
        for _, classname in self._foreground_classes():
            recall, precision, ap = voc_eval(
                str(self._results_path('{:s}')),
                str(self._layout.annotation('{:s}')),
                str(self._layout.split_file(self._image_set)),
                classname,
                str(self._layout.eval_cache),
                ovthresh=0.5,
                use_07_metric=eleven_point,
                use_diff=self.config['use_diff'])
            ap_of[classname] = ap
            with (out / f'{classname}_pr.pkl').open('wb') as f:
                pickle.dump({'rec': recall, 'prec': precision, 'ap': ap}, f)
        mean_ap = float(np.mean(list(ap_of.values())))
        print(f'[voc] {"11-point" if eleven_point else "AUC"} metric, '
              f'IoU 0.5')
        for classname, ap in ap_of.items():
            print(f'[voc] AP {classname:>12s} = {ap:.4f}')
        print(f'[voc] mAP = {mean_ap:.4f}')
        print('[voc] (python eval; the devkit MATLAB eval is the official '
              'number — use config matlab_eval for paper results)')
        return mean_ap

    def _matlab_eval(self, output_dir='output'):
        # the devkit wrapper's .m files, the port's own copy
        wrapper = Path(__file__).resolve().parent / 'VOCdevkit-matlab-wrapper'
        script = (f"dbstop if error; voc_eval('{self._layout.devkit}',"
                  f"'{self._comp_id()}','{self._image_set}',"
                  f"'{output_dir}'); quit;")
        cmd = [cfg.MATLAB, '-nodisplay', '-nodesktop', '-r', script]
        print(f'[voc] official MATLAB eval: {cmd}')
        subprocess.call(cmd, cwd=str(wrapper))

    def evaluate_detections(self, all_boxes, output_dir):
        self._write_results(all_boxes)
        mean_ap = self._python_eval(output_dir)
        if self.config['matlab_eval']:
            self._matlab_eval(output_dir)
        if self.config['cleanup']:
            for _, classname in self._foreground_classes():
                self._results_path(classname).unlink(missing_ok=True)
        return mean_ap

    def competition_mode(self, on):
        """Competition submissions need unsalted, kept results files."""
        self.config['use_salt'] = not on
        self.config['cleanup'] = not on
