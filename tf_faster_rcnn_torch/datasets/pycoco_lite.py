"""Minimal pure-numpy implementation of the pycocotools API (bbox only).

A copy of ``tf_faster_rcnn_tpu/datasets/pycoco_lite.py``.

pycocotools is not available in every environment (it needs a C extension);
this module provides the subset of its API that the COCO imdb uses — the
COCO annotation index and the COCOeval bbox evaluation protocol (IoU
thresholds 0.5:0.95, 101-point interpolated precision, area ranges, maxDets,
crowd handling) — implemented from the published COCO evaluation protocol.
When the real pycocotools is installed it is preferred (datasets/coco.py
falls back here only on ImportError).

API surface: COCO(file|dict).{getCatIds,loadCats,getImgIds,loadImgs,
getAnnIds,loadAnns,loadRes}, COCOeval(gt,dt).{params,evaluate,accumulate,
summarize,eval,stats}.
"""

from __future__ import annotations

import copy
import json
from collections import defaultdict

import numpy as np

__all__ = ["COCO", "COCOeval"]


class COCO(object):
    def __init__(self, annotation_file=None):
        self.dataset = {}
        self.anns, self.cats, self.imgs = {}, {}, {}
        self.imgToAnns = defaultdict(list)
        self.catToImgs = defaultdict(list)
        if annotation_file is not None:
            if isinstance(annotation_file, dict):
                self.dataset = annotation_file
            else:
                with open(annotation_file, "r") as f:
                    self.dataset = json.load(f)
            self.createIndex()

    def createIndex(self):
        for ann in self.dataset.get("annotations", []):
            self.imgToAnns[ann["image_id"]].append(ann)
            self.anns[ann["id"]] = ann
            self.catToImgs[ann["category_id"]].append(ann["image_id"])
        for img in self.dataset.get("images", []):
            self.imgs[img["id"]] = img
        for cat in self.dataset.get("categories", []):
            self.cats[cat["id"]] = cat

    def getCatIds(self, catNms=(), supNms=(), catIds=()):
        cats = list(self.dataset.get("categories", []))
        if catNms:
            cats = [c for c in cats if c["name"] in catNms]
        if supNms:
            cats = [c for c in cats if c.get("supercategory") in supNms]
        if catIds:
            cats = [c for c in cats if c["id"] in catIds]
        return [c["id"] for c in cats]

    def loadCats(self, ids):
        ids = ids if hasattr(ids, "__iter__") else [ids]
        return [self.cats[i] for i in ids]

    def getImgIds(self, imgIds=(), catIds=()):
        if not imgIds and not catIds:
            return list(self.imgs.keys())
        ids = set(imgIds) if imgIds else set(self.imgs.keys())
        for c in catIds:
            ids &= set(self.catToImgs[c])
        return list(ids)

    def loadImgs(self, ids):
        ids = ids if hasattr(ids, "__iter__") else [ids]
        return [self.imgs[i] for i in ids]

    def getAnnIds(self, imgIds=(), catIds=(), areaRng=(), iscrowd=None):
        imgIds = imgIds if hasattr(imgIds, "__iter__") else [imgIds]
        catIds = catIds if hasattr(catIds, "__iter__") else [catIds]
        if imgIds:
            anns = [a for i in imgIds for a in self.imgToAnns[i]]
        else:
            anns = list(self.dataset.get("annotations", []))
        if catIds:
            anns = [a for a in anns if a["category_id"] in catIds]
        if areaRng:
            anns = [a for a in anns
                    if areaRng[0] < a["area"] < areaRng[1]]
        if iscrowd is not None:
            anns = [a for a in anns if a.get("iscrowd", 0) == iscrowd]
        return [a["id"] for a in anns]

    def loadAnns(self, ids):
        ids = ids if hasattr(ids, "__iter__") else [ids]
        return [self.anns[i] for i in ids]

    def loadRes(self, resFile):
        """Build a result COCO from a detections json (list of dicts with
        image_id, category_id, bbox [x,y,w,h], score)."""
        res = COCO()
        res.dataset["images"] = [img for img in self.dataset.get("images", [])]
        if isinstance(resFile, str):
            with open(resFile) as f:
                anns = json.load(f)
        else:
            anns = resFile
        assert isinstance(anns, list), "results must be a list"
        if anns:
            img_ids = set(self.getImgIds())
            assert set(a["image_id"] for a in anns) <= img_ids, \
                "Results contain unknown image ids"
        for i, ann in enumerate(anns):
            bb = ann["bbox"]
            ann["area"] = bb[2] * bb[3]
            ann["id"] = i + 1
            ann["iscrowd"] = 0
        res.dataset["annotations"] = anns
        res.dataset["categories"] = copy.deepcopy(
            self.dataset.get("categories", []))
        res.createIndex()
        return res


def _bbox_iou(dts, gts, iscrowd):
    """IoU between dt and gt xywh boxes; crowd gt uses intersection/dt-area."""
    dts = np.asarray(dts, np.float64).reshape(-1, 4)
    gts = np.asarray(gts, np.float64).reshape(-1, 4)
    ious = np.zeros((len(dts), len(gts)))
    for j, g in enumerate(gts):
        gx1, gy1, gw, gh = g
        garea = gw * gh
        for i, d in enumerate(dts):
            dx1, dy1, dw, dh = d
            iw = min(dx1 + dw, gx1 + gw) - max(dx1, gx1)
            if iw <= 0:
                continue
            ih = min(dy1 + dh, gy1 + gh) - max(dy1, gy1)
            if ih <= 0:
                continue
            inter = iw * ih
            if iscrowd[j]:
                union = dw * dh
            else:
                union = dw * dh + garea - inter
            ious[i, j] = inter / union
    return ious


class _Params(object):
    def __init__(self):
        self.imgIds = []
        self.catIds = []
        self.iouThrs = np.linspace(0.5, 0.95, 10)
        self.recThrs = np.linspace(0.0, 1.00, 101)
        self.maxDets = [1, 10, 100]
        self.areaRng = [[0, 1e10], [0, 32 ** 2], [32 ** 2, 96 ** 2],
                        [96 ** 2, 1e10]]
        self.areaRngLbl = ["all", "small", "medium", "large"]
        self.useCats = 1
        self.useSegm = 0
        self.iouType = "bbox"


class COCOeval(object):
    def __init__(self, cocoGt=None, cocoDt=None, iouType="bbox"):
        assert iouType == "bbox", "pycoco_lite supports bbox evaluation only"
        self.cocoGt = cocoGt
        self.cocoDt = cocoDt
        self.params = _Params()
        self.eval = {}
        self.stats = []
        if cocoGt is not None:
            self.params.imgIds = sorted(cocoGt.getImgIds())
            self.params.catIds = sorted(cocoGt.getCatIds())

    def _prepare(self):
        p = self.params
        self._gts = defaultdict(list)
        self._dts = defaultdict(list)
        for img_id in p.imgIds:
            for cat_id in p.catIds:
                gids = self.cocoGt.getAnnIds(imgIds=[img_id],
                                             catIds=[cat_id])
                dids = self.cocoDt.getAnnIds(imgIds=[img_id],
                                             catIds=[cat_id])
                self._gts[img_id, cat_id] = self.cocoGt.loadAnns(gids)
                self._dts[img_id, cat_id] = self.cocoDt.loadAnns(dids)

    def evaluate(self):
        p = self.params
        assert not p.useSegm, "pycoco_lite supports bbox evaluation only"
        self._prepare()
        self.ious = {}
        for img_id in p.imgIds:
            for cat_id in p.catIds:
                gt = self._gts[img_id, cat_id]
                dt = sorted(self._dts[img_id, cat_id],
                            key=lambda d: -d["score"])[:p.maxDets[-1]]
                if not gt or not dt:
                    self.ious[img_id, cat_id] = np.zeros((len(dt), len(gt)))
                    continue
                iscrowd = [int(g.get("iscrowd", 0)) for g in gt]
                self.ious[img_id, cat_id] = _bbox_iou(
                    [d["bbox"] for d in dt], [g["bbox"] for g in gt],
                    iscrowd)
        self.evalImgs = [
            self._evaluate_img(img_id, cat_id, area, p.maxDets[-1])
            for cat_id in p.catIds
            for area in p.areaRng
            for img_id in p.imgIds]

    def _evaluate_img(self, img_id, cat_id, aRng, maxDet):
        p = self.params
        gt = self._gts[img_id, cat_id]
        dt = self._dts[img_id, cat_id]
        if not gt and not dt:
            return None
        for g in gt:
            g["_ignore"] = (g.get("iscrowd", 0)
                            or g["area"] < aRng[0] or g["area"] > aRng[1])
        # gts with ignored last (stable), dts by score desc capped at maxDet
        gtind = np.argsort([g["_ignore"] for g in gt], kind="mergesort")
        gt = [gt[i] for i in gtind]
        dtind = np.argsort([-d["score"] for d in dt], kind="mergesort")
        dt = [dt[i] for i in dtind[:maxDet]]
        iscrowd = [int(g.get("iscrowd", 0)) for g in gt]
        ious = (self.ious[img_id, cat_id][:, gtind]
                if len(self.ious[img_id, cat_id]) > 0
                else self.ious[img_id, cat_id])

        T, G, D = len(p.iouThrs), len(gt), len(dt)
        gtm = np.zeros((T, G))
        dtm = np.zeros((T, D))
        gtIg = np.array([g["_ignore"] for g in gt])
        dtIg = np.zeros((T, D))
        if len(ious) > 0:
            for tind, t in enumerate(p.iouThrs):
                for dind, d in enumerate(dt):
                    iou = min(t, 1 - 1e-10)
                    m = -1
                    for gind in range(G):
                        # gt already matched (and not crowd): skip
                        if gtm[tind, gind] > 0 and not iscrowd[gind]:
                            continue
                        # stop at ignored gts once a real match exists
                        if m > -1 and gtIg[m] == 0 and gtIg[gind] == 1:
                            break
                        if ious[dind, gind] < iou:
                            continue
                        iou = ious[dind, gind]
                        m = gind
                    if m == -1:
                        continue
                    dtIg[tind, dind] = gtIg[m]
                    dtm[tind, dind] = gt[m]["id"]
                    gtm[tind, m] = d["id"]
        # unmatched dts outside the area range are ignored
        a = np.array([d["area"] < aRng[0] or d["area"] > aRng[1]
                      for d in dt]).reshape(1, D)
        dtIg = np.logical_or(dtIg, np.logical_and(
            dtm == 0, np.repeat(a, T, axis=0)))
        return {
            "image_id": img_id, "category_id": cat_id, "aRng": aRng,
            "maxDet": maxDet,
            "dtIds": [d["id"] for d in dt],
            "gtIds": [g["id"] for g in gt],
            "dtMatches": dtm, "gtMatches": gtm,
            "dtScores": [d["score"] for d in dt],
            "gtIgnore": gtIg, "dtIgnore": dtIg,
        }

    def accumulate(self, p=None):
        p = p or self.params
        T, R = len(p.iouThrs), len(p.recThrs)
        K, A, M = len(p.catIds), len(p.areaRng), len(p.maxDets)
        precision = -np.ones((T, R, K, A, M))
        recall = -np.ones((T, K, A, M))
        scores = -np.ones((T, R, K, A, M))
        n_imgs = len(p.imgIds)
        for k in range(K):
            for a in range(A):
                base = k * A * n_imgs + a * n_imgs
                E = [self.evalImgs[base + i] for i in range(n_imgs)]
                E = [e for e in E if e is not None]
                if not E:
                    continue
                for m, maxDet in enumerate(p.maxDets):
                    dtScores = np.concatenate(
                        [e["dtScores"][:maxDet] for e in E])
                    inds = np.argsort(-dtScores, kind="mergesort")
                    dtScoresSorted = dtScores[inds]
                    dtm = np.concatenate(
                        [e["dtMatches"][:, :maxDet] for e in E],
                        axis=1)[:, inds]
                    dtIg = np.concatenate(
                        [e["dtIgnore"][:, :maxDet] for e in E],
                        axis=1)[:, inds]
                    gtIg = np.concatenate([e["gtIgnore"] for e in E])
                    npig = np.count_nonzero(gtIg == 0)
                    if npig == 0:
                        continue
                    tps = np.logical_and(dtm, np.logical_not(dtIg))
                    fps = np.logical_and(np.logical_not(dtm),
                                         np.logical_not(dtIg))
                    tp_sum = np.cumsum(tps, axis=1).astype(float)
                    fp_sum = np.cumsum(fps, axis=1).astype(float)
                    for t in range(T):
                        tp, fp = tp_sum[t], fp_sum[t]
                        nd = len(tp)
                        rc = tp / npig
                        pr = tp / (fp + tp + np.spacing(1))
                        q = np.zeros(R)
                        ss = np.zeros(R)
                        recall[t, k, a, m] = rc[-1] if nd else 0
                        pr = pr.tolist()
                        for i in range(nd - 1, 0, -1):
                            if pr[i] > pr[i - 1]:
                                pr[i - 1] = pr[i]
                        inds_r = np.searchsorted(rc, p.recThrs, side="left")
                        for ri, pi in enumerate(inds_r):
                            if pi < nd:
                                q[ri] = pr[pi]
                                ss[ri] = dtScoresSorted[pi]
                        precision[t, :, k, a, m] = q
                        scores[t, :, k, a, m] = ss
        self.eval = {
            "params": p, "counts": [T, R, K, A, M],
            "precision": precision, "recall": recall, "scores": scores,
        }

    def _summarize(self, ap=1, iouThr=None, areaRng="all", maxDets=100):
        p = self.params
        aind = [i for i, l in enumerate(p.areaRngLbl) if l == areaRng]
        mind = [i for i, m in enumerate(p.maxDets) if m == maxDets]
        if ap == 1:
            s = self.eval["precision"]
            if iouThr is not None:
                t = np.where(np.abs(p.iouThrs - iouThr) < 1e-6)[0]
                s = s[t]
            s = s[:, :, :, aind, mind]
        else:
            s = self.eval["recall"]
            if iouThr is not None:
                t = np.where(np.abs(p.iouThrs - iouThr) < 1e-6)[0]
                s = s[t]
            s = s[:, :, aind, mind]
        mean_s = -1 if len(s[s > -1]) == 0 else np.mean(s[s > -1])
        kind = "Average Precision" if ap == 1 else "Average Recall"
        abbr = "AP" if ap == 1 else "AR"
        iou_str = ("{:0.2f}:{:0.2f}".format(p.iouThrs[0], p.iouThrs[-1])
                   if iouThr is None else "{:0.2f}".format(iouThr))
        print(" {:<18} {} @[ IoU={:<9} | area={:>6s} | maxDets={:>3d} ] "
              "= {:0.3f}".format(kind, "({})".format(abbr), iou_str,
                                 areaRng, maxDets, mean_s))
        return mean_s

    def summarize(self):
        self.stats = np.zeros(12)
        self.stats[0] = self._summarize(1)
        self.stats[1] = self._summarize(1, iouThr=0.5,
                                        maxDets=self.params.maxDets[2])
        self.stats[2] = self._summarize(1, iouThr=0.75,
                                        maxDets=self.params.maxDets[2])
        self.stats[3] = self._summarize(1, areaRng="small",
                                        maxDets=self.params.maxDets[2])
        self.stats[4] = self._summarize(1, areaRng="medium",
                                        maxDets=self.params.maxDets[2])
        self.stats[5] = self._summarize(1, areaRng="large",
                                        maxDets=self.params.maxDets[2])
        self.stats[6] = self._summarize(0, maxDets=self.params.maxDets[0])
        self.stats[7] = self._summarize(0, maxDets=self.params.maxDets[1])
        self.stats[8] = self._summarize(0, maxDets=self.params.maxDets[2])
        self.stats[9] = self._summarize(0, areaRng="small",
                                        maxDets=self.params.maxDets[2])
        self.stats[10] = self._summarize(0, areaRng="medium",
                                         maxDets=self.params.maxDets[2])
        self.stats[11] = self._summarize(0, areaRng="large",
                                         maxDets=self.params.maxDets[2])
