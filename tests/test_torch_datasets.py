"""The port's datasets, image reading, host ops and config helpers against
the JAX package.

* reading: ``read_image_bgr`` on binary PPM (under a ``.jpg`` name, with a
  header comment, at maxval 255 and below) equals ``cv2.imread`` exactly; a
  JPEG goes through cv2; ``image_size`` equals PIL's size;
* ``voc_eval`` and ``pascal_voc.evaluate_detections``: the same all_boxes
  give the same per-class recall, precision and AP, and the same mAP, both
  metrics; the ground truth as detections scores mAP 1.0; the port's
  annotation cache is JSON beside the JAX package's pickle;
* COCO: the same detections give the same COCOeval stats as the JAX
  package's pycoco_lite, and the port saves them as plain types;
* ``apply_nms``, ``nms_cpu`` and ``bbox_overlaps_cpu``: equal to the JAX
  ones; the flipped roidb (widths from the header) equal to the JAX one
  (widths from PIL);
* config: ``canvas_buckets``, ``canvas_hw``, ``bucket_index`` and
  ``get_output_dir`` equal to the JAX package's.

All comparisons are exact: the port's copies run the same float64 numpy
code on the same inputs.
"""

import json
import os
import os.path as osp
import pickle

import cv2
import numpy as np
import pytest
import torch
from PIL import Image

from tf_faster_rcnn_tpu import config as jconfig
from tf_faster_rcnn_tpu.datasets import coco as jcoco
from tf_faster_rcnn_tpu.datasets import pascal_voc as jvoc
from tf_faster_rcnn_tpu.datasets import voc_eval as jvoc_eval
from tf_faster_rcnn_tpu.engine import test_engine as jengine
from tf_faster_rcnn_tpu.utils import native as jnative
from tf_faster_rcnn_torch import config as tconfig
from tf_faster_rcnn_torch.data import blob as tblob
from tf_faster_rcnn_torch.datasets import coco as tcoco
from tf_faster_rcnn_torch.datasets import pascal_voc as tvoc
from tf_faster_rcnn_torch.datasets import voc_eval as tvoc_eval
from tf_faster_rcnn_torch.datasets.factory import list_imdbs as tlist
from tf_faster_rcnn_torch.engine import test_engine as tengine
from tf_faster_rcnn_torch.utils import native as tnative

# (h, w) of the mini-VOC's images: landscape and portrait, each scaled by
# 1.28 onto its bucket at TEST.SCALES (96,), MAX_SIZE 128
LANDSCAPE, PORTRAIT = (75, 100), (100, 75)


def make_voc(root, n=8, n_portrait=3, seed=0, image_set="test"):
    """A VOCdevkit2007 tree under root: n images (the last n_portrait
    portrait) of dark noise with 3 painted rectangles each, their classes
    cycling through the 20 VOC classes (so that 7 images hold every class),
    the second object of image 0 difficult, written as binary PPM under
    .jpg names, with XML annotations (1-based corners). Returns {image id:
    [(class, x1, y1, x2, y2), ...]}."""
    rng = np.random.RandomState(seed)
    voc = osp.join(root, "VOCdevkit2007", "VOC2007")
    for sub in ("JPEGImages", "Annotations", osp.join("ImageSets", "Main")):
        os.makedirs(osp.join(voc, sub), exist_ok=True)
    gt = {}
    for i in range(n):
        name = f"{i:06d}"
        h, w = PORTRAIT if i >= n - n_portrait else LANDSCAPE
        im = rng.randint(0, 60, (h, w, 3)).astype(np.uint8)
        objs = []
        for k in range(3):
            x1, y1 = rng.randint(2, w // 2), rng.randint(2, h // 2)
            x2 = min(x1 + rng.randint(15, 40), w - 2)
            y2 = min(y1 + rng.randint(15, 40), h - 2)
            im[y1:y2, x1:x2] = rng.randint(150, 255, 3)
            objs.append((tvoc.VOC_CLASSES[1 + (3 * i + k) % 20],
                         x1 + 1, y1 + 1, x2 + 1, y2 + 1))
        tblob.write_ppm(osp.join(voc, "JPEGImages", name + ".jpg"), im)
        xml = "".join(
            f"<object><name>{c}</name><pose>Left</pose>"
            f"<truncated>0</truncated><difficult>{int(k == 1 and i == 0)}"
            f"</difficult><bndbox><xmin>{x1}</xmin><ymin>{y1}</ymin>"
            f"<xmax>{x2}</xmax><ymax>{y2}</ymax></bndbox></object>"
            for k, (c, x1, y1, x2, y2) in enumerate(objs))
        with open(osp.join(voc, "Annotations", name + ".xml"), "w") as f:
            f.write(f"<annotation><size><width>{w}</width><height>{h}"
                    f"</height><depth>3</depth></size>{xml}</annotation>")
        gt[name] = objs
    with open(osp.join(voc, "ImageSets", "Main", image_set + ".txt"),
              "w") as f:
        f.write("\n".join(gt) + "\n")
    return gt


def set_both_cfgs(**kv):
    """Set the same keys ("TEST.SCALES" style names) in both packages'
    cfg."""
    for c in (jconfig.cfg, tconfig.cfg):
        for key, value in kv.items():
            *path, leaf = key.split(".")
            node = c
            for p in path:
                node = node[p]
            node[leaf] = value


@pytest.fixture(autouse=True)
def _port_cfg():
    """The port's cfg, reset after each test (the conftest resets only the
    JAX package's)."""
    tconfig.reset_cfg()
    yield
    tconfig.reset_cfg()


@pytest.fixture
def voc_root(tmp_path):
    gt = make_voc(str(tmp_path))
    set_both_cfgs(DATA_DIR=str(tmp_path), ROOT_DIR=str(tmp_path))
    return tmp_path, gt


def _random_all_boxes(imdb, gt, seed, jitter=4.0, extra=3):
    """all_boxes with, per image and class of its gt, the gt boxes (0-based)
    jittered plus a few random boxes, each with a random score."""
    rng = np.random.RandomState(seed)
    all_boxes = [[np.zeros((0, 5), np.float32)
                  for _ in range(imdb.num_images)]
                 for _ in range(imdb.num_classes)]
    for i, name in enumerate(imdb.image_index):
        for cls in sorted({obj[0] for obj in gt[name]}):
            c = imdb.classes.index(cls)
            rows = [np.array(b, np.float32) - 1.0 + rng.randn(4) * jitter
                    for k, *b in gt[name] if k == cls]
            for _ in range(rng.randint(0, extra)):
                x1, x2 = np.sort(rng.uniform(0, 90, 2))
                y1, y2 = np.sort(rng.uniform(0, 70, 2))
                rows.append(np.array([x1, y1, x2, y2]))
            if rows:
                boxes = np.array(rows, np.float32).reshape(-1, 4)
                scores = rng.rand(len(boxes), 1).astype(np.float32)
                all_boxes[c][i] = np.hstack([boxes, scores])
    return all_boxes


# -- reading ---------------------------------------------------------------

@pytest.mark.parametrize("maxval,comment", [(255, False), (255, True),
                                            (200, True)])
def test_read_ppm_equals_cv2(tmp_path, maxval, comment):
    rng = np.random.RandomState(maxval)
    rgb = rng.randint(0, maxval + 1, (37, 53, 3)).astype(np.uint8)
    path = str(tmp_path / "im.jpg")
    head = "P6\n" + ("# a comment\n" if comment else "") + f"53 37\n{maxval}\n"
    with open(path, "wb") as f:
        f.write(head.encode() + rgb.tobytes())
    got = tblob.read_image_bgr(path)
    want = cv2.imread(path)
    assert got.dtype == np.uint8 and got.flags.c_contiguous
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, rgb[..., ::-1])
    with Image.open(path) as img:
        assert tblob.image_size(path) == (img.size[1], img.size[0]) == (37, 53)


def test_write_ppm_round_trip(tmp_path):
    im = np.random.RandomState(0).randint(0, 256, (9, 14, 3)).astype(np.uint8)
    path = str(tmp_path / "x.jpg")
    tblob.write_ppm(path, im)
    np.testing.assert_array_equal(cv2.imread(path), im)
    np.testing.assert_array_equal(tblob.read_image_bgr(path), im)


def test_read_jpeg_goes_through_cv2(tmp_path):
    im = np.random.RandomState(1).randint(0, 256, (30, 40, 3)).astype(np.uint8)
    path = str(tmp_path / "x.jpg")
    assert cv2.imwrite(path, im)
    with open(path, "rb") as f:
        assert f.read(2) == b"\xff\xd8"            # a real JPEG
    np.testing.assert_array_equal(tblob.read_image_bgr(path), cv2.imread(path))
    assert tblob.image_size(path) == (30, 40)


def test_read_errors(tmp_path):
    path = str(tmp_path / "short.jpg")
    with open(path, "wb") as f:
        f.write(b"P6\n4 4\n255\n" + b"\0" * 10)
    with pytest.raises(ValueError, match="truncated"):
        tblob.read_image_bgr(path)
    with open(path, "wb") as f:
        f.write(b"not an image")
    with pytest.raises(ValueError, match="failed to read"):
        tblob.read_image_bgr(path)


# -- VOC -------------------------------------------------------------------

@pytest.mark.parametrize("use_07", [True, False])
def test_voc_eval_matches_jax(voc_root, use_07):
    root, gt = voc_root
    imdb = tvoc.pascal_voc("test", "2007")
    all_boxes = _random_all_boxes(imdb, gt, seed=int(use_07))
    imdb.competition_mode(True)        # unsalted, kept results files
    imdb._write_results(all_boxes)
    layout = imdb._layout
    for cls in ("aeroplane", "bicycle", "person", "tvmonitor"):
        args = (str(imdb._results_path("{:s}")),
                str(layout.annotation("{:s}")), str(layout.split_file("test")),
                cls)
        want = jvoc_eval.voc_eval(*args, str(root / "jcache"),
                                  use_07_metric=use_07)
        got = tvoc_eval.voc_eval(*args, str(root / "tcache"),
                                 use_07_metric=use_07)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    # the port's cache is its own JSON file, beside the JAX package's pickle
    assert os.listdir(root / "tcache") == ["test.txt_annots.json"]
    assert os.listdir(root / "jcache") == ["test.txt_annots.pkl"]
    again = tvoc_eval.voc_eval(*args, str(root / "tcache"),
                               use_07_metric=use_07)
    for g, w in zip(again, want):
        np.testing.assert_array_equal(g, w)


def test_pascal_voc_evaluate_detections_matches_jax(voc_root):
    root, gt = voc_root
    timdb = tvoc.pascal_voc("test", "2007")
    jimdb = jvoc.pascal_voc("test", "2007")
    assert timdb.image_index == jimdb.image_index
    assert timdb.classes == jimdb.classes
    all_boxes = _random_all_boxes(timdb, gt, seed=5)
    tmap = timdb.evaluate_detections(all_boxes, str(root / "t"))
    jmap = jimdb.evaluate_detections(all_boxes, str(root / "j"))
    assert tmap == jmap and 0.0 < tmap < 1.0
    for cls in timdb.classes[1:]:
        with open(root / "t" / f"{cls}_pr.pkl", "rb") as f:
            t = pickle.load(f)
        with open(root / "j" / f"{cls}_pr.pkl", "rb") as f:
            j = pickle.load(f)
        assert t["ap"] == j["ap"], cls
        np.testing.assert_array_equal(t["rec"], j["rec"])
        np.testing.assert_array_equal(t["prec"], j["prec"])
    # salted results files are cleaned up
    results = root / "VOCdevkit2007" / "results" / "VOC2007" / "Main"
    assert not os.listdir(results)


def test_ground_truth_as_detections_scores_map_one(voc_root):
    root, _ = voc_root
    imdb = tvoc.pascal_voc("test", "2007")
    all_boxes = [[np.zeros((0, 5), np.float32)
                  for _ in range(imdb.num_images)]
                 for _ in range(imdb.num_classes)]
    for i, entry in enumerate(imdb.roidb):
        for c in range(1, imdb.num_classes):
            boxes = entry["boxes"][entry["gt_classes"] == c]
            all_boxes[c][i] = np.hstack([boxes.astype(np.float32),
                                         np.ones((len(boxes), 1),
                                                 np.float32)])
    assert imdb.evaluate_detections(all_boxes, str(root / "out")) == 1.0


def test_flipped_roidb_widths_from_header_match_jax(voc_root):
    timdb = tvoc.pascal_voc("test", "2007")
    jimdb = jvoc.pascal_voc("test", "2007")
    assert timdb._get_widths() == jimdb._get_widths()
    timdb.append_flipped_images()
    jimdb.append_flipped_images()
    assert len(timdb.roidb) == len(jimdb.roidb) == 16
    for t, j in zip(timdb.roidb, jimdb.roidb):
        np.testing.assert_array_equal(t["boxes"], j["boxes"])
        np.testing.assert_array_equal(t["gt_classes"], j["gt_classes"])
        assert t["flipped"] == j["flipped"]


def test_factory_lists_the_same_imdbs():
    from tf_faster_rcnn_tpu.datasets.factory import list_imdbs as jlist
    assert tlist() == jlist()


# -- COCO ------------------------------------------------------------------

CATS = [{"id": 1, "name": "cat"}, {"id": 3, "name": "bus"},
        {"id": 7, "name": "dog"}]


def _synth_coco(root, seed=0, n_images=5):
    rng = np.random.RandomState(seed)
    ann_dir = osp.join(root, "coco", "annotations")
    os.makedirs(ann_dir, exist_ok=True)
    images, anns = [], []
    for i in range(1, n_images + 1):
        images.append({"id": i, "width": 160, "height": 120,
                       "file_name": f"COCO_val2014_{i:012d}.jpg"})
        for k in range(rng.randint(1, 4)):
            x, y = rng.uniform(0, 100), rng.uniform(0, 70)
            bw, bh = rng.uniform(8, 60), rng.uniform(8, 50)
            anns.append({"id": len(anns) + 1, "image_id": i,
                         "category_id": CATS[rng.randint(3)]["id"],
                         "bbox": [x, y, bw, bh], "area": bw * bh,
                         "iscrowd": int(i == 2 and k == 0)})
    with open(osp.join(ann_dir, "instances_minival2014.json"), "w") as f:
        json.dump({"images": images, "annotations": anns,
                   "categories": CATS}, f)
    return anns


def test_coco_eval_stats_match_jax(tmp_path):
    anns = _synth_coco(str(tmp_path))
    set_both_cfgs(DATA_DIR=str(tmp_path), ROOT_DIR=str(tmp_path))
    timdb = tcoco.coco("minival", "2014")
    jimdb = jcoco.coco("minival", "2014")
    assert timdb.classes == jimdb.classes
    assert timdb._get_widths() == jimdb._get_widths()
    rng = np.random.RandomState(4)
    all_boxes = [[np.zeros((0, 5), np.float32)
                  for _ in range(timdb.num_images)]
                 for _ in range(timdb.num_classes)]
    label = {c["id"]: timdb.classes.index(c["name"]) for c in CATS}
    for a in anns:
        x, y, bw, bh = a["bbox"]
        i = timdb.image_index.index(a["image_id"])
        row = np.array([[x, y, x + bw - 1, y + bh - 1, rng.rand()]],
                       np.float32)
        row[:, :4] += rng.randn(1, 4).astype(np.float32) * 3
        c = label[a["category_id"]] if rng.rand() > 0.2 else label[1]
        all_boxes[c][i] = np.vstack([all_boxes[c][i], row])
    tap = timdb.evaluate_detections(all_boxes, str(tmp_path / "t"))
    jap = jimdb.evaluate_detections(all_boxes, str(tmp_path / "j"))
    assert tap == jap and 0.0 < tap < 1.0
    with open(tmp_path / "j" / "detection_results.pkl", "rb") as f:
        jeval = pickle.load(f)
    with open(tmp_path / "t" / "detection_results.pkl", "rb") as f:
        teval = pickle.load(f)
    assert isinstance(teval, dict)
    np.testing.assert_array_equal(teval["stats"], jeval.stats)
    np.testing.assert_array_equal(teval["precision"], jeval.eval["precision"])
    np.testing.assert_array_equal(teval["recall"], jeval.eval["recall"])


# -- host ops ---------------------------------------------------------------

def test_apply_nms_matches_jax():
    rng = np.random.RandomState(7)
    all_boxes = [[[] for _ in range(4)] for _ in range(3)]
    for c in range(1, 3):
        for i in range(4):
            n = rng.randint(0, 40)
            xy = rng.uniform(0, 80, (n, 2))
            wh = rng.uniform(-3, 40, (n, 2))         # some inverted boxes
            all_boxes[c][i] = np.hstack(
                [xy, xy + wh, rng.rand(n, 1)]).astype(np.float32)
    for thresh in (0.3, 0.7):
        got = tengine.apply_nms(all_boxes, thresh)
        want = jengine.apply_nms(all_boxes, thresh)
        for c in range(3):
            for i in range(4):
                np.testing.assert_array_equal(np.asarray(got[c][i]),
                                              np.asarray(want[c][i]))


def test_native_ops_match_jax():
    rng = np.random.RandomState(2)
    xy = rng.uniform(0, 100, (300, 2))
    dets = np.hstack([xy, xy + rng.uniform(1, 50, (300, 2)),
                      rng.rand(300, 1)]).astype(np.float32)
    for plus_one in (True, False):
        for suppress_eq in (True, False):
            kw = dict(plus_one=plus_one, suppress_eq=suppress_eq)
            np.testing.assert_array_equal(tnative.nms_cpu(dets, 0.5, **kw),
                                          jnative.nms_cpu(dets, 0.5, **kw))
        np.testing.assert_array_equal(
            tnative.bbox_overlaps_cpu(dets[:50, :4], dets[50:90, :4],
                                      plus_one=plus_one),
            jnative.bbox_overlaps_cpu(dets[:50, :4], dets[50:90, :4],
                                      plus_one=plus_one))
    assert tnative.nms_cpu(np.zeros((0, 5), np.float32), 0.5).size == 0
    assert "tf_faster_rcnn_torch" in tnative._LIB_PATH


# -- config ----------------------------------------------------------------

@pytest.mark.parametrize("scales,max_size,canvas,bucketing", [
    ((600,), 1000, [0, 0], True),
    ((96,), 128, [0, 0], True),
    ((600,), 1000, [0, 0], False),
    ((1000,), 1000, [0, 0], True),
    ((600,), 1000, [320, 480], True),
])
def test_canvas_helpers_match_jax(scales, max_size, canvas, bucketing):
    set_both_cfgs(**{"TEST.SCALES": scales, "TEST.MAX_SIZE": max_size,
                     "TPU.CANVAS_SIZE": canvas, "TPU.BUCKETING": bucketing})
    tb = tconfig.canvas_buckets(tconfig.cfg.TEST)
    assert tb == jconfig.canvas_buckets(jconfig.cfg.TEST)
    assert tconfig.canvas_hw(tconfig.cfg.TEST) == \
        jconfig.canvas_hw(jconfig.cfg.TEST)
    for h, w in ((375, 500), (500, 375), (400, 400)):
        assert tconfig.bucket_index(h, w, tb) == \
            jconfig.bucket_index(h, w, tb)


def test_get_output_dir_matches_jax(tmp_path):
    set_both_cfgs(ROOT_DIR=str(tmp_path), EXP_DIR="res101")

    class Named:
        name = "voc_2007_test"
    for weights in ("w.pt", None):
        assert tconfig.get_output_dir(Named, weights) == \
            jconfig.get_output_dir(Named, weights)
    assert osp.isdir(tmp_path / "output" / "res101" / "voc_2007_test"
                     / "default")


def test_upload_on_cpu_shares_memory():
    x = np.arange(6, dtype=np.float32).reshape(2, 3)
    t = tblob.upload(x, "cpu")
    assert t.device.type == "cpu" and t.data_ptr() == x.ctypes.data
    assert torch.equal(t, torch.from_numpy(x))


def test_cached_build_shows_no_half_written_cache(tmp_path, monkeypatch):
    """cached_build writes its pickle under a name of the process's own and
    renames it into place: while the pickle is written the cache's name
    does not exist, so a second process building the same roidb (a
    data-parallel rank) never loads a partial file; nothing else is left."""
    from tf_faster_rcnn_torch.datasets import annotations
    cache = tmp_path / "cache" / "voc_2007_test_gt_roidb.pkl"
    during = []
    dump = pickle.dump

    def watched(obj, f, *args):
        during.append(cache.exists())
        dump(obj, f, *args)
    monkeypatch.setattr(pickle, "dump", watched)
    assert annotations.cached_build(cache, lambda: [{"boxes": 1}]) == [
        {"boxes": 1}]
    assert during == [False]
    assert [p.name for p in cache.parent.iterdir()] == [cache.name]
    again = annotations.cached_build(
        cache, lambda: pytest.fail("a cached roidb was built again"))
    assert again == [{"boxes": 1}]
