"""The port's training data path against the JAX package's: roidb
preparation and filtering, RoIDataLayer, and the prefetcher's state.

Both layers draw from np.random.RandomState(RNG_SEED), so on the same roidb
they must choose the same images and scales: the iteration state (cursor,
permutation, RNG state) and im_info, gt_boxes and gt_valid exactly equal
after every batch, and the canvases within 1e-4 (the port resizes as cv2
does, within 3e-5 of it; ``tests/test_torch_eval.py``). The mini-VOCs:
``tests/test_pipeline.py``'s JPEG one (landscape only, cv2 decodes it in
both packages) and ``tests/test_torch_datasets.py``'s PPM one with both
orientations, each with its flipped entries appended. The val layer is
time-seeded in both packages and is not compared.
"""

import os.path as osp

import numpy as np
import pytest
import scipy.sparse
import torch

from test_pipeline import _make_voc
from test_torch_datasets import make_voc, set_both_cfgs
from tf_faster_rcnn_tpu import config as jconfig
from tf_faster_rcnn_tpu.data import loader as jloader
from tf_faster_rcnn_tpu.data import roidb as jroidb
from tf_faster_rcnn_tpu.datasets import factory as jfactory
from tf_faster_rcnn_torch import config as tconfig
from tf_faster_rcnn_torch.data import loader as tloader
from tf_faster_rcnn_torch.data import roidb as troidb
from tf_faster_rcnn_torch.datasets import factory as tfactory

CANVAS_TOL = 1e-4
# both orientations fit their buckets (64x96 and 96x64); two scales, so
# every batch's scale draw matters; MAX_GT 2 truncates the 3-object images
LAYER_CFG = {"TRAIN.SCALES": (48, 64), "TRAIN.MAX_SIZE": 96,
             "TPU.MAX_GT": 2}


@pytest.fixture(autouse=True)
def _port_cfg():
    tconfig.reset_cfg()
    yield
    tconfig.reset_cfg()


def _roidbs(root, flipped=True, image_set="trainval"):
    """(JAX roidb, port roidb) of the voc_2007 split under root, prepared
    by each package, with flipped entries appended."""
    out = []
    for factory, roidb_mod in ((jfactory, jroidb), (tfactory, troidb)):
        imdb = factory.get_imdb(f"voc_2007_{image_set}")
        imdb.set_proposal_method("gt")
        if flipped:
            imdb.append_flipped_images()
        roidb_mod.prepare_roidb(imdb)
        out.append(imdb.roidb)
    return out


@pytest.fixture(params=["ppm_both_orientations", "jpeg_landscape"])
def voc(request, tmp_path):
    if request.param == "jpeg_landscape":
        _make_voc(str(tmp_path), "trainval")
        cfg = dict(LAYER_CFG, **{"TRAIN.SCALES": (64, 80),
                                 "TRAIN.MAX_SIZE": 128})
    else:
        make_voc(str(tmp_path), image_set="trainval")
        cfg = LAYER_CFG
    set_both_cfgs(DATA_DIR=str(tmp_path), **cfg)
    return tmp_path


def _assert_state_equal(got, want):
    assert got["cur"] == want["cur"]
    np.testing.assert_array_equal(got["perm"], want["perm"])
    assert got["n_shuffles"] == want["n_shuffles"]
    for a, b in zip(got["rng_state"], want["rng_state"]):
        np.testing.assert_array_equal(a, b)


def _assert_batch_equal(tbatch, jbatch):
    for key in ("im_info", "gt_boxes", "gt_valid", "orig_hw"):
        np.testing.assert_array_equal(tbatch[key].numpy(), jbatch[key],
                                      err_msg=key)
    got, want = tbatch["image"].numpy(), jbatch["image"]
    assert got.shape == want.shape and got.dtype == want.dtype
    err = float(np.abs(got - want).max())
    assert err <= CANVAS_TOL, err


def test_prepare_and_filter_roidb_match(voc):
    jdb, tdb = _roidbs(str(voc))
    assert len(jdb) == len(tdb) and len(tdb) % 2 == 0
    for j, t in zip(jdb, tdb):
        assert (t["image"], t["width"], t["height"], t["flipped"]) == \
            (j["image"], j["width"], j["height"], j["flipped"])
        np.testing.assert_array_equal(t["max_overlaps"], j["max_overlaps"])
        np.testing.assert_array_equal(t["max_classes"], j["max_classes"])
    # an entry without a usable roi is dropped by both
    for db in (jdb, tdb):
        db[1]["max_overlaps"] = np.full_like(db[1]["max_overlaps"], 0.55)
    tconfig.cfg.TRAIN.BG_THRESH_HI = jconfig.cfg.TRAIN.BG_THRESH_HI = 0.5
    tconfig.cfg.TRAIN.FG_THRESH = jconfig.cfg.TRAIN.FG_THRESH = 0.6
    jkept, tkept = jroidb.filter_roidb(jdb), troidb.filter_roidb(tdb)
    assert len(tkept) == len(jkept) == len(jdb) - 1
    assert [e["image"] for e in tkept] == [e["image"] for e in jkept]


@pytest.mark.parametrize("grouping,batch,use_all_gt", [
    (True, 2, True), (False, 3, False), (True, 5, True)])
def test_data_layer_matches_jax(request, voc, grouping, batch, use_all_gt):
    """Several epochs' worth of batches: the same indices (iteration
    state), im_info, gt_boxes and gt_valid, and canvases within 1e-4; a
    crowd box (overlap -1) is left out under USE_ALL_GT False."""
    set_both_cfgs(**{"TRAIN.ASPECT_GROUPING": grouping,
                     "TRAIN.USE_ALL_GT": use_all_gt})
    jdb, tdb = _roidbs(str(voc))
    for db in (jdb, tdb):
        ov = db[0]["gt_overlaps"].toarray()
        ov[0] = -1.0
        db[0]["gt_overlaps"] = scipy.sparse.csr_matrix(ov)
    jlayer = jloader.RoIDataLayer(jdb, batch_size=batch)
    tlayer = tloader.RoIDataLayer(tdb, batch_size=batch, device="cpu")
    _assert_state_equal(tlayer.get_state(), jlayer.get_state())
    canvases = set()
    for _ in range(2 * len(tdb) // batch + 1):
        jbatch, tbatch = jlayer.forward(), tlayer.forward()
        _assert_state_equal(tlayer.get_state(), jlayer.get_state())
        _assert_batch_equal(tbatch, jbatch)
        canvases.add(tuple(tbatch["image"].shape[1:3]))
    assert tlayer.get_state()["n_shuffles"] >= 3
    if grouping and "ppm_both" in request.node.name:
        # pairs of one orientation: a batch of 2 never mixes them
        assert {(64, 96), (96, 64)} <= canvases
        assert batch != 2 or (96, 96) not in canvases


def test_tiny_roidb_wraps_to_a_full_batch(voc):
    jdb, tdb = _roidbs(str(voc))
    jlayer = jloader.RoIDataLayer(jdb[:3], batch_size=4)
    tlayer = tloader.RoIDataLayer(tdb[:3], batch_size=4, device="cpu")
    for _ in range(3):
        jbatch, tbatch = jlayer.forward(), tlayer.forward()
        assert tbatch["image"].shape[0] == 4
        _assert_state_equal(tlayer.get_state(), jlayer.get_state())
        _assert_batch_equal(tbatch, jbatch)


def test_state_round_trip_and_jax_state_continues_in_the_port(voc):
    jdb, tdb = _roidbs(str(voc))
    tlayer = tloader.RoIDataLayer(tdb, batch_size=2, device="cpu")
    tlayer.forward()
    state = tlayer.get_state()
    first = [tlayer.forward() for _ in range(3)]
    tlayer.set_state(state)
    for want in first:
        got = tlayer.forward()
        for key in want:
            assert torch.equal(got[key], want[key]), key

    # a JAX layer's state, mid-epoch, continues identically in the port
    jlayer = jloader.RoIDataLayer(jdb, batch_size=2)
    for _ in range(len(jdb) // 2 + 1):          # past one reshuffle
        jlayer.forward()
    fresh = tloader.RoIDataLayer(tdb, batch_size=2, device="cpu")
    fresh.set_state(jlayer.get_state())
    for _ in range(len(jdb) // 2 + 1):
        _assert_batch_equal(fresh.forward(), jlayer.forward())
        _assert_state_equal(fresh.get_state(), jlayer.get_state())


def test_prefetcher_state_contract(voc):
    """get_state() is the inner state from before the batch handed out;
    set_state() drops what was prefetched from the old state; a worker
    error reaches forward(); close() stops the thread."""
    _, tdb = _roidbs(str(voc))
    plain = tloader.RoIDataLayer(tdb, batch_size=2, device="cpu")
    pre = tloader.PrefetchingDataLayer(
        tloader.RoIDataLayer(tdb, batch_size=2, device="cpu"), depth=2)
    try:
        _assert_state_equal(pre.get_state(), plain.get_state())
        for _ in range(4):
            before = plain.get_state()
            want = plain.forward()
            got = pre.forward()
            _assert_state_equal(pre.get_state(), before)
            for key in want:
                assert torch.equal(got[key], want[key]), key
        # resume from the snapshot state replays the batch handed out last
        state = pre.get_state()
        pre.set_state(state)
        _assert_state_equal(pre.get_state(), state)
        plain.set_state(state)
        for _ in range(3):
            want, got = plain.forward(), pre.forward()
            for key in want:
                assert torch.equal(got[key], want[key]), key
    finally:
        pre.close()
    assert not pre._thread.is_alive()

    broken = [dict(e, image=osp.join(str(voc), "missing.jpg")) for e in tdb]
    pre = tloader.PrefetchingDataLayer(
        tloader.RoIDataLayer(broken, batch_size=2, device="cpu"), depth=1)
    try:
        with pytest.raises(RuntimeError, match="prefetch thread failed"):
            pre.forward()
    finally:
        pre.close()
    assert not pre._thread.is_alive()
