"""The port's NMS (tf_faster_rcnn_torch/ops/nms*.py) against the JAX package.

On the CPU the wrappers run the plain versions of kernels K1 and K2; these
tests hold them to the Pallas kernels in interpret mode, the jnp block NMS
and the native C++ oracle. Tolerance: none, the masks and indices must be
exactly equal. The CUDA kernels themselves are held to the plain versions by
the `cuda`-marked test at the end, on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tf_faster_rcnn_tpu.ops import nms as jnms
from tf_faster_rcnn_tpu.ops.pallas_nms import (pallas_batched_nms_keep,
                                               pallas_nms_keep_mask)
from tf_faster_rcnn_tpu.utils.native import nms_cpu
from tf_faster_rcnn_torch.ops import nms as tnms
from tf_faster_rcnn_torch.ops import nms_kernels as K


def _sorted_boxes(rng, n):
    """tests/test_pallas_nms.py's generator: boxes sorted by a random score."""
    c = rng.uniform(30, 350, (n, 2))
    wh = rng.uniform(10, 90, (n, 2))
    dets = np.concatenate([c - wh / 2, c + wh / 2, rng.rand(n, 1)],
                          axis=1).astype(np.float32)
    order = np.argsort(-dets[:, 4], kind="stable")
    return dets[order, :4]


def _k1(boxes, valid, thresh, **kw):
    return tnms.nms_keep_mask(torch.from_numpy(boxes), torch.from_numpy(valid),
                              thresh, **kw).numpy()


@pytest.mark.parametrize("plus_one,suppress_eq", [
    (False, False), (True, False), (True, True)])
@pytest.mark.parametrize("n", [64, 500, 2048])
def test_k1_plain_matches_pallas(rng, n, plus_one, suppress_eq):
    boxes = _sorted_boxes(rng, n)
    valid = np.ones(n, bool)
    kp = np.asarray(pallas_nms_keep_mask(boxes, valid, 0.5, plus_one=plus_one,
                                         suppress_eq=suppress_eq,
                                         interpret=True))
    kt = _k1(boxes, valid, 0.5, plus_one=plus_one, suppress_eq=suppress_eq)
    np.testing.assert_array_equal(kt, kp)


def test_k1_max_keep_prefix(rng):
    """The first max_keep survivors equal the Pallas early-exit prefix; the
    port also zeroes every later bit (its documented cap)."""
    boxes = _sorted_boxes(rng, 1500)
    valid = np.ones(1500, bool)
    kp = np.asarray(pallas_nms_keep_mask(boxes, valid, 0.5, max_keep=40,
                                         interpret=True))
    kt = _k1(boxes, valid, 0.5, max_keep=40)
    np.testing.assert_array_equal(np.flatnonzero(kt),
                                  np.flatnonzero(kp)[:40])


def test_k1_invalid_stretch(rng):
    boxes = _sorted_boxes(rng, 256)
    valid = np.ones(256, bool)
    valid[50:90] = False
    kp = np.asarray(pallas_nms_keep_mask(boxes, valid, 0.5, interpret=True))
    kt = _k1(boxes, valid, 0.5)
    np.testing.assert_array_equal(kt, kp)
    assert not kt[50:90].any()


@pytest.mark.parametrize("plus_one,suppress_eq", [
    (False, False), (True, False), (True, True)])
def test_k1_n6000_matches_jnp_and_native(rng, plus_one, suppress_eq):
    """The RPN size (N = 6000, IoU 0.7) against the jnp block NMS and the
    C++ oracle (interpret mode is too slow at this size)."""
    n = 6000
    dets = np.concatenate([_sorted_boxes(rng, n),
                           np.linspace(1, 0, n, dtype=np.float32)[:, None]], 1)
    valid = np.ones(n, bool)
    kt = _k1(dets[:, :4], valid, 0.7, plus_one=plus_one,
             suppress_eq=suppress_eq)
    kj = np.asarray(jnms.nms_keep_mask(dets[:, :4], valid, 0.7,
                                       plus_one=plus_one,
                                       suppress_eq=suppress_eq,
                                       use_pallas=False))
    np.testing.assert_array_equal(kt, kj)
    native = nms_cpu(dets, 0.7, plus_one=plus_one, suppress_eq=suppress_eq)
    np.testing.assert_array_equal(np.flatnonzero(kt), np.sort(native))


def test_k1_batched_equals_per_image(rng):
    """One batched call gives each image its own keep mask."""
    b, n = 3, 300
    boxes = np.stack([_sorted_boxes(rng, n) for _ in range(b)])
    valid = rng.rand(b, n) > 0.2
    kt = _k1(boxes, valid, 0.6, max_keep=50)
    for i in range(b):
        np.testing.assert_array_equal(kt[i], _k1(boxes[i], valid[i], 0.6,
                                                 max_keep=50))


@pytest.mark.parametrize("plus_one", [True, False])
def test_k2_plain_matches_pallas(rng, plus_one):
    g, n = 13, 96
    boxes = np.stack([_sorted_boxes(rng, n) for _ in range(g)])
    valid = rng.rand(g, n) > 0.1
    kp = np.asarray(pallas_batched_nms_keep(boxes, valid, 0.4,
                                            plus_one=plus_one,
                                            interpret=True))
    kt = K.batched_nms_keep(torch.from_numpy(boxes), torch.from_numpy(valid),
                            0.4, plus_one=plus_one).numpy()
    np.testing.assert_array_equal(kt, kp)


def test_k2_plain_matches_pallas_grid_tiled(rng):
    """G > 128: the Pallas kernel tiles instances over grid steps."""
    g, n = 300, 64
    boxes = np.stack([_sorted_boxes(rng, n) for _ in range(g)])
    valid = rng.rand(g, n) > 0.1
    kp = np.asarray(pallas_batched_nms_keep(boxes, valid, 0.4,
                                            interpret=True))
    kt = K.batched_nms_keep(torch.from_numpy(boxes), torch.from_numpy(valid),
                            0.4).numpy()
    np.testing.assert_array_equal(kt, kp)


def test_select_top_k_mask_matches_jax(rng):
    for n, k in ((50, 10), (50, 50), (8, 20), (40, 5)):
        mask = rng.rand(n) > 0.6
        ij, vj = jnms.select_top_k_mask(jnp.asarray(mask), k)
        it, vt = tnms.select_top_k_mask(torch.from_numpy(mask), k)
        np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
        np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    empty = np.zeros(12, bool)
    it, vt = tnms.select_top_k_mask(torch.from_numpy(empty), 4)
    assert not vt.any() and (it == 0).all()


@pytest.mark.parametrize("pre_sort_k", [None, 150])
def test_sorted_nms_matches_jax_with_ties(rng, pre_sort_k):
    """Tied scores (including across the pre_sort_k cut and among the
    masked-out boxes) resolve to the lower index in both frameworks."""
    n = 400
    boxes = _sorted_boxes(rng, n)
    perm = rng.permutation(n)
    boxes = boxes[perm]
    scores = np.round(rng.rand(n) * 8).astype(np.float32) / 8  # 9 values
    valid = rng.rand(n) > 0.15
    ij, vj = jnms.sorted_nms(boxes, scores, valid, 0.5, 60,
                             pre_sort_k=pre_sort_k, use_pallas=False)
    it, vt = tnms.sorted_nms(torch.from_numpy(boxes), torch.from_numpy(scores),
                             torch.from_numpy(valid), 0.5, 60,
                             pre_sort_k=pre_sort_k)
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    assert vt.sum() > 10


def test_sorted_nms_batched_equals_per_image(rng):
    b, n = 2, 200
    boxes = np.stack([_sorted_boxes(rng, n) for _ in range(b)])
    scores = rng.rand(b, n).astype(np.float32)
    valid = rng.rand(b, n) > 0.1
    it, vt = tnms.sorted_nms(torch.from_numpy(boxes), torch.from_numpy(scores),
                             torch.from_numpy(valid), 0.7, 30)
    for i in range(b):
        ij, vj = jnms.sorted_nms(boxes[i], scores[i], valid[i], 0.7, 30,
                                 use_pallas=False)
        np.testing.assert_array_equal(vt[i].numpy(), np.asarray(vj))
        np.testing.assert_array_equal(it[i].numpy(), np.asarray(ij))


def test_wrappers_reject_what_the_kernels_do_not_take():
    boxes = torch.zeros(2, 8, 4)
    valid = torch.ones(2, 8, dtype=torch.bool)
    for fn in (K.nms_keep_mask_batched, K.batched_nms_keep):
        with pytest.raises(TypeError):
            fn(boxes.double(), valid, 0.5)
        with pytest.raises(TypeError):
            fn(boxes, valid.to(torch.uint8), 0.5)
        with pytest.raises(ValueError):
            fn(boxes[..., :3], valid, 0.5)
        with pytest.raises(ValueError):
            fn(boxes, valid[:, :4], 0.5)
        with pytest.raises(ValueError):
            fn(boxes.transpose(0, 1), valid.t(), 0.5)
    with pytest.raises(ValueError):
        K.nms_keep_mask_batched(boxes, valid, 0.5, max_keep=0)


def test_cpu_calls_count_no_launch(rng):
    """The counters count kernel launches only: the plain path on CPU
    tensors adds nothing."""
    K.reset_launch_counts()
    boxes = torch.from_numpy(np.stack([_sorted_boxes(rng, 32)] * 2))
    valid = torch.ones(2, 32, dtype=torch.bool)
    K.nms_keep_mask_batched(boxes, valid, 0.5)
    K.batched_nms_keep(boxes, valid, 0.5)
    assert K.launch_counts() == {"nms_keep_mask_batched": 0,
                                 "batched_nms_keep": 0}


@pytest.mark.cuda
def test_kernels_match_plain_on_card(rng):
    """K1 and K2 on the card equal their plain versions on the same inputs,
    and each call launches its kernel once."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine)")
    dev = torch.device("cuda")
    K.reset_launch_counts()
    for n, max_keep in ((500, None), (6000, 300)):
        boxes = torch.from_numpy(
            np.stack([_sorted_boxes(rng, n) for _ in range(2)])).to(dev)
        valid = torch.from_numpy(rng.rand(2, n) > 0.1).to(dev)
        for plus_one, suppress_eq in ((False, False), (True, False),
                                      (True, True)):
            kw = dict(plus_one=plus_one, suppress_eq=suppress_eq)
            got = K.nms_keep_mask_batched(boxes, valid, 0.7,
                                          max_keep=max_keep, **kw)
            want = K.nms_keep_mask_plain(boxes, valid, 0.7,
                                         max_keep=max_keep, **kw)
            torch.cuda.synchronize()
            assert torch.equal(got, want), (n, kw)
    boxes = torch.from_numpy(
        np.stack([_sorted_boxes(rng, 300) for _ in range(160)])).to(dev)
    valid = torch.from_numpy(rng.rand(160, 300) > 0.1).to(dev)
    got = K.batched_nms_keep(boxes, valid, 0.3, plus_one=True)
    want = K.batched_nms_keep_plain(boxes, valid, 0.3, plus_one=True)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert K.launch_counts() == {"nms_keep_mask_batched": 6,
                                 "batched_nms_keep": 1}
