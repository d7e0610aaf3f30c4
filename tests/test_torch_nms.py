"""The port's NMS (tf_faster_rcnn_torch/ops/nms*.py) against the JAX package.

On the CPU the wrappers run the plain versions of kernels K1 and K2 (the
``cpu`` implementations of the operators frcnn::nms_keep_mask and
frcnn::batched_nms_keep); these tests hold them, and the operators called
directly, to the Pallas kernels in interpret mode, the jnp block NMS and the
native C++ oracle, check the operators with torch.library.opcheck, and
export them as one graph node each. Tolerance: none, the masks and indices
must be exactly equal. The CUDA engine's algorithm (csrc/nms.cu) is
emulated in numpy and held exactly to the plain K1 here; the CUDA kernels
themselves are held to the plain versions by the `cuda`-marked test at the
end, on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from tf_faster_rcnn_tpu.ops import nms as jnms
from tf_faster_rcnn_tpu.ops.pallas_nms import (pallas_batched_nms_keep,
                                               pallas_nms_keep_mask)
from tf_faster_rcnn_tpu.utils.native import nms_cpu
from tf_faster_rcnn_torch.ops import nms as tnms
from tf_faster_rcnn_torch.ops.boxes import bbox_overlaps
from tf_faster_rcnn_torch.ops import nms_kernels as K

K1_OP = torch.ops.frcnn.nms_keep_mask.default
K2_OP = torch.ops.frcnn.batched_nms_keep.default

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
    port also zeroes every later bit (its documented cap). The operator,
    called directly on a batch of one, takes the cap as is and N + 1 for
    none."""
    boxes = _sorted_boxes(rng, 1500)
    valid = np.ones(1500, bool)
    kp = np.asarray(pallas_nms_keep_mask(boxes, valid, 0.5, max_keep=40,
                                         interpret=True))
    kt = _k1(boxes, valid, 0.5, max_keep=40)
    np.testing.assert_array_equal(np.flatnonzero(kt),
                                  np.flatnonzero(kp)[:40])
    args = (torch.from_numpy(boxes[None]), torch.from_numpy(valid[None]), 0.5,
            False, False)
    np.testing.assert_array_equal(K1_OP(*args, 40)[0].numpy(), kt)
    np.testing.assert_array_equal(K1_OP(*args, 1501)[0].numpy(),
                                  _k1(boxes, valid, 0.5))


def test_k1_invalid_stretch(rng):
    boxes = _sorted_boxes(rng, 256)
    valid = np.ones(256, bool)
    valid[50:90] = False
    kp = np.asarray(pallas_nms_keep_mask(boxes, valid, 0.5, interpret=True))
    kt = _k1(boxes, valid, 0.5)
    np.testing.assert_array_equal(kt, kp)
    assert not kt[50:90].any()
    got = K1_OP(torch.from_numpy(np.stack([boxes] * 2)),
                torch.from_numpy(np.stack([valid, np.ones(256, bool)])), 0.5,
                False, False, 257)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got[0].numpy(), kp)
    np.testing.assert_array_equal(got[1].numpy(),
                                  _k1(boxes, np.ones(256, bool), 0.5))


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
    got = K2_OP(torch.from_numpy(boxes), torch.from_numpy(valid), 0.4,
                plus_one, False)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), kp)


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


@pytest.mark.parametrize("op,extra", [(K1_OP, (False, False, 9)),
                                      (K1_OP, (True, True, 41)),
                                      (K2_OP, (True, False)),
                                      (K2_OP, (False, True))])
def test_opcheck(rng, op, extra):
    """torch.library.opcheck on each operator: its schema, its fake
    implementation against the real one, and its registration for
    tracing."""
    boxes = torch.from_numpy(np.stack([_sorted_boxes(rng, 40)] * 3))
    valid = torch.from_numpy(rng.rand(3, 40) > 0.2)
    torch.library.opcheck(op, (boxes, valid, 0.5) + extra)


def test_ops_trace_as_one_node_each(rng):
    """torch.export of the two wrappers records one operator node each, on
    fake tensors (no data pointer is read while tracing)."""
    class Both(torch.nn.Module):
        def forward(self, boxes, valid):
            return (K.nms_keep_mask_batched(boxes, valid, 0.7, max_keep=10),
                    K.batched_nms_keep(boxes, valid, 0.3, plus_one=True))

    boxes = torch.from_numpy(np.stack([_sorted_boxes(rng, 50)] * 2))
    valid = torch.ones(2, 50, dtype=torch.bool)
    ep = torch.export.export(Both(), (boxes, valid))
    targets = [n.target for n in ep.graph.nodes if n.op == "call_function"]
    assert targets.count(K1_OP) == 1 and targets.count(K2_OP) == 1
    assert len(targets) == 2
    for got, want in zip(ep.module()(boxes, valid),
                         (K.nms_keep_mask_plain(boxes, valid, 0.7,
                                                max_keep=10),
                          K.batched_nms_keep_plain(boxes, valid, 0.3,
                                                   plus_one=True))):
        assert torch.equal(got, want)


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


def _emulated_threshold(thresh, suppress_eq):
    """The kernel's Threshold (csrc/nms.cu): `iou over thresh` as
    fl(q) > T, decided by the rounding boundary m of T when 0 <= T < FLT_MAX,
    else by the division."""
    t = np.float32(thresh)
    big = np.float32(np.finfo(np.float32).max)
    tt = np.nextafter(t, np.float32(-np.inf)) if suppress_eq else t
    th = dict(t=t, eq=suppress_eq, zero_over=bool(0 >= t if suppress_eq
                                                  else 0 > t),
              exact=bool(0 <= tt < big))
    if th["exact"]:
        u = np.nextafter(tt, np.float32(np.inf))
        th["m"] = (np.float64(tt) + np.float64(u)) / 2
        th["tie_up"] = int(np.array(u).view(np.uint32)) % 2 == 0
    return th


def _emulated_over(inter, uni, th):
    """`fl(inter / uni) over thresh` where inter > 0 and uni > 0, decided as
    the kernel decides it: without the division, by the exact test on m; or
    by the division where the threshold admits no such test."""
    if not th["exact"]:
        with np.errstate(divide="ignore", invalid="ignore"):
            iou = inter / np.where(uni > 0, uni, np.float32(1))
        return iou >= th["t"] if th["eq"] else iou > th["t"]
    p = th["m"] * uni.astype(np.float64)
    q = inter.astype(np.float64)
    return (q > p) | ((q == p) & th["tie_up"])


def _emulated_suppresses(a, aa, b, ab, e, th):
    """[M, K] bool: box a_i suppresses box b_j, the kernel's float32 IoU
    operation for operation, with its quick reject: a pair with no
    intersection, or no positive union, is over the threshold only where an
    IoU of 0 is."""
    iw = np.maximum(np.minimum(a[:, None, 2], b[None, :, 2])
                    - np.maximum(a[:, None, 0], b[None, :, 0]) + e,
                    np.float32(0))
    ih = np.maximum(np.minimum(a[:, None, 3], b[None, :, 3])
                    - np.maximum(a[:, None, 1], b[None, :, 1]) + e,
                    np.float32(0))
    inter = iw * ih
    uni = aa[:, None] + ab[None, :] - inter
    live = (inter > 0) & (uni > 0)
    return np.where(live, _emulated_over(inter, uni, th), th["zero_over"])


def _emulated_k1(boxes, valid, thresh, plus_one, suppress_eq, max_keep):
    """The CUDA engine's algorithm for one instance, in numpy: 64-box row
    blocks in order; each valid box of block j is tested against the boxes
    kept so far (a hit sets its `removed` bit), a surviving box c gets its
    in-block mask sup[c] (the boxes t < c of the block that suppress it),
    and the block resolves to the fixed point of a = cand & ~(sup^T a),
    cand = valid & ~removed, iterated from a = cand; its first
    max_keep - total boxes join the kept list; after the cap, keep is 0."""
    n = boxes.shape[0]
    nb = -(-n // 64)
    e = np.float32(1 if plus_one else 0)
    box = np.zeros((nb * 64, 4), np.float32)
    box[:n] = boxes
    ok = np.zeros(nb * 64, bool)
    ok[:n] = valid
    area = (box[:, 2] - box[:, 0] + e) * (box[:, 3] - box[:, 1] + e)
    th = _emulated_threshold(thresh, suppress_eq)
    keep = np.zeros(nb * 64, bool)
    kept_idx = np.zeros(0, np.int64)
    cap = n + 1 if max_keep is None else max_keep
    before = np.tril(np.ones((64, 64), bool), -1)      # [c, t]: t < c
    for j in range(nb):
        rows = slice(64 * j, 64 * j + 64)
        removed = np.zeros(64, bool)
        if len(kept_idx):
            removed = _emulated_suppresses(box[kept_idx], area[kept_idx],
                                           box[rows], area[rows], e,
                                           th).any(0)
        cand = ok[rows] & ~removed
        sup = _emulated_suppresses(box[rows], area[rows], box[rows],
                                   area[rows], e, th).T & before
        a = cand.copy()
        while True:
            nxt = cand & ~(sup & a[None, :]).any(1)
            if (nxt == a).all():
                break
            a = nxt
        room = cap - len(kept_idx)
        a &= np.cumsum(a) <= room
        keep[rows] = a
        kept_idx = np.concatenate([kept_idx, np.flatnonzero(a) + 64 * j])
        if len(kept_idx) >= cap:
            break
    return keep[:n]


@pytest.mark.parametrize("max_keep", [None, 40])
@pytest.mark.parametrize("plus_one,suppress_eq", [
    (False, False), (True, False), (True, True)])
@pytest.mark.parametrize("n", [64, 500, 2048, 6000])
def test_emulated_kernel_matches_plain(rng, n, plus_one, suppress_eq,
                                       max_keep):
    """The CUDA engine's algorithm, emulated in numpy, equals the plain K1
    exactly, with an invalid stretch in the second image."""
    boxes = np.stack([_sorted_boxes(rng, n) for _ in range(2)])
    valid = np.ones((2, n), bool)
    valid[1, n // 8:n // 4] = False
    kw = dict(plus_one=plus_one, suppress_eq=suppress_eq)
    want = K.nms_keep_mask_plain(torch.from_numpy(boxes),
                                 torch.from_numpy(valid), 0.5,
                                 max_keep=max_keep, **kw).numpy()
    for i in range(2):
        got = _emulated_k1(boxes[i], valid[i], 0.5, max_keep=max_keep, **kw)
        np.testing.assert_array_equal(got, want[i])


@pytest.mark.parametrize("case", range(len(chip_smoke.edge_cases(
    np.random.RandomState(0)))))
def test_emulated_kernel_matches_plain_on_edge_cases(case):
    """chip_smoke.py's edge cases (shared edges, degenerate boxes, the
    depth-N chain, thresh 0 with >=): emulation and plain K1 equal."""
    name, boxes, valid, thresh, plus_one, suppress_eq = chip_smoke.edge_cases(
        np.random.RandomState(0))[case]
    kw = dict(plus_one=plus_one, suppress_eq=suppress_eq)
    for max_keep in (None, 40):
        want = K.nms_keep_mask_plain(torch.from_numpy(boxes),
                                     torch.from_numpy(valid), thresh,
                                     max_keep=max_keep, **kw).numpy()
        for i in range(len(boxes)):
            got = _emulated_k1(boxes[i], valid[i], thresh, max_keep=max_keep,
                               **kw)
            np.testing.assert_array_equal(got, want[i], err_msg=name)


@pytest.mark.parametrize("thresh", [0.7, 0.3, 0.5, 0.01, 1e-30])
@pytest.mark.parametrize("eq", [False, True])
def test_emulated_threshold_is_the_division_at_the_boundary(thresh, eq):
    """The division-free decision (the test on m) equals fl(inter / uni)
    compared with the threshold: quotients on, just below and just above
    each float near the threshold, at unions from 1e-38 to 1e6, and random
    pairs across the same range."""
    th = _emulated_threshold(thresh, eq)
    t = np.float32(thresh)
    near = [t]
    for _ in range(3):
        near = [np.nextafter(near[0], np.float32(0))] + near + [
            np.nextafter(near[-1], np.float32(1))]
    uni = np.concatenate([np.float32(np.arange(1, 5000, 7)),
                          np.float32(10.0 ** np.arange(-38, 7))])
    for v in near:
        inter = (uni * v).astype(np.float32)
        for delta in (-1, 0, 1):
            x = np.nextafter(inter, np.float32(delta * np.inf)) \
                if delta else inter
            x = np.minimum(x, uni)
            live = x > 0
            iou = x[live] / uni[live]
            want = iou >= t if eq else iou > t
            np.testing.assert_array_equal(
                _emulated_over(x[live], uni[live], th), want)
    rng = np.random.RandomState(7)
    uni = np.float32(10.0 ** rng.uniform(-38, 6, 100000))
    x = np.float32(uni * rng.uniform(0, 1, uni.shape))
    live = x > 0
    iou = x[live] / uni[live]
    np.testing.assert_array_equal(_emulated_over(x[live], uni[live], th),
                                  iou >= t if eq else iou > t)


@pytest.mark.parametrize("n,max_keep,plus_one,suppress_eq", [
    (200, None, True, False), (300, 20, False, False), (150, 7, True, True)])
def test_needed_tests_counts_the_greedy_walk(rng, n, max_keep, plus_one,
                                             suppress_eq):
    """chip_smoke.needed_tests, the work its bound counts, equals a greedy
    walk that tests each valid box against the kept boxes in order, stops
    at the first suppressor, and stops at max_keep survivors."""
    boxes = torch.from_numpy(np.stack([_sorted_boxes(rng, n)
                                       for _ in range(3)]))
    valid = torch.from_numpy(rng.rand(3, n) > 0.1)
    kw = dict(plus_one=plus_one, suppress_eq=suppress_eq)
    keep = K.nms_keep_mask_plain(boxes, valid, 0.5, max_keep=max_keep, **kw)
    thresh = torch.tensor(0.5)
    want = 0
    for g in range(3):
        kept = []
        for i in range(n):
            if max_keep is not None and len(kept) == max_keep:
                break
            if not valid[g, i]:
                continue
            iou = bbox_overlaps(boxes[g, kept], boxes[g, i:i + 1], plus_one)
            over = (iou >= thresh if suppress_eq else iou > thresh)[:, 0]
            hits = torch.nonzero(over).flatten().tolist()
            want += hits[0] + 1 if hits else len(kept)
            if not hits:
                kept.append(i)
        assert torch.nonzero(keep[g]).flatten().tolist() == kept
    assert chip_smoke.needed_tests(keep, boxes, valid, 0.5,
                                   max_keep=max_keep, **kw) == want


@pytest.mark.cuda
def test_kernels_match_plain_on_card(rng):
    """K1 and K2 on the card equal their plain versions on the same inputs,
    with the edge cases of chip_smoke.py, K1 at the TRAIN shape and K2 at the
    COCO shape; each call launches its kernel once."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine)")
    dev = torch.device("cuda")
    K.reset_launch_counts()
    calls = {"nms_keep_mask_batched": 0, "batched_nms_keep": 0}

    def same(kernel, plain, *args, **kw):
        calls[kernel.__name__] += 1
        got = kernel(*args, **kw)
        torch.cuda.synchronize()
        assert torch.equal(got, plain(*args, **kw)), (args[0].shape, kw)

    k1 = (K.nms_keep_mask_batched, K.nms_keep_mask_plain)
    k2 = (K.batched_nms_keep, K.batched_nms_keep_plain)
    for n, max_keep in ((500, None), (6000, 300)):
        boxes = torch.from_numpy(
            np.stack([_sorted_boxes(rng, n) for _ in range(2)])).to(dev)
        valid = torch.from_numpy(rng.rand(2, n) > 0.1).to(dev)
        for plus_one, suppress_eq in ((False, False), (True, False),
                                      (True, True)):
            same(*k1, boxes, valid, 0.7, max_keep=max_keep,
                 plus_one=plus_one, suppress_eq=suppress_eq)
    boxes = torch.from_numpy(
        np.stack([_sorted_boxes(rng, 300) for _ in range(160)])).to(dev)
    valid = torch.from_numpy(rng.rand(160, 300) > 0.1).to(dev)
    same(*k2, boxes, valid, 0.3, plus_one=True)
    for name, boxes, valid, thresh, plus_one, suppress_eq in \
            chip_smoke.edge_cases(rng):
        boxes, valid = torch.from_numpy(boxes).to(dev), \
            torch.from_numpy(valid).to(dev)
        kw = dict(plus_one=plus_one, suppress_eq=suppress_eq)
        for max_keep in (None, 40):
            same(*k1, boxes, valid, thresh, max_keep=max_keep, **kw)
        if boxes.shape[1] <= 1000:
            same(*k2, boxes, valid, thresh, **kw)
    same(*k1, *chip_smoke.train_shape_inputs(dev), 0.7, max_keep=2000)
    same(*k2, *chip_smoke.coco_shape_inputs(dev), 0.3, plus_one=True)
    assert K.launch_counts() == calls
