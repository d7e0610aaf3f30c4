"""flops.py against torch's FLOP counter on the reference, and the roofline's
needed-test count against a greedy walk that counts its own tests."""

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from frcnn_bench_tiny import tiny
from frcnn_bench.flops import image_flops
from frcnn_bench.reference.model import Reference, param_table, trainable
from frcnn_bench.reference.nms import greedy_keep, iou
from frcnn_bench.roofline import needed_tests
from frcnn_bench.weights import make_weights

H, W = 64, 96


def _setup(name):
    cell = tiny(name, compute_dtype="float32")
    params = make_weights(cell.config, 5, "cpu")
    image = torch.randn(1, H, W, 3) * 50
    info = torch.tensor([[H, W, 1.0]])
    return cell.config, params, image, info


@pytest.mark.parametrize("name", ["res101-voc-detect-b8",
                                  "vgg16-voc-detect-b8"])
def test_test_flops_equal_the_counter(name):
    config, params, image, info = _setup(name)
    ref = Reference(config, params)
    r = config["cfg"]["TEST"]["RPN_POST_NMS_TOP_N"]
    rois = torch.tensor([[[4.0, 6.0, 40.0, 50.0]] * r])
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        feat = ref.head(image, info)
        ref.rpn(feat)
        ref.roi_heads(feat, rois, info, test=True)
    assert counter.get_total_flops() == image_flops(config, H, W, "TEST")


@pytest.mark.parametrize("name", ["res101-voc-train-b8",
                                  "vgg16-voc-detect-b8"])
def test_train_flops_equal_the_counter(name):
    config, params, image, info = _setup(name)
    names = [n for n in param_table(config) if trainable(config, n)]
    for n in names:
        params[n].requires_grad_(True)
    ref = Reference(config, params)
    c = config["cfg"]["TRAIN"]
    gen = torch.Generator().manual_seed(0)
    n_anchors = (H // 16) * (W // 16) * 9
    r = c["RPN_POST_NMS_TOP_N"]
    noise = {k: torch.rand((1, n), generator=gen) for k, n in
             (("anchor_fg", n_anchors), ("anchor_bg", n_anchors),
              ("roi_fg", r), ("roi_bg", r))}
    if config["net"]["family"] == "vgg16":
        noise["dropout"] = tuple(torch.rand((c["BATCH_SIZE"], 4096),
                                            generator=gen) < 0.5
                                 for _ in range(2))
    gt = torch.tensor([[[10.0, 12.0, 50.0, 40.0, 3.0]]])
    rois = torch.tensor([[[8.0, 10.0, 52.0, 44.0], [30, 5, 90, 60]] * (r // 2)])
    with FlopCounterMode(display=False) as counter:
        total, _, _ = ref.train_loss(image, info, gt, torch.ones(1, 1, dtype=bool),
                                     noise, (rois, torch.ones(1, r, dtype=bool)))
        torch.autograd.grad(total, [params[n] for n in names])
    assert counter.get_total_flops() == image_flops(config, H, W, "TRAIN")


def _walk(boxes, valid, thresh, max_keep):
    """Greedy NMS that counts each IoU test it makes: a box against the kept
    boxes before it until one suppresses it; stops at max_keep kept."""
    kept, tests = [], 0
    for i in range(len(boxes)):
        if len(kept) == max_keep:
            break
        if not valid[i]:
            continue
        hit = False
        for j in kept:
            tests += 1
            if float(iou(boxes[j:j + 1], boxes[i:i + 1], False)[0, 0]) > thresh:
                hit = True
                break
        if not hit:
            kept.append(i)
    return tests


@pytest.mark.parametrize("seed,max_keep", [(0, None), (1, 10), (2, 25)])
def test_needed_tests_equal_a_counting_walk(seed, max_keep):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, 100, (2, 80, 2))
    wh = rng.uniform(5, 40, (2, 80, 2))
    boxes = torch.tensor(np.concatenate([xy, xy + wh], -1), dtype=torch.float32)
    valid = torch.tensor(rng.uniform(size=(2, 80)) > 0.1)
    keep = greedy_keep(boxes, valid, 0.4, False)
    got = needed_tests(keep, boxes, valid, 0.4, max_keep=max_keep)
    want = sum(_walk(boxes[g], valid[g], 0.4, max_keep or 10**9)
               for g in range(2))
    assert got == want
