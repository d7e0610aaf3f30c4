"""The port's drills and experiment drivers on the CPU, at toy sizes.

* ``tools/make_synthetic_coco.py`` writes what the JAX tool writes for one
  seed: the same annotation JSON and the same image files, byte for byte.
* ``tools/recipes.py`` holds ``experiments/scripts/recipes.sh``'s table
  (read from bash), its hooks and its tag slug.
* ``tools/test_faster_rcnn.py`` resolves the newest snapshot by its
  numeric iteration; the drivers refuse DEVICES above the GPU count.
* ``tools.test_net --model`` takes a training snapshot of the port
  (``*_iter_N.pt``).
* ``tools.overfit_check --device cpu`` exits 0 at 4 iterations and 2
  images with the gate at 0, having read its AP pickles.
* The COCO rehearsal's chain in process, as the JAX
  ``test_coco_rehearsal_chain_smoke``: synthetic 81-class devkit ->
  train+valminusminival -> 3 train steps -> test_net on minival -> COCOeval.
* The rehearsal through the drivers in subprocesses (``slow``, as the JAX
  ``test_coco_rehearsal_driver_invocation``).
"""

import filecmp
import json
import os
import os.path as osp
import pickle
import subprocess
import sys

import pytest
import torch

from tf_faster_rcnn_torch import config as tconfig
from tf_faster_rcnn_torch.tools import test_faster_rcnn, train_faster_rcnn
from tf_faster_rcnn_torch.tools.make_synthetic_coco import make_synthetic_coco
from tf_faster_rcnn_torch.tools.recipes import RECIPES, recipe, slug

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
TOY_COCO = dict(n_train=4, n_valminusminival=2, n_minival=3, max_gt=8,
                dense_every=3, base_hw=(96, 128))


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(min(before, 2))
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def _port_cfg():
    tconfig.reset_cfg()
    yield
    tconfig.reset_cfg()


def test_make_synthetic_coco_matches_jax_tool(tmp_path):
    sys.path.insert(0, osp.join(REPO, "tools"))
    try:
        import make_synthetic_coco as jtool
    finally:
        sys.path.pop(0)
    ours = make_synthetic_coco(str(tmp_path / "port"), seed=3, **TOY_COCO)
    theirs = jtool.make_synthetic_coco(str(tmp_path / "jax"), seed=3,
                                       **TOY_COCO)
    assert ours == theirs
    cat_ids = [c["id"] for c in ours["train2014"]["categories"]]
    assert len(cat_ids) == 80 and cat_ids != list(range(1, 81))
    assert any(a["iscrowd"] for a in ours["train2014"]["annotations"])
    n_files = 0
    for dirpath, _, files in os.walk(tmp_path / "jax"):
        rel = osp.relpath(dirpath, tmp_path / "jax")
        for name in files:
            assert filecmp.cmp(osp.join(dirpath, name),
                               osp.join(tmp_path / "port", rel, name),
                               shallow=False), (rel, name)
            n_files += 1
    assert n_files == 3 + 4 + 2 + 3     # 3 jsons, 9 images


def _sh_recipe(name, env=None):
    """recipes.sh's variables after `recipe name`, from bash."""
    script = (f". experiments/scripts/recipes.sh && recipe {name} && echo "
              "\"$train_imdb|$test_imdb|$iters|$stepsize|$scales|$ratios|"
              "$num_classes\"")
    out = subprocess.run(["bash", "-c", script], cwd=REPO, text=True,
                         capture_output=True, env=dict(os.environ, **(env or
                                                                      {})))
    return out.returncode, out.stdout.strip()


def test_recipe_table_matches_recipes_sh():
    assert sorted(RECIPES) == ["coco", "pascal_voc", "pascal_voc_0712"]
    for name in RECIPES:
        for hooks, args in (({}, ()),
                            ({"FRCNN_ITERS": "4000",
                              "FRCNN_STEPSIZE": "[1000000000]"},
                             (4000, "[1000000000]"))):
            rc, line = _sh_recipe(name, hooks)
            assert rc == 0, line
            r = recipe(name, *args)
            assert line == "|".join(str(x) for x in r), (name, line, r)
    assert _sh_recipe("imagenet")[0] != 0
    with pytest.raises(SystemExit):
        recipe("imagenet")
    extra = ["TPU.IMS_PER_DEVICE", "8", "TRAIN.SCALES", "(600,)"]
    sh = subprocess.run(
        ["bash", "-c", ". experiments/scripts/recipes.sh && slug \"$@\"",
         "slug"] + extra, cwd=REPO, text=True, capture_output=True)
    assert slug(extra) == sh.stdout.strip()


def test_newest_snapshot_by_numeric_iteration(tmp_path):
    for name in ("res101_faster_rcnn_iter_9.pt",
                 "res101_faster_rcnn_iter_10.pt",
                 "res101_faster_rcnn_iter_9.pkl",
                 "res101_faster_rcnn_best.pt",
                 "res50_faster_rcnn_iter_99.pt"):
        (tmp_path / name).write_bytes(b"")
    got = test_faster_rcnn.newest_snapshot(str(tmp_path), "res101")
    assert osp.basename(got) == "res101_faster_rcnn_iter_10.pt"
    with pytest.raises(SystemExit, match="no snapshots"):
        test_faster_rcnn.newest_snapshot(str(tmp_path), "vgg16")


@pytest.mark.parametrize("driver", [train_faster_rcnn, test_faster_rcnn])
def test_drivers_refuse_more_than_one_device(driver):
    with pytest.raises(SystemExit, match="DEVICES 2"):
        driver.main(["2", "coco", "res101"])


def _mobile_tiny():
    tconfig.cfg_from_list([
        "MOBILENET.DEPTH_MULTIPLIER", "0.25", "ANCHOR_SCALES", "[2,4]",
        "TRAIN.RPN_PRE_NMS_TOP_N", "128", "TRAIN.RPN_POST_NMS_TOP_N", "16",
        "TRAIN.BATCH_SIZE", "16", "TRAIN.RPN_BATCHSIZE", "32"])


def test_test_net_takes_a_training_snapshot(tmp_path):
    """load_model_params on a port snapshot (``*_iter_N.pt``, a
    TrainState with its generator) loads the state's parameters."""
    from tf_faster_rcnn_torch.engine.train import create_train_state
    from tf_faster_rcnn_torch.models.init import reference_init
    from tf_faster_rcnn_torch.models.network import FasterRCNN, spec_from_cfg
    from tf_faster_rcnn_torch.tools.test_net import load_model_params
    from tf_faster_rcnn_torch.utils.checkpoint import snapshot
    _mobile_tiny()
    model = FasterRCNN(spec_from_cfg("mobile", 21, "TRAIN"), device="cpu")
    reference_init(model, torch.Generator().manual_seed(7))
    state = create_train_state(model.spec, model,
                               torch.Generator().manual_seed(1))
    state.step.fill_(12)
    path, _ = snapshot(str(tmp_path), "mobile_faster_rcnn", state,
                       {"cursor": 0})
    assert osp.basename(path) == "mobile_faster_rcnn_iter_12.pt"
    test_model = FasterRCNN(spec_from_cfg("mobile", 21, "TEST"),
                            device="cpu").eval()
    load_model_params(test_model, path, "mobile")
    want = model.state_dict()
    got = test_model.state_dict()
    assert set(got) == set(want)
    for name, t in got.items():
        assert torch.equal(t, want[name]), name


def test_overfit_check_runs_on_the_cpu(tmp_path):
    proc = subprocess.run(
        [sys.executable, "-m", "tf_faster_rcnn_torch.tools.overfit_check",
         "--device", "cpu", "--iters", "4", "--images", "2", "--min-ap", "0",
         "--workdir", str(tmp_path)],
        cwd=REPO, capture_output=True, text=True, timeout=600,
        env=dict(os.environ, OMP_NUM_THREADS="2"))
    tail = proc.stdout[-3000:] + proc.stderr[-3000:]
    assert proc.returncode == 0, tail
    assert "[overfit] PASS (gate 0.0)" in proc.stdout, tail
    present = [c for c in ("aeroplane", "car", "person")
               if f" {c}=" in proc.stdout.splitlines()[-2]]
    assert present, tail
    for cls in present:
        with open(tmp_path / "eval_out" / f"{cls}_pr.pkl", "rb") as f:
            assert 0.0 <= pickle.load(f)["ap"] <= 1.0


def test_coco_rehearsal_chain_smoke(tmp_path, capsys):
    """The rehearsal's engine chain at toy shapes: the 81-class synthetic
    devkit -> combined train+valminusminival roidb -> 3 train steps from
    the JAX package's initializers -> test_net on minival -> results json
    -> COCOeval."""
    from tf_faster_rcnn_torch.datasets.factory import get_imdb
    from tf_faster_rcnn_torch.engine.test_engine import test_net
    from tf_faster_rcnn_torch.engine.train_loop import (get_training_roidb,
                                                        train_net)
    from tf_faster_rcnn_torch.models.network import FasterRCNN, spec_from_cfg
    make_synthetic_coco(str(tmp_path), **TOY_COCO)
    c = tconfig.cfg
    c.DATA_DIR = c.ROOT_DIR = str(tmp_path)
    c.TPU.CANVAS_SIZE = [96, 128]
    c.TPU.MAX_GT = 8
    c.TRAIN.SCALES = c.TEST.SCALES = (64,)
    c.TRAIN.MAX_SIZE = c.TEST.MAX_SIZE = 96
    c.ANCHOR_SCALES = [1, 2, 4]
    c.TEST.RPN_POST_NMS_TOP_N = 32
    c.TEST.RPN_PRE_NMS_TOP_N = 256
    c.TRAIN.RPN_POST_NMS_TOP_N = 48
    c.TRAIN.RPN_PRE_NMS_TOP_N = 256
    c.TRAIN.BATCH_SIZE = 16
    c.TRAIN.RPN_BATCHSIZE = 32
    c.TRAIN.SNAPSHOT_ITERS = 4
    c.TRAIN.DISPLAY = 2
    c.TRAIN.USE_FLIPPED = False
    c.MOBILENET.FIXED_LAYERS = 5
    c.TPU.PREFETCH = 0

    roidb = []
    for name in ("coco_2014_train", "coco_2014_valminusminival"):
        ds = get_imdb(name)
        ds.set_proposal_method("gt")
        roidb.extend(get_training_roidb(ds))
    assert len(roidb) == 6 and ds.num_classes == 81
    state = train_net("mobile", ds, roidb, list(roidb),
                      str(tmp_path / "coco_train_out"),
                      str(tmp_path / "coco_tb"), max_iters=3, device="cpu")
    assert int(state.step) == 3
    assert "MOBILENET.FIXED_LAYERS" in capsys.readouterr().out

    minival = get_imdb("coco_2014_minival")
    spec = spec_from_cfg("mobile", minival.num_classes, "TEST")
    model = FasterRCNN(spec, device="cpu").eval()
    model.load_state_dict(state.model.state_dict(), strict=True)
    eval_dir = str(tmp_path / "coco_eval_out")
    ap = test_net(model, spec, minival, "iter_3", max_per_image=20,
                  batch_size=2, output_dir=eval_dir)
    assert ap is not None and 0.0 <= ap <= 1.0
    with open(osp.join(eval_dir, "detection_results.pkl"), "rb") as f:
        assert float(pickle.load(f)["stats"][0]) == ap


@pytest.mark.slow
def test_coco_rehearsal_driver_invocation(tmp_path):
    """tools.coco_rehearsal through the drivers, each in a subprocess, at
    toy shapes on the CPU: devkit -> train_faster_rcnn (the flags of the
    shell hooks, the recipe's overrides) -> the chained test_faster_rcnn
    (numeric snapshot resolution) -> COCOeval AP, and the record."""
    tiny_sets = [
        "TPU.CANVAS_SIZE", "[96,128]", "TPU.MAX_GT", "8",
        "TRAIN.SCALES", "(64,)", "TRAIN.MAX_SIZE", "96",
        "TEST.SCALES", "(64,)", "TEST.MAX_SIZE", "96",
        "ANCHOR_SCALES", "[2,4]",
        "TRAIN.RPN_PRE_NMS_TOP_N", "256", "TRAIN.RPN_POST_NMS_TOP_N", "48",
        "TEST.RPN_PRE_NMS_TOP_N", "256", "TEST.RPN_POST_NMS_TOP_N", "32",
        "TRAIN.BATCH_SIZE", "16", "TRAIN.RPN_BATCHSIZE", "32",
        "TRAIN.USE_FLIPPED", "False",
    ]
    wd = tmp_path / "wd"
    proc = subprocess.run(
        [sys.executable, "-m", "tf_faster_rcnn_torch.tools.coco_rehearsal",
         "--net", "mobile", "--iters", "4", "--train-images", "4",
         "--val-images", "2", "--max-gt", "8", "--base-hw", "96", "128",
         "--ims-per-device", "2", "--skip-lg", "--min-ap", "0",
         "--device", "cpu", "--workdir", str(wd), "--set"] + tiny_sets,
        cwd=REPO, capture_output=True, text=True, timeout=2400)
    tail = proc.stdout[-3000:] + proc.stderr[-3000:]
    assert proc.returncode == 0, tail
    assert "[rehearsal] PASS" in proc.stdout, tail
    with open(wd / "rehearsal.json") as f:
        record = json.load(f)
    assert record["ok"] and record["steps"] == 2
    assert 0.0 <= record["ap_600"] <= 1.0
