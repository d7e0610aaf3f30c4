"""The port's serving path (utils/serving.py, tools/export_model.py,
tools/serve.py, tools/demo.py) on the CPU, at the size of
``test_torch_eval.py``: mobile at depth multiplier 0.25 with its weights
(seed 3, bridged from the JAX package's), TEST.SCALES (96,), MAX_SIZE 128,
both orientation buckets, batch 2.

One bundle is exported per module run, by ``tools.export_model --device cpu
--verify`` in process, and loaded once. It must:

* round trip: both buckets written, the manifest's keys, the CLI's own
  verify, and every mini-VOC batch through the reloaded programs equal to
  the live ``make_detect_fn`` bit for bit;
* match the JAX package's ``make_detect_fn`` on the same numpy inputs:
  class ids and the valid mask exact, boxes within 1e-3, scores within 1e-5
  (test_torch_eval.py's tolerances), behind its separation guard;
* stand alone: its outputs do not change with the port's cfg, and serve
  loads and runs it in a process that imports neither JAX nor the port's
  models, engine or config;
* refuse a foreign directory, and a cuda bundle where there is no CUDA;
* hold K1 and K2 as one graph node each, with no unrolled plain loop.

The CLIs: serve, in a fresh process, over mixed-orientation PPM and JPEG
images writes the live step's rows; the demo (given the small settings as a
``--cfg`` file) over its generated images writes im_detect's rows at
or above its threshold (lowered here, since random weights score below the
demo's 0.8), and its figures. TEST.MODE 'top' (one canvas) bakes its pad
indices and equals the live path.
"""

import contextlib
import dataclasses
import io
import json
import os
import os.path as osp
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
import yaml

from test_torch_datasets import make_voc
from test_torch_eval import (MAX_PER_IMAGE, NET_CFG, REPO,  # noqa: F401
                             _fg, _set_list, mobile)
from tf_faster_rcnn_tpu.engine import test_engine as jengine
from tf_faster_rcnn_torch import config as tconfig
from tf_faster_rcnn_torch.data import blob as tblob
from tf_faster_rcnn_torch.datasets.pascal_voc import VOC_CLASSES
from tf_faster_rcnn_torch.engine import test_engine as tengine
from tf_faster_rcnn_torch.ops import nms_kernels as K
from tf_faster_rcnn_torch.tools import demo as tdemo
from tf_faster_rcnn_torch.tools import export_model as texport
from tf_faster_rcnn_torch.utils import checkpoint as tckpt
from tf_faster_rcnn_torch.utils import serving as tserving

BATCH = 2
BUCKETS = ((96, 128), (128, 96))


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two intra-op threads, as test_torch_eval.py runs them."""
    before = torch.get_num_threads()
    torch.set_num_threads(min(before, 2))
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def _port_cfg():
    tconfig.reset_cfg()
    yield
    tconfig.reset_cfg()


@pytest.fixture(scope="module")
def bundle(tmp_path_factory, mobile):
    """(root, weights path, bundle dir, manifest, CLI output, the load of
    the CLI's --verify): the bundle of mobile's weights, from
    tools.export_model --device cpu --verify."""
    root = tmp_path_factory.mktemp("serving")
    weights = str(root / "mobile.pt")
    tckpt.save_params(weights, mobile[4])
    out_dir = str(root / "bundle")
    printed = io.StringIO()
    loads = []

    def load_detect(path):
        loads.append(tserving.load_detect(path))
        return loads[-1]

    tconfig.reset_cfg()
    try:
        with contextlib.redirect_stdout(printed), \
                pytest.MonkeyPatch.context() as mp:
            mp.setattr(texport, "load_detect", load_detect)
            manifest = texport.main(
                ["--net", "mobile", "--model", weights, "--out", out_dir,
                 "--batch", str(BATCH), "--device", "cpu", "--verify",
                 "--set"] + _set_list(root))
    finally:
        tconfig.reset_cfg()
    assert len(loads) == 1
    return root, weights, out_dir, manifest, printed.getvalue(), loads[0]


@pytest.fixture(scope="module")
def loaded(bundle):
    """(manifest, {bucket: program}) as load_detect gave them to the
    CLI's --verify."""
    return bundle[5]


@pytest.fixture(scope="module")
def voc_batches(tmp_path_factory, bundle):
    """The mini-VOC's 8 images (5 landscape, 3 portrait) as the batches
    serve and test_net run them: (bucket, paths, (image, im_info,
    orig_hw)), each bucket's tail repeating its last image."""
    root = tmp_path_factory.mktemp("voc")
    make_voc(str(root))
    jpegs = root / "VOCdevkit2007" / "VOC2007" / "JPEGImages"
    paths = sorted(str(p) for p in jpegs.iterdir())
    return _batches(paths, bundle[3])


def _batches(paths, manifest):
    means = torch.tensor(manifest["pixel_means"], dtype=torch.float32)
    groups = {}
    for p in paths:
        h, w = tblob.image_size(p)
        groups.setdefault(BUCKETS[0] if w >= h else BUCKETS[1], []).append(p)
    out = []
    for bucket, group in groups.items():
        for i in range(0, len(group), BATCH):
            chunk = group[i:i + BATCH]
            ims = [tblob.read_image_bgr(p) for p in chunk]
            ims += ims[-1:] * (BATCH - len(chunk))
            out.append((bucket, chunk, tblob.prep_batch(
                ims, bucket, "cpu", [96] * BATCH, 128, means)))
    return out


def _write_cfg(path, root):
    """The settings of _set_list as a YAML file, for a CLI's --cfg."""
    tree = {"DATA_DIR": str(root), "ROOT_DIR": str(root)}
    for key, value in NET_CFG.items():
        *parents, leaf = key.split(".")
        node = tree
        for name in parents:
            node = node.setdefault(name, {})
        node[leaf] = list(value) if isinstance(value, tuple) else value
    with open(path, "w") as f:
        yaml.safe_dump(tree, f)


def _live(mobile):
    return tengine.make_detect_fn(mobile[4], mobile[3], MAX_PER_IMAGE, 0.0)


def test_export_model_cli_writes_and_verifies(bundle):
    _, _, out_dir, manifest, printed, (_, fns) = bundle
    assert sorted(os.listdir(out_dir)) == [
        "detect_128x96.pt2", "detect_96x128.pt2", "manifest.json",
        "params.pt"]
    with open(osp.join(out_dir, "manifest.json")) as f:
        assert json.load(f) == manifest
    assert set(manifest) == {
        "format", "net", "device", "nms_kernels", "num_classes", "batch",
        "max_per_image", "nms_thresh", "transfer_dtype", "scales",
        "max_size", "pixel_means", "artifacts"}
    assert manifest["format"] == "tf_faster_rcnn_torch.detect/1"
    assert (manifest["net"], manifest["device"], manifest["nms_kernels"]) \
        == ("mobile", "cpu", False)
    assert (manifest["num_classes"], manifest["batch"],
            manifest["max_per_image"], manifest["nms_thresh"],
            manifest["transfer_dtype"], manifest["scales"],
            manifest["max_size"]) == (21, BATCH, 100, 0.3, "float32", [96],
                                      128)
    np.testing.assert_array_equal(manifest["pixel_means"],
                                  np.asarray(tconfig.cfg.PIXEL_MEANS)
                                  .reshape(3))
    assert manifest["artifacts"] == [
        {"canvas": list(c), "file": f"detect_{c[0]}x{c[1]}.pt2",
         "image_shape": [BATCH, c[0], c[1], 3], "space_to_depth": False}
        for c in BUCKETS]
    for c in BUCKETS:
        assert f"verified detect_{c[0]}x{c[1]}.pt2: exported == live" \
            in printed
    # the parameters are in params.pt, once, and not in the programs
    params = torch.load(osp.join(out_dir, "params.pt"), weights_only=True)
    assert list(params) == list(tckpt.load_params(bundle[1]))
    for fn in fns.values():
        program = fn.args[0]
        assert not list(program.parameters())
        assert sum(t.numel() for t in program.buffers()) < 100


def test_bundle_equals_live(loaded, mobile, voc_batches):
    _, fns = loaded
    live = _live(mobile)
    assert sorted(fns) == sorted(BUCKETS)
    assert [b for b, _, _ in voc_batches] == [BUCKETS[0]] * 3 + \
        [BUCKETS[1]] * 2
    for bucket, _, inputs in voc_batches:
        got, want = fns[bucket](*inputs), live(*inputs)
        for g, w in zip(got, want, strict=True):
            assert g.dtype == w.dtype and torch.equal(g, w), bucket
        assert got[1].sum() > 0


def test_bundle_matches_jax(loaded, mobile, voc_batches):
    jspec, jmodel, params, tspec, tmodel = mobile
    _, fns = loaded
    jdetect = jengine.make_detect_fn(jmodel, jspec, MAX_PER_IMAGE, 0.0)
    japply = jax.jit(jmodel.apply)
    k = tspec.rpn_post_nms_top_n
    for bucket, _, inputs in voc_batches:
        image, im_info, orig_hw = (t.numpy() for t in inputs)
        # the separation guard of test_test_net_matches_jax: the top RPN
        # scores lie apart by more than 100x the frameworks' disagreement
        jfg = _fg(japply(params, image, im_info)["rpn_cls_score"])
        with torch.no_grad():
            tfg = _fg(tmodel(*inputs[:2])["rpn_cls_score"])
        disagreement = float(np.abs(jfg - tfg).max())
        for b in range(BATCH):
            gap = float(np.min(-np.diff(np.sort(jfg[b])[::-1][:k])))
            assert gap > 100 * disagreement, (bucket, b, gap, disagreement)

        det, dv = (t.numpy() for t in fns[bucket](*inputs))
        jdet, jdv = (np.asarray(a) for a in jdetect(params, image, im_info,
                                                    orig_hw))
        np.testing.assert_array_equal(dv, jdv)
        np.testing.assert_array_equal(det[..., 0], jdet[..., 0])
        np.testing.assert_allclose(det[..., 2:], jdet[..., 2:], rtol=0,
                                   atol=1e-3)
        np.testing.assert_allclose(det[..., 1], jdet[..., 1], rtol=0,
                                   atol=1e-5)


def test_bundle_ignores_the_port_cfg(loaded, mobile, voc_batches):
    """After TEST.NMS and TPU.MAX_PER_IMAGE change, the programs still run
    the exported settings."""
    live = _live(mobile)
    tconfig.cfg.TEST.NMS = 0.9
    tconfig.cfg.TPU.MAX_PER_IMAGE = 5
    _, fns = loaded
    for bucket, _, inputs in voc_batches[2:4]:
        det, dv = fns[bucket](*inputs)
        assert det.shape == (BATCH, MAX_PER_IMAGE, 6)
        assert torch.equal(det, live(*inputs)[0])


def test_load_refuses_foreign_and_cuda_dirs(bundle, tmp_path, monkeypatch):
    with pytest.raises(ValueError, match="not a detect export dir"):
        tserving.load_detect(str(tmp_path))
    with open(tmp_path / "manifest.json", "w") as f:
        json.dump({"format": "tf_faster_rcnn_tpu.detect/1"}, f)
    with pytest.raises(ValueError, match="not a detect export dir"):
        tserving.load_detect(str(tmp_path))
    cuda_dir = tmp_path / "cuda"
    shutil.copytree(bundle[2], cuda_dir)
    with open(cuda_dir / "manifest.json") as f:
        manifest = json.load(f)
    manifest.update(device="cuda", nms_kernels=True)
    with open(cuda_dir / "manifest.json", "w") as f:
        json.dump(manifest, f)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tserving.load_detect(str(cuda_dir))


def test_exported_graph_holds_each_kernel_once(loaded):
    """K1 and K2 are one node each in every program: their plain versions'
    loops (one step per box or row block) were not unrolled into it."""
    _, fns = loaded
    ops = (torch.ops.frcnn.nms_keep_mask.default,
           torch.ops.frcnn.batched_nms_keep.default)
    for bucket, fn in fns.items():
        nodes = list(fn.args[0].graph.nodes)
        assert [sum(n.target is op for n in nodes) for op in ops] == [1, 1], \
            bucket


def test_exported_program_counts_launches_in_the_op(loaded, voc_batches,
                                                    monkeypatch):
    """A program's K1 and K2 nodes reach the ops' device implementation:
    on a CPU tensor the plain version, counted by no launch."""
    _, fns = loaded
    calls = []
    for name in ("nms_keep_mask_plain", "batched_nms_keep_plain"):
        real = getattr(K, name)
        monkeypatch.setattr(K, name, lambda *a, _r=real, _n=name, **kw: (
            calls.append(_n), _r(*a, **kw))[1])
    K.reset_launch_counts()
    bucket, _, inputs = voc_batches[0]
    fns[bucket](*inputs)
    assert calls == ["nms_keep_mask_plain", "batched_nms_keep_plain"]
    assert K.launch_counts() == {"nms_keep_mask_batched": 0,
                                 "batched_nms_keep": 0}


def test_serve_cli_matches_live(bundle, mobile, tmp_path):
    """serve, in a fresh process, over PPM and JPEG images of both
    orientations, out of order, three per bucket (a padded tail each): its
    JSON holds the live step's rows at or above --thresh, and the process
    loaded and ran the bundle with no JAX and none of the port's models,
    engine or config in sys.modules."""
    import cv2
    rng = np.random.RandomState(5)
    paths = []
    for i, hw in enumerate(((75, 100), (100, 75), (80, 100), (90, 72),
                            (75, 100), (100, 80))):
        im = rng.randint(0, 60, hw + (3,)).astype(np.uint8)
        im[10:40, 20:50] = rng.randint(150, 255, 3)
        path = str(tmp_path / f"im{i}.{'jpg' if i % 2 else 'ppm'}")
        if i % 2:
            cv2.imwrite(path, im)
        else:
            tblob.write_ppm(path, im)
        paths.append(path)
    out_json = str(tmp_path / "serve.json")
    scores = []
    want = {}
    live = _live(mobile)
    for _, chunk, inputs in _batches(paths, bundle[3]):
        det, dv = live(*inputs)
        scores += det[dv][:, 1].tolist()
        want.update({p: (det[j], dv[j]) for j, p in enumerate(chunk)})
    thresh = float(np.median(scores))
    want = {p: d[v & (d[:, 1] >= thresh)].tolist()
            for p, (d, v) in want.items()}
    code = r"""
import sys
from tf_faster_rcnn_torch.tools import serve
serve.main(sys.argv[1:])
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax",
                                    "tf_faster_rcnn_tpu")
             or m.startswith(("tf_faster_rcnn_torch.models",
                              "tf_faster_rcnn_torch.engine",
                              "tf_faster_rcnn_torch.config")))
print("LOADED", bad)
"""
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    out = subprocess.run(
        [sys.executable, "-c", code, "--bundle", bundle[2], "--thresh",
         repr(thresh), "--json", out_json] + paths,
        cwd=str(tmp_path), env=env, capture_output=True, text=True,
        timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "LOADED []" in out.stdout, out.stdout[-2000:]
    with open(out_json) as f:
        got = json.load(f)
    assert got == want
    assert 0 < sum(map(len, got.values())) < len(scores)


def test_demo_cli_matches_im_detect(bundle, mobile, tmp_path, monkeypatch):
    """The demo generates its images on first use and writes each figure,
    and the JSON of im_detect's rows at or above CONF_THRESH. The random
    weights score below the demo's 0.8, so the first run keeps every row
    (CONF_THRESH 0) and the second, over the images the first generated,
    those at or above the median score."""
    demo_dir, out_dir = tmp_path / "demo", tmp_path / "out"
    out_json = str(tmp_path / "demo.json")
    names = [f"demo_{i:03d}.jpg" for i in range(5)]
    cfg_file = str(tmp_path / "small.yml")
    _write_cfg(cfg_file, bundle[0])
    argv = ["--net", "mobile", "--model", bundle[1], "--cfg", cfg_file,
            "--device", "cpu", "--demo-dir", str(demo_dir), "--out-dir",
            str(out_dir), "--json", out_json]
    monkeypatch.setattr(tdemo, "CONF_THRESH", 0.0)
    everything = tdemo.main(argv)
    assert sorted(os.listdir(demo_dir)) == names
    assert sorted(os.listdir(out_dir)) == [f"det_{n}.png" for n in names]
    live = _live(mobile)
    dets = {n: tengine.im_detect(
        live, tblob.read_image_bgr(str(demo_dir / n)), "cpu") for n in names}
    thresh = float(np.median(np.concatenate([d[:, 1] for d in dets.values()])))
    monkeypatch.setattr(tdemo, "CONF_THRESH", thresh)
    got = tdemo.main(argv)
    with open(out_json) as f:
        assert json.load(f) == {k: [list(r) for r in v]
                                for k, v in got.items()}
    for t, run in ((0.0, everything), (thresh, got)):
        for name in names:
            want = [(VOC_CLASSES[int(r[0])], float(r[1]), float(r[2]),
                     float(r[3]), float(r[4]), float(r[5]))
                    for r in dets[name] if r[1] >= t]
            assert run[name] == want, (t, name)
    n_rows = sum(map(len, got.values()))
    assert 0 < n_rows < sum(map(len, everything.values()))


def test_top_mode_bakes_its_pad_indices(mobile, tmp_path):
    """TEST.MODE 'top' with fewer anchors than RPN_TOP_N (one 128 x 128
    canvas): the exported program takes the pad indices draw_top_pad gives
    the live path, and equals it."""
    tspec, tmodel = mobile[3], mobile[4]
    spec = dataclasses.replace(tspec, test_mode="top", rpn_top_n=500)
    tconfig.cfg.TEST.SCALES = (96,)
    tconfig.cfg.TEST.MAX_SIZE = 128
    tconfig.cfg.TPU.BUCKETING = False
    manifest = tserving.export_detect(tmodel, spec, str(tmp_path), BATCH)
    assert [e["canvas"] for e in manifest["artifacts"]] == [[128, 128]]
    _, fns = tserving.load_detect(str(tmp_path))
    live = tengine.make_detect_fn(tmodel, spec)
    rng = np.random.RandomState(1)
    image = torch.from_numpy((rng.randn(BATCH, 128, 128, 3) * 50)
                             .astype(np.float32))
    im_info = torch.tensor([[96.0, 128.0, 1.28], [128.0, 96.0, 1.28]])
    orig_hw = im_info[:, :2] / 1.28
    got, want = fns[(128, 128)](image, im_info, orig_hw), live(image, im_info,
                                                                 orig_hw)
    for g, w in zip(got, want, strict=True):
        assert torch.equal(g, w)
    assert got[1].sum() > 0
