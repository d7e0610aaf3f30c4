"""The port's copies of the JAX package's training utilities, against the
originals, and what the port imports.

* ``MetricsWriter``, ``TBEventWriter`` (scalars, a scalar group, a
  histogram, an image) and ``draw_bounding_boxes``: the same calls with the
  wall clock pinned write files equal byte for byte, under the same names,
  and draw the same pixels;
* every module of ``tf_faster_rcnn_torch`` imports in a subprocess where
  jax, flax, the JAX package, cv2, PIL and tensorflow cannot be imported.
"""

import os
import subprocess
import sys
import time

import numpy as np
import pytest

from tf_faster_rcnn_tpu.utils import metrics as jmetrics
from tf_faster_rcnn_tpu.utils import tb_writer as jtb
from tf_faster_rcnn_tpu.utils import visualization as jvis
from tf_faster_rcnn_torch.utils import metrics as tmetrics
from tf_faster_rcnn_torch.utils import tb_writer as ttb
from tf_faster_rcnn_torch.utils import visualization as tvis

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BLOCKED = ("jax", "jaxlib", "flax", "optax", "cv2", "PIL", "tensorflow",
           "tf_faster_rcnn_tpu")


@pytest.fixture
def pinned_clock(monkeypatch):
    monkeypatch.setattr(time, "time", lambda: 1792000000.25)


def _files(root):
    return {name: open(os.path.join(root, name), "rb").read()
            for name in sorted(os.listdir(root))}


def test_metrics_writer_matches_jax(tmp_path, pinned_clock):
    for mod, sub in ((jmetrics, "jax"), (tmetrics, "port")):
        w = mod.MetricsWriter(str(tmp_path / sub))
        w.write(1, {"total_loss": np.float32(1.25), "lr": 0.001},
                prefix="train")
        w.write(2, {"val_mAP": 0.5})
        w.close()
        w = mod.MetricsWriter(str(tmp_path / sub))   # appends
        w.write(3, {"x": 2})
        w.close()
    want = _files(tmp_path / "jax")
    assert list(want) == ["metrics.jsonl"]
    assert _files(tmp_path / "port") == want
    assert want["metrics.jsonl"].count(b"\n") == 3


def _image(rng):
    return rng.randint(0, 255, (48, 64, 3)).astype(np.uint8)


@pytest.mark.parametrize("flush_between", [False, True])
def test_event_writer_matches_jax_byte_for_byte(tmp_path, rng, pinned_clock,
                                                flush_between):
    values = rng.randn(1000) * 3
    values[::97] = np.nan                      # dropped from the histogram
    image = _image(rng)
    for mod, sub in ((jtb, "jax"), (ttb, "port")):
        w = mod.TBEventWriter(str(tmp_path / sub))
        w.add_scalar("loss", 1.5, 3)
        w.add_scalars({"a": 1.0, "b": np.float32(2.5)}, 4, prefix="TRAIN")
        if flush_between:
            w.flush()
        w.add_histogram("TRAIN/params/head/conv1/kernel", values, 5)
        w.add_histogram("empty", np.zeros((0,)), 6)
        w.add_image("GROUND_TRUTH", image, 7)
        w.close()
    want = _files(tmp_path / "jax")
    assert len(want) == 1 and next(iter(want)).startswith(
        "events.out.tfevents.1792000000.")
    assert _files(tmp_path / "port") == want
    assert ttb.crc32c(b"123456789") == 0xE3069283


def test_draw_bounding_boxes_matches_jax(rng):
    img = rng.uniform(0, 255, (1, 96, 128, 3)).astype(np.float32)
    gt = np.array([[10, 12, 60, 80, 3], [40, 5, 120, 90, 15],
                   [0, 0, 20, 20, 120]], np.float32)
    for args in ((img, gt, (96.0, 128.0, 1.0)), (img[0], gt, None),
                 (img[0], gt, (96.0, 128.0, 1.6)), (img, gt[:0], None)):
        want = jvis.draw_bounding_boxes(*args)
        got = tvis.draw_bounding_boxes(*args)
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    assert tvis.STANDARD_COLORS == jvis.STANDARD_COLORS
    assert not np.array_equal(tvis.draw_bounding_boxes(img, gt), img)


def test_port_imports_none_of_the_blocked_packages():
    """Every module of the port imports with jax, flax, the JAX package,
    cv2, PIL and tensorflow made unimportable."""
    code = r"""
import importlib, importlib.abc, os, pkgutil, sys
BLOCKED = %r

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"blocked: {name}")
        return None

sys.meta_path.insert(0, Block())
import tf_faster_rcnn_torch
root = tf_faster_rcnn_torch.__path__[0]
names = sorted(m.name for m in pkgutil.walk_packages(
    [root], "tf_faster_rcnn_torch."))
# tools/ is a namespace package, which walk_packages does not enter
names += sorted(m.name for m in pkgutil.iter_modules(
    [os.path.join(root, "tools")], "tf_faster_rcnn_torch.tools."))
for name in names:
    importlib.import_module(name)
loaded = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
print("IMPORTED", " ".join(names))
print("LOADED", loaded)
""" % (BLOCKED,)
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "LOADED []" in out.stdout, out.stdout[-2000:]
    imported = out.stdout.split("IMPORTED")[1].split("LOADED")[0].split()
    for module in ("engine.train_loop", "data.loader", "data.roidb",
                   "utils.slim_import", "utils.tf_bundle", "utils.tb_writer",
                   "utils.metrics", "utils.visualization",
                   "tools.trainval_net", "tools.convert_weights"):
        assert f"tf_faster_rcnn_torch.{module}" in imported, module
