"""The port's weight import against the JAX package's: the TF bundle reader,
the slim conversion, the convert_weights CLI, and the space-to-depth stem.

* the bundle reader reads checkpoints that real TensorFlow wrote
  (``tests/tf_ckpt_writer.py`` in a subprocess) equal, dtype and bytes, to
  the JAX reader and to TF's own dump; snappy blocks decode equal to the
  JAX decoder and to the known text;
* ``convert_slim_weights`` equals the JAX converter exactly (every array,
  bit for bit) for vgg16, res50, res101, res152 and mobile, on synthetic
  var dicts shaped like each model, heads included; the JAX converter's
  output bridged by ``state_dict_from_flax`` equals what
  ``load_pretrained_into`` writes into the torch model;
* ``flax_from_state_dict`` gives the JAX params tree's paths and shapes
  for every backbone and inverts ``state_dict_from_flax``;
* the ``convert_weights`` CLI on a ``.ckpt`` and an ``.npz`` writes the
  converted weights, and ``test_net --model`` takes a ``.npz`` as the JAX
  CLI does, scoring what the converted ``.pt`` scores;
* a JAX space-to-depth ``conv1`` [4, 4, 12, 64] bridges back to the
  original 7x7 kernel exactly and loads; a nonzero tap outside the 7x7
  support raises.
"""

import dataclasses
import os.path as osp
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_datasets import make_voc
from tf_faster_rcnn_tpu.models import network as jnet
from tf_faster_rcnn_tpu.models.resnet_v1 import s2d_conv1_kernel
from tf_faster_rcnn_tpu.utils import slim_import as jslim
from tf_faster_rcnn_tpu.utils import tf_bundle as jbundle
from tf_faster_rcnn_torch import config as tconfig
from tf_faster_rcnn_torch.models import network as tnet
from tf_faster_rcnn_torch.models.init import init_model
from tf_faster_rcnn_torch.tools import convert_weights as tconvert
from tf_faster_rcnn_torch.tools import test_net as ttest_net
from tf_faster_rcnn_torch.utils import checkpoint as tckpt
from tf_faster_rcnn_torch.utils import slim_import as tslim
from tf_faster_rcnn_torch.utils import tf_bundle as tbundle
from tf_faster_rcnn_torch.utils.weights import (flax_from_state_dict,
                                                s2d_conv1_kernel_inverse,
                                                state_dict_from_flax)

HERE = osp.dirname(osp.abspath(__file__))
BACKBONES = ("vgg16", "res50", "res101", "res152", "mobile")
SMALL = dict(anchor_scales=(2, 4), rpn_pre_nms_top_n=128,
             rpn_post_nms_top_n=16)
MOBILE_SET = ["MOBILENET.DEPTH_MULTIPLIER", "0.25"]


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


def _write_ckpt(arrays, prefix):
    """A TF1 Saver checkpoint of arrays, written by TensorFlow in a
    subprocess, with TF's own reading of it at prefix + '_tfdump.npz'."""
    src = prefix + "_src.npz"
    np.savez(src, **arrays)
    proc = subprocess.run(
        [sys.executable, osp.join(HERE, "tf_ckpt_writer.py"), src, prefix],
        capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    return prefix


def _shapes(backbone, multiplier=1.0, pooling_size=7):
    """The JAX detector's param tree of shape structs (no arrays drawn)."""
    spec = dataclasses.replace(jnet.spec_from_cfg(backbone, 21, "TEST"),
                               depth_multiplier=multiplier,
                               pooling_size=pooling_size, **SMALL)
    return jax.eval_shape(
        jnet.FasterRCNN(spec).init, jax.random.PRNGKey(0),
        jnp.zeros((1, 64, 64, 3)), jnp.array([[64.0, 64.0, 1.0]]))


def _zeros(shapes):
    return jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32),
                                  shapes)


def _port_model(backbone, multiplier=1.0, pooling_size=7):
    spec = dataclasses.replace(tnet.spec_from_cfg(backbone, 21, "TEST"),
                               depth_multiplier=multiplier,
                               pooling_size=pooling_size, **SMALL)
    model = tnet.FasterRCNN(spec, device="cpu")
    init_model(model, torch.Generator().manual_seed(0))
    return model


def _var_dict(params, backbone, seed):
    """A slim var dict shaped like the model tree, heads included, float32
    (the tests/test_slim_import.py pattern, for every backbone)."""
    gen = np.random.default_rng(seed)
    p = params["params"]
    var = {}

    def draw(*shape):
        return gen.standard_normal(shape, dtype=np.float32)

    def bn(prefix, tree):
        for theirs, ours in (("gamma", "scale"), ("beta", "bias"),
                             ("moving_mean", "mean")):
            var[f"{prefix}/BatchNorm/{theirs}"] = draw(*tree[ours].shape)
        var[f"{prefix}/BatchNorm/moving_variance"] = np.abs(
            draw(*tree["var"].shape)) + 0.5

    scope = tslim._SCOPES[backbone]
    if backbone.startswith("res"):
        var[f"{scope}/conv1/weights"] = draw(7, 7, 3, 64)
        bn(f"{scope}/conv1", p["head"]["conv1_bn"])
        for bi, where in ((1, "head"), (2, "head"), (3, "head"), (4, "tail")):
            for unit_name, unit in p[where][f"block{bi}"].items():
                base = f"{scope}/block{bi}/{unit_name}/bottleneck_v1"
                for conv in ("conv1", "conv2", "conv3", "shortcut"):
                    if conv in unit:
                        var[f"{base}/{conv}/weights"] = draw(
                            *unit[conv]["conv"]["kernel"].shape)
                        bn(f"{base}/{conv}", unit[conv]["bn"])
    elif backbone == "vgg16":
        for conv, reps in (("conv1", 2), ("conv2", 2), ("conv3", 3),
                           ("conv4", 3), ("conv5", 3)):
            for r in range(1, reps + 1):
                k = p["head"][f"{conv}_{r}"]
                var[f"{scope}/{conv}/{conv}_{r}/weights"] = draw(
                    *k["kernel"].shape)
                var[f"{scope}/{conv}/{conv}_{r}/biases"] = draw(
                    *k["bias"].shape)
        var[f"{scope}/fc6/weights"] = draw(7, 7, 512, 4096)
        var[f"{scope}/fc6/biases"] = draw(4096)
        var[f"{scope}/fc7/weights"] = draw(1, 1, 4096, 4096)
        var[f"{scope}/fc7/biases"] = draw(4096)
    else:
        var[f"{scope}/Conv2d_0/weights"] = draw(
            *p["head"]["base"]["conv2d_0"]["kernel"].shape)
        bn(f"{scope}/Conv2d_0", p["head"]["base"]["conv2d_0_bn"])
        for where, layers in (("head", range(1, 12)), ("tail", range(12, 14))):
            for i in layers:
                t = p[where]["base"][f"conv2d_{i}"]
                c = t["depthwise"]["kernel"].shape[-1]
                var[f"{scope}/Conv2d_{i}_depthwise/depthwise_weights"] = \
                    draw(3, 3, c, 1)
                bn(f"{scope}/Conv2d_{i}_depthwise", t["depthwise_bn"])
                var[f"{scope}/Conv2d_{i}_pointwise/weights"] = draw(
                    *t["pointwise"]["kernel"].shape)
                bn(f"{scope}/Conv2d_{i}_pointwise", t["pointwise_bn"])
    # the heads, as a trained reference checkpoint holds them; rpn_conv's
    # kernel flattened, so the converter's reshape runs
    for name, dst in (("rpn_conv/3x3", "rpn_conv"),
                      ("rpn_cls_score", "rpn_cls_score"),
                      ("rpn_bbox_pred", "rpn_bbox_pred"),
                      ("cls_score", "cls_score"), ("bbox_pred", "bbox_pred")):
        kernel = p[dst]["kernel"]
        var[f"{scope}/{name}/weights"] = draw(*kernel.shape)
        var[f"{scope}/{name}/biases"] = draw(*p[dst]["bias"].shape)
    k = var[f"{scope}/rpn_conv/3x3/weights"]
    var[f"{scope}/rpn_conv/3x3/weights"] = k.reshape(-1, k.shape[-1])
    return var


def _assert_trees_equal(got, want, path=""):
    assert isinstance(got, dict) == isinstance(want, dict), path
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for key in want:
            _assert_trees_equal(got[key], want[key], f"{path}/{key}")
    else:
        got, want = np.asarray(got), np.asarray(want)
        assert got.dtype == want.dtype and got.shape == want.shape, path
        np.testing.assert_array_equal(got, want, err_msg=path)


# --- the TF bundle reader ----------------------------------------------------

def _mobile_backbone_var(seed=3):
    """A mobile (multiplier 0.25) slim var dict of the backbone only, as an
    ImageNet checkpoint holds it, and the template it was shaped on."""
    params = _zeros(_shapes("mobile", 0.25))
    var = {k: v for k, v in _var_dict(params, "mobile", seed).items()
           if k.startswith("MobilenetV1/Conv2d")}
    return params, var


@pytest.fixture(scope="module")
def mixed_ckpt(tmp_path_factory):
    """One checkpoint, written by TensorFlow, with every dtype class the
    reader handles and a mobile backbone's variables."""
    rng = np.random.RandomState(0)
    arrays = {
        "resnet_v1_50/conv1/weights": rng.randn(7, 7, 3, 64).astype(
            np.float32),
        "a/large": rng.randn(300, 1200).astype(np.float32),
        "global_step": np.array(70000, np.int64),
        "misc/int32": rng.randint(0, 9, (5,), np.int32),
        "misc/double": rng.randn(3, 2),
        "misc/bool": np.array([True, False, True]),
        "misc/empty": np.zeros((0, 4), np.float32),
    }
    arrays.update(_mobile_backbone_var()[1])
    prefix = str(tmp_path_factory.mktemp("ckpt") / "model.ckpt")
    return _write_ckpt(arrays, prefix), arrays


def test_bundle_reader_matches_jax_and_tf(mixed_ckpt):
    prefix, arrays = mixed_ckpt
    assert tbundle.is_tf_checkpoint(prefix)
    assert not tbundle.is_tf_checkpoint(prefix + "_nope")
    ours = tbundle.read_tf_checkpoint(prefix)
    theirs = jbundle.read_tf_checkpoint(prefix)
    dump = dict(np.load(prefix + "_tfdump.npz"))
    assert set(ours) == set(theirs) == set(dump) == set(arrays)
    for k in dump:
        for other in (theirs[k], dump[k]):
            assert ours[k].dtype == other.dtype, k
            assert ours[k].tobytes() == other.tobytes(), k
    assert tbundle.list_tf_checkpoint(prefix) == \
        jbundle.list_tf_checkpoint(prefix)


def _literal(data: bytes) -> bytes:
    n = len(data) - 1
    if n < 60:
        return bytes([n << 2]) + data
    return bytes([61 << 2]) + n.to_bytes(2, "little") + data


@pytest.mark.parametrize("stream,want", [
    # a literal, a copy with a 1-byte offset overlapping itself, a literal
    (b"\x0d" + _literal(b"abc") + bytes([(5 << 2) | 1, 3]) + _literal(b"X"),
     b"abcabcabcabcX"),
    # a long literal (2 length bytes), then copies with 2- and 4-byte
    # offsets
    (bytes([200, 1]) + _literal(bytes(range(100)))
     + bytes([(49 << 2) | 2]) + (100).to_bytes(2, "little")
     + bytes([(49 << 2) | 3]) + (100).to_bytes(4, "little"),
     bytes(range(100)) + bytes(range(50)) + bytes(range(50, 100))),
])
def test_snappy_matches_jax(stream, want):
    assert tbundle._snappy_decompress(stream) == want
    assert jbundle._snappy_decompress(stream) == want


def test_snappy_length_mismatch_raises():
    with pytest.raises(ValueError, match="snappy"):
        tbundle._snappy_decompress(b"\x05" + _literal(b"abc"))


# --- the slim conversion -----------------------------------------------------

@pytest.mark.parametrize("backbone", BACKBONES)
def test_convert_slim_weights_equals_jax(backbone):
    """Every array equal, bit for bit, to the JAX converter's on the same
    template and var dict; then the same weights through the torch model."""
    multiplier = 0.25 if backbone == "mobile" else 1.0
    params = _zeros(_shapes(backbone, multiplier))
    var = _var_dict(params, backbone, seed=BACKBONES.index(backbone))
    want = jslim.convert_slim_weights(params, var, backbone)
    got = tslim.convert_slim_weights(params, var, backbone)
    _assert_trees_equal(got, jax.tree_util.tree_map(np.asarray, want))

    if backbone == "vgg16":
        return      # fc6 alone is 400 MB a copy; the trees are equal above
    model = _port_model(backbone, multiplier)
    tree = tslim.convert_slim_weights(
        flax_from_state_dict(model.state_dict()), var, backbone)
    model.load_state_dict(state_dict_from_flax(tree), strict=True)
    bridged = state_dict_from_flax(want)
    for name, t in model.state_dict().items():
        assert torch.equal(t, bridged[name]), name


def test_load_pretrained_into_from_npz_and_pkl(tmp_path):
    """load_pretrained_into reads an .npz and a .pkl export alike, and
    writes the JAX converter's weights into the model; missing heads keep
    their values."""
    import pickle
    params = _zeros(_shapes("mobile", 0.25))
    var = _var_dict(params, "mobile", seed=7)
    backbone_only = {k: v for k, v in var.items()
                     if not any(h in k for h in ("rpn_", "cls_score",
                                                 "bbox_pred"))}
    np.savez(tmp_path / "mobile.npz", **backbone_only)
    with open(tmp_path / "mobile.pkl", "wb") as f:
        pickle.dump(backbone_only, f)
    want = state_dict_from_flax(jslim.convert_slim_weights(
        params, backbone_only, "mobile"))
    for path in (tmp_path / "mobile.npz", tmp_path / "mobile.pkl"):
        model = _port_model("mobile", 0.25)
        heads = model.rpn_conv.weight.detach().clone()
        tslim.load_pretrained_into(model, str(path), "mobile")
        sd = model.state_dict()
        for name, t in want.items():
            if name.startswith("head.") or name.startswith("tail."):
                assert torch.equal(sd[name], t), name
        assert torch.equal(model.rpn_conv.weight, heads)


def test_convert_shape_mismatch_raises():
    params = _zeros(_shapes("mobile", 0.25))
    var = _var_dict(params, "mobile", seed=1)
    var["MobilenetV1/Conv2d_0/weights"] = np.zeros((3, 3, 3, 9), np.float32)
    with pytest.raises(ValueError, match="shape mismatch"):
        tslim.convert_slim_weights(params, var, "mobile")
    with pytest.raises(ValueError, match="backbone"):
        tslim.convert_slim_weights(params, var, "res18")


@pytest.mark.parametrize("backbone", BACKBONES)
def test_flax_from_state_dict_matches_jax_tree(backbone):
    """The inverse bridge gives the JAX tree's paths and shapes, and
    state_dict_from_flax maps it back exactly."""
    multiplier = 0.25 if backbone == "mobile" else 1.0
    # vgg16's fc6 at pooling_size 3 (4608 -> 4096)
    shapes = _shapes(backbone, multiplier, pooling_size=3)
    model = _port_model(backbone, multiplier, pooling_size=3)
    tree = flax_from_state_dict(model.state_dict())
    got = jax.tree_util.tree_map(lambda a: a.shape, tree)
    want = jax.tree_util.tree_map(lambda s: tuple(s.shape), shapes)
    assert got == want
    back = state_dict_from_flax(tree)
    for name, t in model.state_dict().items():
        assert torch.equal(back[name], t), name


# --- the CLI and test_net --model --------------------------------------------

def test_convert_weights_cli_ckpt_and_npz(mixed_ckpt, tmp_path):
    """A mobile var dict (backbone only, as an ImageNet checkpoint) in a
    .ckpt that TensorFlow wrote and in an .npz: the CLI converts both to
    the same .pt, equal to the JAX converter's backbone; the detection
    heads are the RNG_SEED draw."""
    prefix = mixed_ckpt[0]
    params, var = _mobile_backbone_var()
    np.savez(tmp_path / "mobile.npz", **var)
    outs = []
    for src in (prefix, str(tmp_path / "mobile.npz")):
        dst = str(tmp_path / (osp.basename(src) + ".pt"))
        tconvert.main(["--net", "mobile", "--src", src, "--dst", dst,
                       "--device", "cpu", "--set"] + MOBILE_SET)
        outs.append(tckpt.load_params(dst))
    want = state_dict_from_flax(jslim.convert_slim_weights(params, var,
                                                           "mobile"))
    tconfig.cfg_from_list(MOBILE_SET)
    seeded = tnet.FasterRCNN(tnet.spec_from_cfg("mobile", 21, "TEST"),
                             device="cpu")
    init_model(seeded, torch.Generator().manual_seed(tconfig.cfg.RNG_SEED))
    seeded = seeded.state_dict()
    for name in outs[0]:
        assert torch.equal(outs[0][name], outs[1][name]), name
        ref = want[name] if name.startswith(("head.", "tail.")) else \
            seeded[name]
        assert torch.equal(outs[0][name], ref), name


def test_test_net_takes_npz_weights(tmp_path):
    """test_net --model on a slim .npz scores what the converted .pt
    scores (the JAX CLI's --model takes both)."""
    make_voc(str(tmp_path))
    params = _zeros(_shapes("mobile", 0.25))
    var = _var_dict(params, "mobile", seed=5)
    npz = str(tmp_path / "mobile.npz")
    np.savez(npz, **var)
    settings = ["DATA_DIR", str(tmp_path), "ROOT_DIR", str(tmp_path),
                "TEST.SCALES", "(96,)", "TEST.MAX_SIZE", "128",
                "ANCHOR_SCALES", "[2,4]", "TEST.RPN_PRE_NMS_TOP_N", "128",
                "TEST.RPN_POST_NMS_TOP_N", "16"] + MOBILE_SET
    pt = str(tmp_path / "mobile.pt")
    tconvert.main(["--net", "mobile", "--src", npz, "--dst", pt,
                   "--device", "cpu", "--set"] + settings)
    maps = []
    for model in (npz, pt):
        tconfig.reset_cfg()
        maps.append(ttest_net.main(["--net", "mobile", "--imdb",
                                    "voc_2007_test", "--model", model,
                                    "--device", "cpu", "--set"] + settings))
    assert maps[0] == maps[1] and 0.0 <= maps[0] <= 1.0


# --- the space-to-depth stem -------------------------------------------------

def test_s2d_conv1_bridges_back_to_7x7(rng):
    k7 = rng.randn(7, 7, 3, 64).astype(np.float32)
    k2 = s2d_conv1_kernel(k7)
    assert k2.shape == (4, 4, 12, 64)
    np.testing.assert_array_equal(s2d_conv1_kernel_inverse(k2), k7)

    params = jax.tree_util.tree_map(
        lambda s: rng.randn(*s.shape).astype(np.float32), _shapes("res50"))
    params["params"]["head"]["conv1"]["kernel"] = k2
    sd = state_dict_from_flax(params)
    np.testing.assert_array_equal(sd["head.conv1.weight"].numpy(),
                                  k7.transpose(3, 2, 0, 1))
    _port_model("res50").load_state_dict(sd, strict=True)


@pytest.mark.parametrize("tap", [(0, 0, 0, 0), (2, 0, 7, 7), (0, 3, 1, 63)])
def test_s2d_conv1_nonzero_outside_support_raises(rng, tap):
    """Places (m = 0, a = 0) or (n = 0, b = 0) of the 4x4 kernel hold no
    7x7 tap."""
    k2 = s2d_conv1_kernel(rng.randn(7, 7, 3, 64).astype(np.float32))
    assert k2[tap] == 0.0
    k2[tap] = 1e-3
    with pytest.raises(ValueError, match="outside the 7x7 support"):
        s2d_conv1_kernel_inverse(k2)
    with pytest.raises(ValueError, match="outside the 7x7 support"):
        state_dict_from_flax({"head": {"conv1": {"kernel": k2}}})
