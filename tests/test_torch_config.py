"""The port's config registry and TPU.USE_PALLAS_NMS, against the JAX
package.

* Key coverage, the port's twin of tests/test_config_coverage.py: every key
  of the port's cfg is read somewhere in tf_faster_rcnn_torch/ outside the
  defaults, or is in the port's registry of vestigial and structural keys
  (and then is read nowhere). A key that is neither would merge from a YAML
  and change nothing.
* The warnings: the port's cfg_from_list and cfg_from_file warn for the
  same keys as the JAX package's, with the vestigial text word for word.
* The flag: TPU.USE_PALLAS_NMS reaches spec_from_cfg in both modes, as it
  reaches the JAX spec; True builds the default spec and False is refused,
  naming the flag (the port runs NMS through its kernels only).
* The profiler's flags (tools/train_profile.py::detect_target) give the
  spec and canvas that the JAX package's tools/profile_net.py builds.

No tolerance: the outputs compared are keys, strings and specs.
"""

import dataclasses
import json
import re
from pathlib import Path

import pytest

from tf_faster_rcnn_torch import config as tcfg
from tf_faster_rcnn_torch.models import network as tnet
from tf_faster_rcnn_torch.tools import train_profile
from tf_faster_rcnn_tpu import config as jcfg
from tf_faster_rcnn_tpu.models import network as jnet

REPO = Path(__file__).resolve().parent.parent
CFGS = REPO / "experiments" / "cfgs"


@pytest.fixture(autouse=True)
def _reset_port_cfg():
    """The conftest resets the JAX cfg only."""
    tcfg.reset_cfg()
    yield
    tcfg.reset_cfg()


def _port_source():
    pkg = REPO / "tf_faster_rcnn_torch"
    src = "\n".join(p.read_text() for p in pkg.rglob("*.py")
                    if p.name != "config.py")
    # config.py reads keys below its defaults and its registry (canvas_hw,
    # get_output_dir, ...); the defaults and the registry's comments name
    # keys without reading them
    cfg_src = (pkg / "config.py").read_text()
    return src + cfg_src[cfg_src.index("def _merge_a_into_b"):]


SRC = _port_source()


def _mentions(text, dotted):
    return bool(re.search(re.escape(dotted) + r"(?![A-Z_0-9])", text))


def _is_read(section, key):
    if not section:
        return _mentions(SRC, f"cfg.{key}")
    # TRAIN/TEST keys read mode-generically as `phase.KEY` (spec_from_cfg)
    return _mentions(SRC, f"{section}.{key}") or (
        section in ("TRAIN", "TEST") and _mentions(SRC, f"phase.{key}"))


def _walk():
    for section in ("TRAIN", "TEST", "TPU", "RESNET", "MOBILENET"):
        for key in tcfg.cfg[section]:
            yield section, key
    for key, value in tcfg.cfg.items():
        if not isinstance(value, dict):
            yield "", key


def test_every_section_is_walked():
    sections = {k for k, v in tcfg.cfg.items() if isinstance(v, dict)}
    assert sections == {"TRAIN", "TEST", "TPU", "RESNET", "MOBILENET"}


@pytest.mark.parametrize("section,key", list(_walk()))
def test_port_key_read_or_registered(section, key):
    dotted = f"{section}.{key}" if section else key
    registered = (dotted in tcfg.VESTIGIAL_KEYS
                  or dotted in tcfg.STRUCTURAL_KEYS)
    if registered:
        assert not _is_read(section, key), (
            f"{dotted} is registered as vestigial/structural but the port "
            f"reads it: take it out of the registry")
    else:
        assert _is_read(section, key), (
            f"{dotted} is neither read in tf_faster_rcnn_torch/ nor "
            f"registered: a YAML override of it would be a silent no-op")


def test_registry_is_the_jax_registry():
    assert tcfg.VESTIGIAL_KEYS == jcfg.VESTIGIAL_KEYS
    assert set(tcfg.STRUCTURAL_KEYS) == set(jcfg.STRUCTURAL_KEYS)
    # the port states its own truth: no XLA program here
    assert "XLA" not in " ".join(tcfg.STRUCTURAL_KEYS.values())


def _literal(value):
    return repr(value) if isinstance(value, str) else str(value)


def _value(section_cfg, key):
    """A value of key's type other than its default."""
    v = section_cfg[key]
    if isinstance(v, bool):
        return not v
    if isinstance(v, str):
        return v + "_x"
    return v


def _key_cfg(package_cfg, dotted):
    *path, key = dotted.split(".")
    d = package_cfg
    for p in path:
        d = d[p]
    return d, key


WARNED = sorted(jcfg.VESTIGIAL_KEYS | set(jcfg.STRUCTURAL_KEYS))


@pytest.mark.parametrize("dotted", WARNED + ["TEST.NMS", "TPU.USE_PALLAS_NMS",
                                             "EXP_DIR"])
def test_cfg_from_list_warns_as_jax_does(capsys, dotted):
    d, key = _key_cfg(tcfg.cfg, dotted)
    args = [dotted, _literal(_value(d, key))]
    jcfg.cfg_from_list(args)
    want = capsys.readouterr().out
    tcfg.cfg_from_list(args)
    got = capsys.readouterr().out
    assert ("WARNING" in got) == ("WARNING" in want) == (dotted in WARNED)
    if dotted in WARNED:
        assert dotted in got
    if dotted in jcfg.VESTIGIAL_KEYS or dotted not in WARNED:
        assert got == want
    assert d[key] == _key_cfg(jcfg.cfg, dotted)[0][key]


def test_cfg_from_file_warns_as_jax_does(capsys, tmp_path):
    """A YAML that sets every registered key and two live ones: the same
    warning lines, vestigial ones word for word, structural ones naming the
    same keys."""
    import yaml
    tree = {}
    for dotted in WARNED + ["TEST.NMS", "TPU.USE_PALLAS_NMS"]:
        d, key = _key_cfg(tcfg.cfg, dotted)
        node = tree
        for p in dotted.split(".")[:-1]:
            node = node.setdefault(p, {})
        node[key] = _value(d, key) if not isinstance(d[key], float) else 0.4
    path = tmp_path / "registry.yml"
    path.write_text(yaml.safe_dump(tree))
    jcfg.cfg_from_file(str(path))
    want = capsys.readouterr().out.splitlines()
    tcfg.cfg_from_file(str(path))
    got = capsys.readouterr().out.splitlines()
    assert len(got) == len(want) == len(WARNED)
    assert sorted(line for line in got if "YAML compatibility" in line) == \
        sorted(line for line in want if "YAML compatibility" in line)
    keys = [re.search(r"WARNING: (\S+)", line).group(1) for line in got]
    assert sorted(keys) == WARNED
    assert tcfg.cfg.TPU.USE_PALLAS_NMS is False


@pytest.mark.parametrize("mode", ["TEST", "TRAIN"])
def test_use_pallas_nms_reaches_the_spec(mode):
    """The flag on builds the spec the defaults build; off, where the JAX
    spec takes its jnp NMS, the port's spec_from_cfg refuses it and names
    the flag: the port has no second NMS route on the card."""
    default = tnet.spec_from_cfg("res101", 21, mode)
    for flag in (True, False):
        args = ["TPU.USE_PALLAS_NMS", str(flag)]
        tcfg.cfg_from_list(args)
        jcfg.cfg_from_list(args)
        assert jnet.spec_from_cfg("res101", 21, mode).use_pallas_nms is flag
        if flag:
            assert tnet.spec_from_cfg("res101", 21, mode) == default
        else:
            with pytest.raises(NotImplementedError,
                               match=r"TPU\.USE_PALLAS_NMS False.*"
                                     r"Not ported, by decision"):
                tnet.spec_from_cfg("res101", 21, mode)
    assert not hasattr(tnet.ModelSpec("res101", 21), "use_pallas_nms")


def _profile_net_spec(net, cfg_file=None):
    """tools/profile_net.py's spec and canvas (its main(), lines 44-62),
    built with the JAX package: bf16 compute, the canvas form's 6000 -> 300
    or the YAML's TEST settings and first canvas bucket."""
    jcfg.cfg.TPU.COMPUTE_DTYPE = "bfloat16"
    if cfg_file:
        jcfg.cfg_from_file(cfg_file)
        return (jnet.spec_from_cfg(net, 21, "TEST"),
                jcfg.canvas_buckets(jcfg.cfg.TEST)[0])
    spec = dataclasses.replace(jnet.spec_from_cfg(net, 21, "TEST"),
                               rpn_pre_nms_top_n=6000,
                               rpn_post_nms_top_n=300)
    return spec, (608, 1024)


def _same_fields(port, ref):
    names = {f.name for f in dataclasses.fields(ref)}
    for f in dataclasses.fields(port):
        if f.name in names:
            assert getattr(port, f.name) == getattr(ref, f.name), f.name


@pytest.mark.parametrize("net,cfg_file", [
    ("res101", None), ("mobile", None), ("res101", "res101-lg.yml"),
    ("vgg16", "vgg16.yml")])
def test_profiler_flags_give_profile_nets_workload(net, cfg_file):
    path = str(CFGS / cfg_file) if cfg_file else None
    spec, canvas = train_profile.detect_target(net, "bfloat16", "608,1024",
                                               path)
    ref_spec, ref_canvas = _profile_net_spec(net, path)
    assert tuple(canvas) == tuple(ref_canvas)
    _same_fields(spec, ref_spec)
    assert spec.compute_dtype == "bfloat16"
    if cfg_file is None:
        assert (spec.rpn_pre_nms_top_n, spec.rpn_post_nms_top_n) == (6000, 300)
        other = train_profile.detect_target(net, "float32", "96,128")
        assert other == (dataclasses.replace(spec, compute_dtype="float32"),
                         (96, 128))


def test_profiler_refuses_s2d():
    with pytest.raises(NotImplementedError, match="Rules of the port"):
        train_profile.detect_target("res101", "bfloat16", "608,1024",
                                    s2d=True)


def test_trace_top_ops_reads_device_events(tmp_path):
    """The trace reader sums a Chrome trace's device events by name, per
    step, and leaves the host's out."""
    events = [
        {"ph": "X", "cat": "kernel", "name": "conv", "dur": 3000.0},
        {"ph": "X", "cat": "kernel", "name": "conv", "dur": 1000.0},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "dur": 500.0},
        {"ph": "X", "cat": "kernel", "name": "nms_keep", "dur": 200.0},
        {"ph": "X", "cat": "cpu_op", "name": "aten::conv2d", "dur": 9000.0},
        {"ph": "i", "cat": "kernel", "name": "marker"}]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    assert train_profile.trace_top_ops(str(path), steps=2, n=2) == [
        ["conv", 2.0, 1.0], ["Memcpy HtoD", 0.25, 0.5]]
