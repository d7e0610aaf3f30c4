"""The port's config: the default ``cfg`` tree and its YAML / CLI overrides.

A copy of the part of ``tf_faster_rcnn_tpu/config.py`` that the port reads,
so that the port imports nothing of the JAX package: the same keys, the same
defaults (``tests/test_torch_resnet.py`` holds them equal key for key) and
the same merge rules, so the reference's ``experiments/cfgs/*.yml`` files
and ``KEY.SUBKEY value`` overrides load identically; and the same output
directory and canvas rules (``get_output_dir``, ``get_output_tb_dir``,
``canvas_hw``, ``canvas_buckets``, ``bucket_index``, ``mixed_canvas``).
The model never reads cfg while it runs: ``models/network.py::
spec_from_cfg`` snapshots it into a ``ModelSpec``.
"""

from __future__ import annotations

import os
import os.path as osp
from ast import literal_eval

import numpy as np

__all__ = ["AttrDict", "STRUCTURAL_KEYS", "VESTIGIAL_KEYS", "bucket_index",
           "canvas_buckets", "canvas_hw", "cfg", "cfg_from_file",
           "cfg_from_list", "get_output_dir", "get_output_tb_dir",
           "mixed_canvas", "reset_cfg"]


class AttrDict(dict):
    """dict with attribute access."""

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError:
            raise AttributeError(name)

    def __setattr__(self, name, value):
        self[name] = value


def _default_cfg() -> AttrDict:
    """The default tree, key for key that of the JAX package."""
    C = AttrDict()

    C.TRAIN = AttrDict()
    C.TRAIN.LEARNING_RATE = 0.001
    C.TRAIN.MOMENTUM = 0.9
    C.TRAIN.WEIGHT_DECAY = 0.0001
    C.TRAIN.GAMMA = 0.1
    C.TRAIN.STEPSIZE = [30000]
    C.TRAIN.DISPLAY = 10
    C.TRAIN.DOUBLE_BIAS = True
    C.TRAIN.TRUNCATED = False
    C.TRAIN.BIAS_DECAY = False
    C.TRAIN.USE_GT = False
    C.TRAIN.ASPECT_GROUPING = False
    C.TRAIN.SNAPSHOT_KEPT = 3
    C.TRAIN.SUMMARY_INTERVAL = 180
    C.TRAIN.SCALES = (600,)
    C.TRAIN.MAX_SIZE = 1000
    C.TRAIN.IMS_PER_BATCH = 1
    C.TRAIN.BATCH_SIZE = 128
    C.TRAIN.FG_FRACTION = 0.25
    C.TRAIN.FG_THRESH = 0.5
    C.TRAIN.BG_THRESH_HI = 0.5
    C.TRAIN.BG_THRESH_LO = 0.1
    C.TRAIN.USE_FLIPPED = True
    C.TRAIN.BBOX_REG = True
    C.TRAIN.BBOX_THRESH = 0.5
    C.TRAIN.SNAPSHOT_ITERS = 5000
    C.TRAIN.SNAPSHOT_PREFIX = 'res101_faster_rcnn'
    C.TRAIN.BBOX_NORMALIZE_TARGETS = True
    C.TRAIN.BBOX_INSIDE_WEIGHTS = (1.0, 1.0, 1.0, 1.0)
    C.TRAIN.BBOX_NORMALIZE_TARGETS_PRECOMPUTED = True
    C.TRAIN.BBOX_NORMALIZE_MEANS = (0.0, 0.0, 0.0, 0.0)
    C.TRAIN.BBOX_NORMALIZE_STDS = (0.1, 0.1, 0.2, 0.2)
    C.TRAIN.PROPOSAL_METHOD = 'gt'
    C.TRAIN.HAS_RPN = True
    C.TRAIN.RPN_POSITIVE_OVERLAP = 0.7
    C.TRAIN.RPN_NEGATIVE_OVERLAP = 0.3
    C.TRAIN.RPN_CLOBBER_POSITIVES = False
    C.TRAIN.RPN_FG_FRACTION = 0.5
    C.TRAIN.RPN_BATCHSIZE = 256
    C.TRAIN.RPN_NMS_THRESH = 0.7
    C.TRAIN.RPN_PRE_NMS_TOP_N = 12000
    C.TRAIN.RPN_POST_NMS_TOP_N = 2000
    C.TRAIN.RPN_BBOX_INSIDE_WEIGHTS = (1.0, 1.0, 1.0, 1.0)
    C.TRAIN.RPN_POSITIVE_WEIGHT = -1.0
    C.TRAIN.USE_ALL_GT = True

    C.TEST = AttrDict()
    C.TEST.SCALES = (600,)
    C.TEST.MAX_SIZE = 1000
    C.TEST.NMS = 0.3
    C.TEST.SVM = False
    C.TEST.BBOX_REG = True
    C.TEST.HAS_RPN = False
    C.TEST.PROPOSAL_METHOD = 'gt'
    C.TEST.RPN_NMS_THRESH = 0.7
    C.TEST.RPN_PRE_NMS_TOP_N = 6000
    C.TEST.RPN_POST_NMS_TOP_N = 300
    C.TEST.MODE = 'nms'
    C.TEST.RPN_TOP_N = 5000

    C.RESNET = AttrDict()
    C.RESNET.MAX_POOL = False
    C.RESNET.FIXED_BLOCKS = 1

    C.MOBILENET = AttrDict()
    C.MOBILENET.REGU_DEPTH = False
    C.MOBILENET.FIXED_LAYERS = 5
    C.MOBILENET.WEIGHT_DECAY = 0.00004
    C.MOBILENET.DEPTH_MULTIPLIER = 1.

    C.PIXEL_MEANS = np.array([[[102.9801, 115.9465, 122.7717]]])
    C.RNG_SEED = 3
    C.ROOT_DIR = osp.abspath(osp.join(osp.dirname(__file__), '..'))
    C.DATA_DIR = osp.abspath(osp.join(C.ROOT_DIR, 'data'))
    C.MATLAB = 'matlab'
    C.EXP_DIR = 'default'
    C.USE_GPU_NMS = True
    C.USE_E2E_TF = True
    C.POOLING_MODE = 'crop'
    C.POOLING_SIZE = 7
    C.ANCHOR_SCALES = [8, 16, 32]
    C.ANCHOR_RATIOS = [0.5, 1, 2]
    C.RPN_CHANNELS = 512

    # The JAX package's own section, kept whole so that its YAML files load;
    # spec_from_cfg reads RPN_NMS_CAP and MAX_PER_IMAGE and refuses the
    # SPACE_TO_DEPTH stem and USE_PALLAS_NMS False (NMS always runs the
    # CUDA kernels K1 and K2 on the card).
    C.TPU = AttrDict()
    C.TPU.CANVAS_SIZE = [0, 0]
    C.TPU.MAX_GT = 100
    C.TPU.BUCKETING = True
    C.TPU.EVAL_PREFETCH_THREADS = 4
    C.TPU.RPN_NMS_CAP = 0
    C.TPU.IMS_PER_DEVICE = 1
    C.TPU.MODEL_DEVICES = 1
    C.TPU.SPATIAL_PARTITION = True
    C.TPU.COMPUTE_DTYPE = 'float32'
    C.TPU.MAX_PER_IMAGE = 100
    C.TPU.USE_PALLAS_NMS = True
    C.TPU.SPACE_TO_DEPTH = False
    C.TPU.PARAM_DTYPE = 'float32'
    C.TPU.PREFETCH = 2
    C.TPU.PROFILE_DIR = ''
    C.TPU.CHECKPOINT_BACKEND = 'msgpack'
    C.TPU.EVAL_ITERS = 0
    C.TPU.ASYNC_CHECKPOINT = False
    C.TPU.SUMMARY_ITERS = 500
    C.TPU.AUTO_SCALE_SCHEDULE = True
    C.TPU.WARMUP_ITERS = 500
    C.TPU.WARMUP_FACTOR = 1.0 / 3.0
    C.TPU.NAN_GUARD = True
    C.TPU.NAN_GUARD_PATIENCE = 50

    return C


cfg = _default_cfg()


def reset_cfg():
    """Restore cfg to its defaults in place."""
    fresh = _default_cfg()
    cfg.clear()
    cfg.update(fresh)


# Keys kept for YAML compatibility that no code path reads: the reference
# inherited them from py-faster-rcnn and never reads them either (the JAX
# package's registry, tf_faster_rcnn_tpu/config.py). Overriding one prints a
# warning instead of a silent no-op; tests/test_torch_config.py holds every
# other key to be read somewhere in the port.
VESTIGIAL_KEYS = {
    'TRAIN.BBOX_REG',            # box head + its loss are always built
    'TRAIN.BBOX_THRESH',         # roidb-era fg threshold for bbox targets
    'TRAIN.BBOX_NORMALIZE_TARGETS',  # only *_PRECOMPUTED is consulted
    'TRAIN.HAS_RPN',             # RPN is structural in the e2e model
    'TEST.HAS_RPN',              # idem (demo.py sets it; nothing reads it)
    'TEST.SVM',                  # R-CNN-era SVM head never existed here
    'TEST.PROPOSAL_METHOD',      # external-proposal eval era
}

# Keys the reference honours as implementation-path switches, whose
# behaviour is structural in the port (there is only one path):
STRUCTURAL_KEYS = {
    'USE_E2E_TF': 'the whole pipeline always runs on the device',
    'USE_GPU_NMS': 'NMS always runs the CUDA kernels on the card',
}


def _warn_if_vestigial(dotted_key):
    if dotted_key in VESTIGIAL_KEYS:
        print(f'[config] WARNING: {dotted_key} is accepted for reference '
              f'YAML compatibility but no code path reads it '
              f'(the reference ignores it too)')
    elif dotted_key in STRUCTURAL_KEYS:
        print(f'[config] WARNING: {dotted_key} has no effect here: '
              f'{STRUCTURAL_KEYS[dotted_key]}')


def _merge_a_into_b(a, b, path=""):
    """Recursive type-checked merge of dict a into AttrDict b: unknown keys
    raise KeyError, type mismatches ValueError, except that a value merged
    into an ndarray takes its dtype, a list into a tuple becomes a tuple
    and an int into a float a float."""
    if not isinstance(a, dict):
        return
    for k, v in a.items():
        if k not in b:
            raise KeyError('{} is not a valid config key'.format(k))
        if type(b[k]) is not type(v):
            if isinstance(b[k], np.ndarray):
                v = np.array(v, dtype=b[k].dtype)
            elif isinstance(b[k], tuple) and isinstance(v, list):
                v = tuple(v)
            elif isinstance(b[k], float) and isinstance(v, int):
                v = float(v)
            elif not (isinstance(b[k], dict) and isinstance(v, dict)):
                raise ValueError(
                    'Type mismatch ({} vs. {}) for config key: {}{}'.format(
                        type(b[k]), type(v), path, k))
        if isinstance(v, dict) and isinstance(b[k], dict):
            _merge_a_into_b(v, b[k], path + k + ".")
        else:
            _warn_if_vestigial(path + k)
            b[k] = v


def cfg_from_file(filename):
    """Merge a YAML config file into cfg."""
    import yaml
    with open(filename, 'r') as f:
        yaml_cfg = yaml.safe_load(f)
    if yaml_cfg is not None:
        _merge_a_into_b(yaml_cfg, cfg)


def cfg_from_list(cfg_list):
    """Set config keys from a flat ['KEY.SUBKEY', 'value', ...] list."""
    assert len(cfg_list) % 2 == 0
    for k, v in zip(cfg_list[0::2], cfg_list[1::2]):
        key_list = k.split('.')
        d = cfg
        for subkey in key_list[:-1]:
            assert subkey in d, 'invalid config key {}'.format(k)
            d = d[subkey]
        subkey = key_list[-1]
        assert subkey in d, 'invalid config key {}'.format(k)
        try:
            value = literal_eval(v)
        except Exception:
            value = v
        assert type(value) == type(d[subkey]), (
            'type {} does not match original type {}'.format(
                type(value), type(d[subkey])))
        _warn_if_vestigial(k)
        d[subkey] = value


def _run_dir(kind, imdb, weights_filename):
    outdir = osp.abspath(osp.join(cfg.ROOT_DIR, kind, cfg.EXP_DIR, imdb.name))
    if weights_filename is None:
        weights_filename = 'default'
    outdir = osp.join(outdir, weights_filename)
    os.makedirs(outdir, exist_ok=True)
    return outdir


def get_output_dir(imdb, weights_filename):
    """The directory of a run's artifacts (snapshots, detections),
    ROOT_DIR/output/EXP_DIR/<imdb name>/<weights name or tag, or
    'default'>, created on demand."""
    return _run_dir('output', imdb, weights_filename)


def get_output_tb_dir(imdb, weights_filename):
    """The directory of a run's metrics and TensorBoard events,
    ROOT_DIR/tensorboard/EXP_DIR/<imdb name>/<tag or 'default'>, created on
    demand."""
    return _run_dir('tensorboard', imdb, weights_filename)


def canvas_hw(phase_cfg) -> tuple:
    """The square (H, W) canvas of a phase: TPU.CANVAS_SIZE when set, else
    MAX_SIZE rounded up to a multiple of 32 (every backbone stage then has
    integral sizes, and the stride-16 feature map is exactly H/16 x W/16)."""
    h, w = cfg.TPU.CANVAS_SIZE
    if h and w:
        return int(h), int(w)
    m = int(np.ceil(phase_cfg.MAX_SIZE / 32.0) * 32)
    return m, m


def canvas_buckets(phase_cfg) -> tuple:
    """The canvases of a phase, landscape first: ((ceil32(max(SCALES)),
    ceil32(MAX_SIZE)), its transpose). After the shortest-side resize an
    image's short side is at most max(SCALES) and its long side at most
    MAX_SIZE, so one of the two fits it (VOC: 608x1024 and 1024x608). One
    canvas when TPU.CANVAS_SIZE pins it, TPU.BUCKETING is off, or the two
    would coincide (SCALES >= MAX_SIZE)."""
    h, w = cfg.TPU.CANVAS_SIZE
    if h and w:
        return ((int(h), int(w)),)
    if not cfg.TPU.BUCKETING:
        return (canvas_hw(phase_cfg),)
    s = int(np.ceil(max(phase_cfg.SCALES) / 32.0) * 32)
    m = int(np.ceil(phase_cfg.MAX_SIZE / 32.0) * 32)
    if s >= m:
        return ((m, m),)
    return ((s, m), (m, s))


def bucket_index(im_h, im_w, buckets) -> int:
    """The bucket of an image of extent (im_h, im_w), original or resized
    (a uniform resize keeps the orientation): landscape (w >= h) is 0."""
    if len(buckets) == 1:
        return 0
    return 0 if im_w >= im_h else 1


def mixed_canvas(buckets) -> tuple:
    """The smallest canvas that fits every bucket: a training batch that
    mixes orientations runs on it (evaluation groups by bucket)."""
    return (max(b[0] for b in buckets), max(b[1] for b in buckets))
