"""Dataset registry: imdb name -> lazily-imported constructor.

A copy of ``tf_faster_rcnn_tpu/datasets/factory.py`` that builds the port's
datasets.

Covers the reference's factory surface (reference lib/datasets/
factory.py:20-52): ``voc_{2007,2012}_{train,val,trainval,test}[_diff]``
plus the coco_2014 train/val/minival/valminusminival/trainval and
coco_2015 test/test-dev splits. Construction is declarative — the table
below lists (year, splits) per family and the names are derived — and
imports happen only when a dataset is actually instantiated, so e.g. the
COCO annotation machinery never loads for a VOC run.
"""

from __future__ import annotations

_VOC_SPLITS = ("train", "val", "trainval", "test")
_COCO_SPLITS = {
    "2014": ("train", "val", "minival", "valminusminival", "trainval"),
    "2015": ("test", "test-dev"),
}


def _make_voc(split: str, year: str, use_diff: bool):
    from tf_faster_rcnn_torch.datasets.pascal_voc import pascal_voc
    return pascal_voc(split, year, use_diff=use_diff)


def _make_coco(split: str, year: str):
    from tf_faster_rcnn_torch.datasets.coco import coco
    return coco(split, year)


def _registry() -> dict:
    table = {}
    for year in ("2007", "2012"):
        for split in _VOC_SPLITS:
            for suffix, diff in (("", False), ("_diff", True)):
                table[f"voc_{year}_{split}{suffix}"] = (
                    _make_voc, (split, year, diff))
    for year, splits in _COCO_SPLITS.items():
        for split in splits:
            table[f"coco_{year}_{split}"] = (_make_coco, (split, year))
    return table


_REGISTRY = _registry()


def get_imdb(name: str):
    """Instantiate the imdb registered under ``name``."""
    try:
        build, build_args = _REGISTRY[name]
    except KeyError:
        raise KeyError(f"Unknown dataset: {name}") from None
    return build(*build_args)


def list_imdbs() -> list:
    """All registered imdb names."""
    return list(_REGISTRY)
