"""roidb enrichment and filtering.

A copy of ``tf_faster_rcnn_tpu/data/roidb.py``: attach each image's path and
size and each roi's max overlap and its class (the reference's
roi_data_layer/roidb.py:19-49), and drop the images with neither a usable
fg nor bg roi (train_val.py:338-360). Flipped entries (index >= num_images)
share their base image's size; COCO entries carry their width and height in
the annotation record, so sizes are probed from disk only for the others,
from the file's header (``data/blob.py::image_size``), not through PIL.
"""

from __future__ import annotations

from tf_faster_rcnn_torch.config import cfg
from tf_faster_rcnn_torch.data.blob import image_size

__all__ = ["filter_roidb", "prepare_roidb"]


def prepare_roidb(imdb):
    """Attach image metadata and max-overlap stats to every roidb entry."""
    n_base = imdb.num_images
    probe_sizes = not imdb.name.startswith("coco")
    sizes = ([image_size(imdb.image_path_at(i)) for i in range(n_base)]
             if probe_sizes else None)

    for i, entry in enumerate(imdb.roidb):
        entry["image"] = imdb.image_path_at(i)
        if sizes is not None:
            entry["height"], entry["width"] = sizes[i % n_base]

        overlaps = entry["gt_overlaps"].toarray()
        entry["max_overlaps"] = overlaps.max(axis=1)
        entry["max_classes"] = overlaps.argmax(axis=1)

        # zero overlap -> background class 0; positive overlap -> a
        # foreground class (reference roidb.py:43-49). COCO crowd rois carry
        # overlap -1 for every class and are exempt from both checks, as
        # the reference's "> 0" test exempts them.
        is_bg = entry["max_overlaps"] == 0
        if not (entry["max_classes"][is_bg] == 0).all():
            raise ValueError(f"{entry['image']}: background roi with a "
                             "nonzero class")
        is_fg = entry["max_overlaps"] > 0
        if not (entry["max_classes"][is_fg] != 0).all():
            raise ValueError(f"{entry['image']}: foreground roi mapped to "
                             "class 0")


def _has_usable_rois(entry) -> bool:
    ov = entry["max_overlaps"]
    any_fg = bool((ov >= cfg.TRAIN.FG_THRESH).any())
    any_bg = bool(((ov < cfg.TRAIN.BG_THRESH_HI)
                   & (ov >= cfg.TRAIN.BG_THRESH_LO)).any())
    return any_fg or any_bg


def filter_roidb(roidb):
    """Drop entries with no sampleable fg or bg roi (train_val.py:338-360)."""
    kept = [e for e in roidb if _has_usable_rois(e)]
    print("Filtered {} roidb entries: {} -> {}".format(
        len(roidb) - len(kept), len(roidb), len(kept)))
    return kept
