"""The proposal stage's NMS (frcnn::nms_keep_mask over every image and
pyramid level, a detect step's first NMS launch) against its roofline: the
bound of its call on the reference's per-level candidates over its device
time in the traced span."""

from frcnn_bench.readers import nms_roofline


def read(record):
    return nms_roofline(record, 0)
