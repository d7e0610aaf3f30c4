"""K2 (frcnn::batched_nms_keep, a detect step's second NMS launch) against
its roofline: the bound of its call on the reference's per-class boxes
over its device time in the traced span."""

from frcnn_bench.readers import nms_roofline


def read(record):
    return nms_roofline(record, 1)
