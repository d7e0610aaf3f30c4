"""K1 (frcnn::nms_keep_mask, a step's first NMS launch) against its
roofline: the bound of its call on the reference's own pre-NMS proposals
over its device time in the traced span."""

from frcnn_bench.readers import nms_roofline


def read(record):
    return nms_roofline(record, 0)
