"""Cells of the benchmark at a size a CPU test run holds: the committed
cell's files, with the canvas, the proposal and RoI counts, the crop and
the pool cut down, and ResNet-50 in ResNet-101's place (the port builds
ResNet depths by name)."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from frcnn_bench import harness  # noqa: E402


def tiny(name, compute_dtype=None):
    """The cell called name, cut to a CPU test's size."""
    cell = harness.load_cell(name)
    config = cell.config
    c = config["cfg"]
    if config["backbone"] == "res101":
        config["backbone"] = "res50"
        config["net"]["units"] = [3, 4, 6, 3]
    if compute_dtype:
        c["TPU"]["COMPUTE_DTYPE"] = compute_dtype
    c["TEST"].update(SCALES=[64], MAX_SIZE=96, RPN_PRE_NMS_TOP_N=200,
                     RPN_POST_NMS_TOP_N=12)
    c["TRAIN"].update(SCALES=[64], MAX_SIZE=96, RPN_PRE_NMS_TOP_N=300,
                      RPN_POST_NMS_TOP_N=40, BATCH_SIZE=8, RPN_BATCHSIZE=32)
    c["TPU"].update(MAX_GT=6, MAX_PER_IMAGE=20)
    c["POOLING_SIZE"] = 3
    cell.traffic.update(pool=12, long_side=80, short_side=[56, 72],
                        batch=min(cell.traffic["batch"], 2))
    cell.spec.update(sample_steps=2, sample_within=3, trace_steps=2)
    return cell
