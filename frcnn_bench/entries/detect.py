"""The detect entry: batches of the pool through ``make_detect_fn``'s
function in a closed loop, detections fetched each step
(``frcnn_bench/detect_loop.py``)."""

from frcnn_bench.detect_loop import run

__all__ = ["run"]
