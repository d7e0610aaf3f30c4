"""The request entry: one image a request, back to back from one client,
each on its own orientation's canvas, timed from the uint8 image on the
host to its detections on the host (``frcnn_bench/detect_loop.py`` at the
traffic's batch of 1)."""

from frcnn_bench.detect_loop import run

__all__ = ["run"]
