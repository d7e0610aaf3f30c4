"""Model FLOPs of the window's images (frcnn_bench/flops.py) over the
window's seconds, as a share of the card's bf16 dense peak."""

from frcnn_bench.readers import step_mfu as read

__all__ = ["read"]
