"""Host ms from the step call to its return, with no sync: the mean over
the untraced window's steps."""

from frcnn_bench.readers import host_enqueue_ms as read

__all__ = ["read"]
