"""Share of the traced span's wall time with no kernel, copy or memset on
the device."""

from frcnn_bench.readers import idle_pct as read

__all__ = ["read"]
