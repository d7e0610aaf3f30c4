"""Host ms a step inside the port's model.pyramid_crop span (each RoI's
level and the one-pass crop from P2-P5), median of the traced span's host
steps with tracing on (stages.host_ms); None where the program has no such
span."""

from frcnn_bench.stages import host_ms


def read(record):
    return host_ms(record, "model.pyramid_crop")
