"""Host ms a step inside the port's model.fpn span (the pyramid's laterals,
top-down sums, output convs and P6), median of the traced span's host
steps with tracing on (stages.host_ms); None where the program has no such
span."""

from frcnn_bench.stages import host_ms


def read(record):
    return host_ms(record, "model.fpn")
