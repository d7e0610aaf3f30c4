"""Device ms a step of the elementwise kernel family (FrozenBN's scale and
shift, casts, relu) in the traced span."""

from frcnn_bench.readers import family_ms


def read(record):
    return family_ms(record, "elementwise")
