"""Host wall ms a frame of the matcher (the program's `features.matching` span)."""

from benchmark.metrics import _common


def read(rec):
    return _common.span_ms(rec, "features.matching")
