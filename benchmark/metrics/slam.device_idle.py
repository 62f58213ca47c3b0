"""Share of the traced frames' wall time in which the device ran nothing, in %."""

from benchmark.metrics import _common


def read(rec):
    return _common.idle_percent(rec)
