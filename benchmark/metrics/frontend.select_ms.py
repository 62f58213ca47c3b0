"""Host wall ms a frame of ORB's keypoint selection, every level (the program's `features.orb.select` spans)."""

from benchmark.metrics import _common


def read(rec):
    return _common.span_ms(rec, "features.orb.select")
