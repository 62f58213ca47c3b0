"""Host wall ms a frame of ORB's describe stage: blur, paired windows, orientation, BRIEF (the program's `features.orb.describe` span)."""

from benchmark.metrics import _common


def read(rec):
    return _common.span_ms(rec, "features.orb.describe")
