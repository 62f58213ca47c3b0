"""Host wall ms of `orb_detect_and_describe` a frame (upload and ORB, up to its return)."""

from benchmark.metrics import _common


def read(rec):
    return _common.mean_ms(rec["spans"].of("orb"))
