"""Kernel launches and copies enqueued a frame (ORB, match, read-back)."""

from benchmark.metrics import _common


def read(rec):
    return _common.launches_per_frame(rec)
