"""Kernel launches and copies a frame enqueued inside ORB's keypoint selection (the program's `features.orb.select` spans)."""

from benchmark.metrics import _common


def read(rec):
    return _common.launches_in(rec, "features.orb.select")
