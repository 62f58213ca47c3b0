"""Kernel launches and copies enqueued a frame of the loop (CUPTI runtime records of the traced frames)."""

from benchmark.metrics import _common


def read(rec):
    return _common.launches_per_frame(rec)
