"""The loop's ORB stage against its roofline: the least time of the work ORB needs (benchmark/roofline.py) over the device time launched inside `_extract`, in %."""

from benchmark.metrics import _common


def read(rec):
    return _common.orb_roofline_percent(rec, "_extract")
