"""ORB against its roofline: the least time of the work ORB needs (benchmark/roofline.py) over the device time launched inside the ORB call, in %."""

from benchmark.metrics import _common


def read(rec):
    return _common.orb_roofline_percent(rec, "orb")
