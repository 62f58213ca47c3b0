"""Host wall ms of the loop's ORB stage (`MonocularSlam._extract`: upload, ORB, the read-backs) a frame."""

from benchmark.metrics import _common


def read(rec):
    return _common.mean_ms(rec["spans"].of("_extract"))
