"""Host wall ms of a local bundle adjustment (`MonocularSlam._local_ba`), each call."""

from benchmark.metrics import _common


def read(rec):
    return _common.mean_ms(rec["spans"].of("_local_ba"))
