"""Runtime calls a frame that made the host wait for the device (synchronisations, blocking copies) inside the harness's or the program's spans."""

from benchmark.metrics import _common


def read(rec):
    return _common.host_syncs(rec)
