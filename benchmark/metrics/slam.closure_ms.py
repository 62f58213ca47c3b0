"""Host wall ms of `MonocularSlam._try_loop_closure` on the calls that closed a loop (BoW query, PnP check, PGO, point drag, global BA)."""

from benchmark.metrics import _common


def read(rec):
    return _common.mean_ms([r for r in rec["spans"].of("_try_loop_closure")
                            if r[3][1]])
