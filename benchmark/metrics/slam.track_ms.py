"""Host wall ms of `MonocularSlam._track` (the packed match, PnP RANSAC, the reprojection LM, the read-backs) on frames that are tracked and make no keyframe."""

from benchmark.metrics import _common


def read(rec):
    kinds = rec["kinds"]
    return _common.mean_ms([r for r in rec["spans"].of("_track")
                            if kinds[r[3][0]] == "tracked"])
