"""Tiny dry runs of the cells on the CPU through the plain route: the
whole run (set-up, window, judge, result line) at half the image size."""

import json

import pytest

from conftest import dry_run
from benchmark import harness


def test_front_end_stream_dry_run_is_correct_and_well_formed():
    res, line = dry_run("orb_kitti.stream", 4.0)
    assert line["correct"] is True, res["check"].lines()
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "compared"
    cell = harness.Cell("orb_kitti.stream")
    assert set(line["metrics"]) == {m["name"] for m in cell.end_to_end()}
    for m in line["metrics"].values():
        assert m["value"] > 0
    assert line["attempted"] >= 2 and line["failed"] == 0
    json.dumps(line)


def test_slam_loop_dry_run_closes_loops_and_its_stages_agree():
    # the held-out cell (PERF.md, Open questions) on a seed that
    # bootstraps, whole sessions in the window. At half the image the
    # trajectory drifts past the configuration's ATE guarantee, which
    # holds for the full size; the stages' numbers hold at any size.
    res, _ = dry_run("slam_euroc.loop", 60.0, seed=0)
    rows = {n: (v, lim) for n, v, lim, _ in res["check"].rows}
    for name in ("orb_miss", "track_gap", "local_ba_gap", "global_ba_gap",
                 "pgo_gap"):
        assert rows[name][0] <= rows[name][1], res["check"].lines()
    assert rows["loops"][0] >= 1 and rows["tracked_share"][0] >= 0.7
    assert res["attempted"] >= 40


@pytest.mark.parametrize("name", ["orb_kitti.stream"])
def test_control_at_a_tiny_size_is_not_correct(name):
    res, _ = dry_run(name, 4.0, control=True)
    assert res["check"].correct is True
    assert res["control"].correct is False, res["control"].lines()


@pytest.fixture(scope="module")
def slam_short():
    """The held SLAM cell with a window that ends early in its first
    session, before the return path's loops, judged with its control."""
    res, _ = dry_run("slam_euroc.loop", 4.0, seed=0, control=True)
    return res


def _failed(check):
    return {n for n, v, lim, kind in check.rows
            if not (v <= lim if kind == "<=" else v >= lim)}


def test_slam_loop_judges_every_session_whole(slam_short):
    # the session the window closed in runs to its end untimed: each
    # session is judged whole, its return path's loops included
    per_session = harness.Cell("slam_euroc.loop").traffic["frames"]
    n = len(slam_short["record"]["kinds"])
    assert n % per_session == 0 and n >= slam_short["attempted"]
    rows = {r[0]: r[1] for r in slam_short["check"].rows}
    assert rows["loops"] >= 1, slam_short["check"].lines()


def test_slam_loop_control_at_a_tiny_size_fails_what_the_program_passes(
        slam_short):
    # at half the image the program itself misses the full-size ATE
    # guarantee, so the control is held to the numbers the program passes
    only_control = _failed(slam_short["control"]) - _failed(
        slam_short["check"])
    assert only_control, (slam_short["check"].lines(),
                          slam_short["control"].lines())
