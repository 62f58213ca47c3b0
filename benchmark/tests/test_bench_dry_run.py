"""Tiny dry runs of the cells on the CPU through the plain route: the
whole run (set-up, window, judge, result line) at half the image size."""

import json

import pytest

from conftest import card_trace_on_cpu, dry_run
from benchmark import harness


@pytest.mark.parametrize("trace", [False, True])
def test_front_end_stream_dry_run_is_correct_and_well_formed(monkeypatch,
                                                            trace):
    if trace:
        card_trace_on_cpu(monkeypatch)
    res, line = dry_run("orb_kitti.stream", 4.0, trace=trace)
    assert line["correct"] is True, res["check"].lines()
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "compared"
    assert line["attempted"] >= 2 and line["failed"] == 0
    json.dumps(line)
    cell = harness.Cell("orb_kitti.stream")
    if not trace:
        assert set(line["metrics"]) == {m["name"] for m in cell.end_to_end()}
        assert all(m["value"] > 0 for m in line["metrics"].values())
        return
    # every per-layer reader of the cell reads the --trace 1 record; on
    # the CPU the trace holds no device record, so the roofline finds
    # nothing and the counts of launches and syncs read 0
    got = {m["name"]: harness.load_module("metrics", m["name"]).read(
        res["record"]) for m in cell.per_layer()}
    assert len(got) == 9 and all(n.startswith("frontend.") for n in got)
    assert got.pop("frontend.orb_roofline") is None
    assert got.pop("frontend.device_idle") == 100.0
    for name in ("frontend.launches_per_frame",
                 "frontend.select_launches_per_frame",
                 "frontend.host_syncs_per_frame"):
        assert got.pop(name) == 0.0
    assert all(v > 0 for v in got.values()), got
    assert {n: v["value"] for n, v in line["metrics"].items()} == dict(
        got, **{"frontend.device_idle": 100.0,
                "frontend.launches_per_frame": 0.0,
                "frontend.select_launches_per_frame": 0.0,
                "frontend.host_syncs_per_frame": 0.0})
    labels = {label for label, _ in line["breakdown"]["idle_gaps"]}
    assert labels == {"frame end"}


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
    session, before the return path's loops, judged with its control,
    traced as a --trace 1 run is (the card's part stood in for)."""
    with pytest.MonkeyPatch.context() as mp:
        card_trace_on_cpu(mp)
        return dry_run("slam_euroc.loop", 4.0, seed=0, control=True,
                       trace=True)


def _failed(check):
    return {n for n, v, lim, kind in check.rows
            if not (v <= lim if kind == "<=" else v >= lim)}


def test_slam_loop_judges_every_session_whole(slam_short):
    # the session the window closed in runs to its end untimed: each
    # session is judged whole, its return path's loops included
    res, _ = slam_short
    per_session = harness.Cell("slam_euroc.loop").traffic["frames"]
    n = len(res["record"]["kinds"])
    assert n % per_session == 0 and n >= res["attempted"]
    rows = {r[0]: r[1] for r in res["check"].rows}
    assert rows["loops"] >= 1, res["check"].lines()


def test_slam_loop_control_at_a_tiny_size_fails_what_the_program_passes(
        slam_short):
    # at half the image the program itself misses the full-size ATE
    # guarantee, so the control is held to the numbers the program passes
    res, _ = slam_short
    only_control = _failed(res["control"]) - _failed(res["check"])
    assert only_control, (res["check"].lines(), res["control"].lines())


def test_slam_loop_traced_line_carries_the_program_rows_and_its_readers(
        slam_short):
    # the held cell's --trace 1 record keeps the rows ORB records inside
    # _extract, and its line holds only the seven slam.* readers
    res, line = slam_short
    cell = harness.Cell("slam_euroc.loop")
    names = {m["name"] for m in cell.per_layer()}
    assert len(names) == 7 and all(n.startswith("slam.") for n in names)
    assert set(line["metrics"]) <= names
    assert line["metrics"]["slam.extract_ms"]["value"] > 0
    extract = res["record"]["spans"].of("_extract")
    orb = [r for r in res["record"]["program"] if r[0] == "features.orb"]
    assert len(orb) == len(extract) > 0
    assert all(any(e[1] <= r[1] and r[2] <= e[2] for e in extract)
               for r in orb)
