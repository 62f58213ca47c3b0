"""BENCHMARK.json against the benchmark's contract: keys, names, units,
limits of the run length and bounds, and that every cell's files exist."""

import json
import os
import re

import pytest

from benchmark import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SPEC = harness.spec()


def _text(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level_keys_and_command():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["command"] == ["python3", "benchmark/run.py"]
    assert SPEC["paths"] == ["benchmark"]
    assert os.path.getsize(os.path.join(harness.ROOT, "BENCHMARK.json")) \
        <= 64 * 1024


def test_run_seconds_fit_a_full_check_of_24_cells():
    rs = SPEC["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end",
                                  "per_layer"])
def test_names_units_and_texts(kind):
    names = [e["name"] for e in SPEC[kind]]
    assert len(names) == len(set(names))
    for e in SPEC[kind]:
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
        for key in ("why", "layer", "source"):
            if key in e:
                assert _text(e[key]), (e["name"], key)
        for key in ("config", "traffic"):
            if key in e:
                assert NAME.match(e[key])
        for key in e.get("reduced", []):
            assert NAME.match(key)


def _check_entries(end_to_end, per_layer):
    for m in end_to_end:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in per_layer:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        for key in ("layer", "source"):
            assert _text(m[key]), (m["name"], key)
    for m in end_to_end + per_layer:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]), m["name"]
        assert m["better"] in ("lower", "higher")


def test_entry_keys():
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4)
    _check_entries(SPEC["end_to_end"], SPEC["per_layer"])


LISTED = [w["name"] for w in SPEC["workloads"]]
# cells held out of BENCHMARK.json (PERF.md, Open questions): each has its
# files and, in held/<cell>.json, its metric entries in BENCHMARK.json's
# form; it is admitted by copying those entries and adding its configs and
# workloads entries
HELD = sorted(f[:-5] for f in os.listdir(os.path.join(harness.BENCH, "held"))
              if f.endswith(".json"))


def test_metrics_name_only_listed_cells_and_held_entries_only_held_ones():
    assert HELD == ["slam_euroc.loop"]
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert set(m.get("workloads", LISTED)) <= set(LISTED), m["name"]
    names = {m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]}
    for name in HELD:
        assert name not in LISTED
        assert os.path.isfile(os.path.join(harness.BENCH, "workloads",
                                           name + ".json")), name
        assert harness.Cell(name).config["name"] not in {
            c["name"] for c in SPEC["configs"]}
        held = harness.held_metrics(name)
        assert set(held) == {"end_to_end", "per_layer"}
        for m in held["end_to_end"] + held["per_layer"]:
            assert m["workloads"] == [name] and m["name"] not in names
        _check_entries(held["end_to_end"], held["per_layer"])


@pytest.mark.parametrize("name", LISTED + HELD)
def test_every_cell_reports_setup_another_metric_and_a_layer(name):
    assert "setup_s" in {m["name"] for m in SPEC["end_to_end"]}
    cell = harness.Cell(name)
    e2e = {m["name"] for m in cell.end_to_end()}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cell.per_layer()


def test_the_held_slam_cell_lists_its_metrics():
    cell = harness.Cell("slam_euroc.loop")
    assert [m["name"] for m in cell.end_to_end()] == [
        "setup_s", "slam_frames_per_s", "slam_frame_ms_p90"]
    assert sorted(m["name"] for m in cell.per_layer()) == sorted(
        "slam." + n for n in ("extract_ms", "track_ms", "local_ba_ms",
                              "closure_ms", "launches_per_frame",
                              "device_idle", "orb_roofline"))
    assert "slam_frames_per_s" not in {
        m["name"] for m in harness.Cell("orb_kitti.stream").end_to_end()}


@pytest.mark.parametrize("name", LISTED + HELD)
def test_each_layer_metric_of_a_cell_moves_one_it_reports_and_can_be_read(
        name):
    cell = harness.Cell(name)
    e2e = {e["name"] for e in cell.end_to_end()}
    for m in cell.per_layer():
        assert m["moves"] in e2e, (m["name"], name)
        assert callable(harness.load_module("metrics", m["name"]).read)


def test_every_cell_finds_its_files_by_name():
    for c in SPEC["configs"]:
        assert c["file"] == f"benchmark/configs/{c['name']}.json"
        cfg = harness.load_json(os.path.join(harness.ROOT, c["file"]))
        assert cfg["reduced"] == c["reduced"]
        harness.load_module("drivers", cfg["driver"])
    for w in SPEC["workloads"]:
        cell = harness.Cell(w["name"])
        harness.load_module("traffic", cell.traffic["generator"])
    for m in SPEC["per_layer"]:
        assert callable(harness.load_module("metrics", m["name"]).read)


def test_configs_are_used_and_limits_stated():
    used = {w["config"] for w in SPEC["workloads"]}
    assert used == {c["name"] for c in SPEC["configs"]}
    for c in SPEC["configs"]:
        cfg = harness.load_json(os.path.join(harness.ROOT, c["file"]))
        assert cfg["limits"] and cfg["control_dtype"] == "bfloat16"
        json.dumps(cfg)
