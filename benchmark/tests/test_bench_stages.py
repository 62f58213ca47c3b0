"""The tracer with the program's span rows: the indexed innermost lookup
against a linear scan, the tracer on fake profiler sessions, the
per-layer readers and the stage breakdown (benchmark/stages.py) on
synthetic records, and on the card one traced frame of the front end."""

import copy
import random
import time
import types

import pytest
import torch
from torch.autograd import DeviceType

from conftest import Event
from benchmark import harness, stages
from benchmark.metrics import _common
from benchmark.trace import Traced
from kornia_tpu_torch.utils import tracing

CARD = "NVIDIA H100 80GB HBM3"
EXISTING = ("frontend.orb_ms", "frontend.launches_per_frame",
            "frontend.device_idle", "frontend.orb_roofline")
STAGE = ("frontend.select_ms", "frontend.select_launches_per_frame",
         "frontend.describe_ms", "frontend.match_ms",
         "frontend.host_syncs_per_frame")


def _read(name, rec):
    return harness.load_module("metrics", name).read(rec)


def _linear_innermost(rows, t_ns):
    """The shortest row that holds ``t_ns``, the first among equals."""
    best, width = harness.OUTSIDE, None
    for name, t0, t1, _ in rows:
        if t0 <= t_ns < t1 and (width is None or t1 - t0 < width):
            best, width = name, t1 - t0
    return best


def _nested_rows(rng, t0, t1, depth, rows):
    """Random rows that nest inside [t0, t1): siblings in order, some
    empty, some repeated with the same interval."""
    t = t0
    while t < t1 and len(rows) < 400:
        a = rng.randint(t, t1)
        b = rng.randint(a, min(t1, a + rng.randint(0, (t1 - t0) // 2 + 1)))
        rows.append((f"s{len(rows)}", a, b, None))
        if rng.random() < 0.1:
            rows.append((f"s{len(rows)}", a, b, None))
        if depth and b - a > 2:
            _nested_rows(rng, a, b, depth - 1, rows)
        t = b + rng.randint(0, 3)
    return rows


@pytest.mark.parametrize("seed", range(6))
def test_indexed_innermost_equals_the_linear_scan(seed):
    rng = random.Random(seed)
    rows = _nested_rows(rng, 0, 5000, 4, [])
    rng.shuffle(rows)
    index = harness.SpanIndex(rows)
    times = {t + d for _, a, b, _ in rows for t in (a, b) for d in (-1, 0, 1)}
    times |= {rng.randint(-10, 5010) for _ in range(500)}
    for t in sorted(times):
        assert index.innermost(t) == _linear_innermost(rows, t), t


def _session(base):
    """One frame's raw records on the profiler's clock, starting at
    ``base``: two kernels, a copy, a device record whose launch was lost,
    three synchronisations and the clock marker."""
    cpu, gpu = DeviceType.CPU, DeviceType.CUDA
    return [
        Event(cpu, "cudaLaunchKernel", base + 100, 5, 1),
        Event(gpu, "void fast_harris_kernel<true, true, 9>", base + 150,
               40, 1),
        Event(cpu, "cudaMemcpyAsync", base + 200, 5, 2),
        Event(gpu, "Memcpy DtoH (Device -> Pageable)", base + 260, 10, 2),
        Event(cpu, "cudaStreamSynchronize", base + 210, 60, 3),
        Event(cpu, "cudaMemcpy", base + 300, 20, 4),
        Event(gpu, "Memcpy HtoD (Pageable -> Device)", base + 305, 10, 4),
        Event(gpu, "void brief_rotated_kernel<true, false>", base + 400,
               30, 5),
        Event(cpu, "cudaLaunchKernel", base + 350, 5, 6),
        Event(gpu, "elementwise_kernel", base + 420, 20, 6),
        Event(cpu, "cudaDeviceSynchronize", base + 500, 10, 7),
        Event(cpu, "cudaLaunchKernel", base + 600, 5, 8),
        Event(gpu, "spin_kernel", base + 610, 10, 8),
        Event(cpu, "cudaDeviceSynchronize", base + 620, 10, 9),
    ]


@pytest.fixture
def fake_profiler(monkeypatch):
    """torch.profiler.profile replaced by sessions that hand back
    ``_session`` records, the card's calls by no-ops, and a host clock
    whose reads in a session are ``reads`` ns (by default start, end and
    marker: 0, 700 and 750) after 10,000 + 1,000 a session (reset with
    ``restart(reads)``)."""
    state = {"base": 0, "reads": 0, "seq": (0, 700, 750)}

    class Profile:
        def __init__(self, activities):
            events = _session(state["base"])
            self.profiler = types.SimpleNamespace(
                kineto_results=types.SimpleNamespace(events=lambda: events))

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            state["base"] += 1000
            return False

    def clock():
        k, pos = divmod(state["reads"], len(state["seq"]))
        state["reads"] += 1
        return 10_000 + 1000 * k + state["seq"][pos]

    def restart(reads=(0, 700, 750)):
        state.update(base=0, reads=0, seq=reads)

    monkeypatch.setattr(torch.profiler, "profile", Profile)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "_sleep", lambda *a: None)
    monkeypatch.setattr(time, "perf_counter_ns", clock)
    return restart


def test_the_tracer_keeps_records_syncs_and_every_program_row(
        fake_profiler):
    # each frame opens a program span with a count inside it: a row of
    # zero width whose attr holds the number
    fake_profiler((0, 100, 400, 400, 500, 700, 750))

    def frame():
        with tracing.span("features.orb"):
            with tracing.span("slam.count", 17):
                pass
        return 5

    tr = Traced()
    assert [tr.call(frame) for _ in range(2)] == [5, 5]
    assert [f["launches"] for f in tr.frames] == [4, 4]
    assert len(tr.records) == 10 and tr.frames[1]["records"] == (5, 10)
    # the marker's launch (base + 600) is the host's 750: a record at
    # base + x lies at 150 + x, so the syncs at 210, 300 and 500 fall in
    # the frame (0 to 700) and the one after the marker does not
    at = [10_000 + 1000 * k for k in range(2)]
    assert tr.enqueues == [b + t for b in at for t in (250, 350, 450, 500)]
    assert tr.syncs == [
        (name, b + t) for b in at
        for name, t in (("cudaStreamSynchronize", 360), ("cudaMemcpy", 450),
                        ("cudaDeviceSynchronize", 650))]
    assert tr.rows == [row for b in at for row in (
        ("features.orb", b + 100, b + 500, None),
        ("slam.count", b + 400, b + 400, 17))]
    rec = {"spans": harness.Spans(True), "traced": tr, "program": tr.rows}
    assert [r[3] for r in _common.program(rec, "slam.count")] == [17, 17]
    assert _common.launches_in(rec, "features.orb") == 3.0
    assert _common.host_syncs(rec) == 2.0
    index = harness.SpanIndex(tr.rows)
    assert index.innermost(at[0] + 400) == "features.orb"


def _record(traced, with_program_rows):
    """A run's record: harness spans around ORB, match and the read-back
    of each traced frame, and (in the tracer, as a traced call records
    them) the program's spans inside them."""
    spans = harness.Spans(True)
    tr = copy.copy(traced)
    tr.rows = []
    for f in tr.frames:
        t0 = f["t0"]
        spans.rows += [("orb", t0 + 10, t0 + 400, (0, None)),
                       ("match", t0 + 400, t0 + 480, (0, None)),
                       ("readback", t0 + 480, t0 + 590, (0, None))]
        if with_program_rows:
            tr.rows += [("features.orb", t0 + 20, t0 + 390, None),
                        ("features.orb.upload", t0 + 25, t0 + 60, None),
                        ("features.orb.fast_harris", t0 + 60, t0 + 120,
                         None),
                        ("features.orb.select", t0 + 120, t0 + 250, 0),
                        ("features.orb.describe", t0 + 250, t0 + 385,
                         None),
                        ("features.matching", t0 + 405, t0 + 470, None)]
    return {"spans": spans, "traced": tr, "program": tr.rows, "card": CARD,
            "orb_work": [{"int32": 1e6, "f32": 1e6, "bytes": 1e6}] * len(
                tr.frames)}


def _frames_with_records():
    """A Traced with two frames of hand-made records on the host clock."""
    tr = Traced()
    tr.offset = 0
    for k in range(2):
        t0 = 10_000 * (k + 1)
        r0 = len(tr.records)
        tr.records += [("fast_harris_kernel", t0 + 70, t0 + 90, t0 + 65),
                       ("reduce_kernel", t0 + 200, t0 + 230, t0 + 130),
                       ("brief_rotated_kernel", t0 + 300, t0 + 320,
                        t0 + 260),
                       ("gemm", t0 + 430, t0 + 440, t0 + 410),
                       ("Memcpy DtoH", t0 + 500, t0 + 505, None)]
        tr.frames.append({"t0": t0, "t1": t0 + 600, "wall_ns": 600,
                          "busy_ns": 85, "launches": 5,
                          "records": (r0, len(tr.records))})
    return tr


def test_existing_readers_do_not_move_when_program_rows_merge():
    tr = _frames_with_records()
    alone = {n: _read(n, _record(tr, False)) for n in EXISTING}
    merged = {n: _read(n, _record(tr, True)) for n in EXISTING}
    assert alone == merged and all(v is not None for v in alone.values())
    rec = _record(tr, True)
    labels = {label for label, _ in rec["traced"].idle_gaps(rec["spans"])}
    assert labels >= {"features.orb.select", "features.orb.describe"}
    assert "orb" in {label for label, _ in tr.idle_gaps(rec["spans"])}


def _stage_record():
    """Traced frames with the program's rows, enqueues and syncs: the
    record a traced run leaves."""
    tr = _frames_with_records()
    for f in tr.frames:
        t0 = f["t0"]
        tr.enqueues += [t0 + 5, t0 + 65, t0 + 130, t0 + 140, t0 + 260,
                        t0 + 410, t0 + 490]
        tr.syncs += [("cudaMemcpy", t0 + 40), ("cudaStreamSynchronize",
                                               t0 + 495),
                     ("cudaDeviceSynchronize", t0 + 595)]
    rec = _record(tr, True)
    rec["program"].append(("features.orb", 90_000, 90_100, None))  # outside
    return rec


def test_stage_readers_by_hand():
    rec = _stage_record()
    got = {name: _read(name, rec) for name in STAGE}
    assert got == {"frontend.select_ms": 130 / 1e6,
                   "frontend.select_launches_per_frame": 2.0,
                   "frontend.describe_ms": 135 / 1e6,
                   "frontend.match_ms": 65 / 1e6,
                   "frontend.host_syncs_per_frame": 2.0}
    table = stages.stage_table(rec)
    assert sum(r["launches"] for r in table.values()) == 7
    assert sum(r["host_ms"] for r in table.values()) == pytest.approx(
        600 / 1e6)
    assert table["features.orb.select[0]"]["launches"] == 2
    assert table["features.orb.select[0]"]["device_ms"] == 30 / 1e6
    assert table["features.orb"]["host_ms"] == pytest.approx(
        (370 - 35 - 60 - 130 - 135) / 1e6)
    assert table["frame end"]["idle_ms"] == 95 / 1e6
    chk = stages.checks(rec)
    assert chk["kernel_stages"] == {"k1": ["features.orb.fast_harris"],
                                    "k3": ["features.orb.describe"]}
    assert chk["orb_children_cover"] == pytest.approx(360 / 370)
    assert chk["orb_span_over_harness_orb"] == pytest.approx(370 / 390)
    assert chk["launches_inside_spans"] == pytest.approx(6 / 7)


@pytest.mark.parametrize("case", ["untraced", "no frame read",
                                  "no program rows"])
def test_stage_readers_find_nothing_without_a_stage_trace(case):
    if case == "untraced":
        rec = {"spans": harness.Spans(False), "traced": None, "program": []}
    elif case == "no frame read":
        rec = {"spans": harness.Spans(True), "traced": Traced(),
               "program": []}
    else:
        rec = _stage_record()
        rec["program"] = []
    got = {name: _read(name, rec) for name in STAGE}
    if case == "no program rows":   # the harness's spans still hold syncs
        assert got.pop("frontend.host_syncs_per_frame") == 2.0
    else:
        assert stages.stage_table(rec) is None and stages.checks(rec) is None
    assert all(v is None for v in got.values()), got


@pytest.mark.cuda
def test_a_traced_frame_puts_its_launches_in_program_stages(cuda_dev):
    import numpy as np

    from kornia_tpu_torch.features import matching, orb

    cell = harness.Cell("orb_kitti.stream")
    cam = cell.config["camera"]
    rng = np.random.default_rng(18)
    small = rng.random((cam["height"] // 8 + 2, cam["width"] // 8 + 2))
    frame = (np.kron(small, np.ones((8, 8)))[:cam["height"], :cam["width"]]
             * 255).astype(np.uint8)
    cfg = orb.OrbConfig(**cell.config["orb"])
    spans = harness.Spans(True)
    detect = spans.wrap("orb", lambda f: orb.orb_detect_and_describe(
        f, cfg, device=cuda_dev))
    match = spans.wrap("match", lambda a, b: matching.match_descriptors(
        a.descriptors, b.descriptors, a_mask=a.mask, b_mask=b.mask,
        device=cuda_dev))
    count = spans.wrap("readback", lambda m: int(m.mask.sum()))
    prev = detect(frame)
    tr = Traced()
    tr.warm()
    for _ in range(3):
        tr.call(lambda: count(match(prev, detect(frame))))
    assert tr.frames
    rec = {"spans": spans, "traced": tr, "program": tr.rows}
    chk = stages.checks(rec)
    assert chk["kernel_stages"] == {"k1": ["features.orb.fast_harris"],
                                    "k3": ["features.orb.describe"]}
    assert chk["launches_inside_spans"] >= 0.99
    assert chk["orb_children_cover"] >= 0.95
