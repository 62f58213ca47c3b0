"""The stage breakdown (benchmark/stages.py): the indexed innermost lookup
against the harness's linear scan, the stage trace against trace.Traced
on the same records, the readers on synthetic records, and on the card
one traced frame of the front end."""

import random
import time
import types

import pytest
import torch
from torch.autograd import DeviceType

from benchmark import harness, stages
from benchmark.trace import Traced

CARD = "NVIDIA H100 80GB HBM3"
EXISTING = ("frontend.orb_ms", "frontend.launches_per_frame",
            "frontend.device_idle", "frontend.orb_roofline")


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
    linear = harness.Spans(True)
    linear.rows = rows
    index = stages.SpanIndex(rows)
    times = {t + d for _, a, b, _ in rows for t in (a, b) for d in (-1, 0, 1)}
    times |= {rng.randint(-10, 5010) for _ in range(500)}
    for t in sorted(times):
        assert index.innermost(t) == linear.innermost(t), t


class _Event:
    def __init__(self, dev, name, start, dur, corr):
        self.dev, self._name, self.start = dev, name, start
        self.dur, self.corr = dur, corr

    def device_type(self):
        return self.dev

    def name(self):
        return self._name

    def start_ns(self):
        return self.start

    def duration_ns(self):
        return self.dur

    def correlation_id(self):
        return self.corr


def _session(base):
    """One frame's raw records on the profiler's clock, starting at
    ``base``: two kernels, a copy, a device record whose launch was lost,
    three synchronisations and the clock marker."""
    cpu, gpu = DeviceType.CPU, DeviceType.CUDA
    return [
        _Event(cpu, "cudaLaunchKernel", base + 100, 5, 1),
        _Event(gpu, "void fast_harris_kernel<true, true, 9>", base + 150,
               40, 1),
        _Event(cpu, "cudaMemcpyAsync", base + 200, 5, 2),
        _Event(gpu, "Memcpy DtoH (Device -> Pageable)", base + 260, 10, 2),
        _Event(cpu, "cudaStreamSynchronize", base + 210, 60, 3),
        _Event(cpu, "cudaMemcpy", base + 300, 20, 4),
        _Event(gpu, "Memcpy HtoD (Pageable -> Device)", base + 305, 10, 4),
        _Event(gpu, "void brief_rotated_kernel<true, false>", base + 400,
               30, 5),
        _Event(cpu, "cudaLaunchKernel", base + 350, 5, 6),
        _Event(gpu, "elementwise_kernel", base + 420, 20, 6),
        _Event(cpu, "cudaDeviceSynchronize", base + 500, 10, 7),
        _Event(cpu, "cudaLaunchKernel", base + 600, 5, 8),
        _Event(gpu, "spin_kernel", base + 610, 10, 8),
        _Event(cpu, "cudaDeviceSynchronize", base + 620, 10, 9),
    ]


@pytest.fixture
def fake_profiler(monkeypatch):
    """torch.profiler.profile replaced by sessions that hand back
    ``_session`` records, the card's calls by no-ops, and a host clock
    whose three reads a session (start, end, marker) are 0, 700 and 750
    ns after 10,000 + 1,000 a session (reset with ``restart``)."""
    state = {"base": 0, "reads": 0}

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
        k, pos = divmod(state["reads"], 3)
        state["reads"] += 1
        return 10_000 + 1000 * k + (0, 700, 750)[pos]

    def restart():
        state.update(base=0, reads=0)

    monkeypatch.setattr(torch.profiler, "profile", Profile)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "_sleep", lambda *a: None)
    monkeypatch.setattr(time, "perf_counter_ns", clock)
    return restart


def test_stage_trace_reads_what_traced_reads_and_the_syncs(fake_profiler):
    plain, staged = Traced(), stages.StageTraced()
    for tr in (plain, staged):
        fake_profiler()
        for _ in range(2):
            assert tr.call(lambda: 5) == 5
    assert staged.frames == plain.frames and staged.records == plain.records
    assert [f["launches"] for f in staged.frames] == [4, 4]
    assert len(staged.enqueues) == 8
    # the marker's launch (base + 600) is the host's 750: a record at
    # base + x lies at 150 + x, so the syncs at 210, 300 and 500 fall in
    # the frame (0 to 700) and the one after the marker does not
    assert staged.syncs == [
        (name, 10_000 + 1000 * k + t) for k in range(2)
        for name, t in (("cudaStreamSynchronize", 360), ("cudaMemcpy", 450),
                        ("cudaDeviceSynchronize", 650))]


def _record(traced, with_program_rows):
    """A run's record: harness spans around ORB, match and the read-back
    of each traced frame, and (merged, as a driver with the recorder on
    would) the program's spans inside them."""
    spans = harness.Spans(True)
    for f in traced.frames:
        t0 = f["t0"]
        spans.rows += [("orb", t0 + 10, t0 + 400, (0, None)),
                       ("match", t0 + 400, t0 + 480, (0, None)),
                       ("readback", t0 + 480, t0 + 590, (0, None))]
        if with_program_rows:
            spans.rows += [("features.orb", t0 + 20, t0 + 390, None),
                           ("features.orb.upload", t0 + 25, t0 + 60, None),
                           ("features.orb.fast_harris", t0 + 60, t0 + 120,
                            None),
                           ("features.orb.select", t0 + 120, t0 + 250, 0),
                           ("features.orb.describe", t0 + 250, t0 + 385,
                            None),
                           ("features.matching", t0 + 405, t0 + 470, None)]
    return {"spans": spans, "traced": traced, "card": CARD,
            "orb_work": [{"int32": 1e6, "f32": 1e6, "bytes": 1e6}] * len(
                traced.frames)}


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
    read = {name: harness.load_module("metrics", name).read
            for name in EXISTING}
    alone = {n: r(_record(tr, False)) for n, r in read.items()}
    merged = {n: r(_record(tr, True)) for n, r in read.items()}
    assert alone == merged and all(v is not None for v in alone.values())
    rec = _record(tr, True)
    gaps = tr.idle_gaps(rec["spans"])
    assert gaps == tr.idle_gaps(stages.SpanIndex(rec["spans"].rows))
    assert {label for label, _ in gaps} >= {"features.orb.select",
                                            "features.orb.describe"}


def _stage_record():
    """A StageTraced frame with program rows of its own: the record a
    stage run leaves."""
    tr = stages.StageTraced()
    base = _frames_with_records()
    tr.offset, tr.records, tr.frames = 0, base.records, base.frames
    rec = _record(tr, False)
    for f in tr.frames:
        t0 = f["t0"]
        tr.rows += [r for r in _record(tr, True)["spans"].rows
                    if r[0].startswith("features") and t0 <= r[1] < f["t1"]]
        tr.enqueues += [t0 + 5, t0 + 65, t0 + 130, t0 + 140, t0 + 260,
                        t0 + 410, t0 + 490]
        tr.syncs += [("cudaMemcpy", t0 + 40), ("cudaStreamSynchronize",
                                               t0 + 495),
                     ("cudaDeviceSynchronize", t0 + 595)]
    tr.rows += [("features.orb", 90_000, 90_100, None)]   # outside frames
    return rec


def test_stage_readers_by_hand():
    rec = _stage_record()
    got = {name: fn(rec) for name, fn in stages.STAGE_METRICS.items()}
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


def test_stage_readers_find_nothing_without_a_stage_trace():
    tr = _frames_with_records()
    for rec in ({"spans": harness.Spans(False), "traced": None},
                _record(tr, True),
                {"spans": harness.Spans(True),
                 "traced": stages.StageTraced()}):
        assert all(fn(rec) is None for fn in stages.STAGE_METRICS.values())
        assert stages.stage_table(rec) is None and stages.checks(rec) is None


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
    tr = stages.StageTraced()
    tr.warm()
    for _ in range(3):
        tr.call(lambda: count(match(prev, detect(frame))))
    assert tr.frames
    rec = {"spans": spans, "traced": tr}
    chk = stages.checks(rec)
    assert chk["kernel_stages"] == {"k1": ["features.orb.fast_harris"],
                                    "k3": ["features.orb.describe"]}
    assert chk["launches_inside_spans"] >= 0.99
    assert chk["orb_children_cover"] >= 0.95
