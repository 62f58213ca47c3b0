"""The front end's time by program stage: the spans that
``kornia_tpu_torch`` records itself (``utils.tracing``: ``features.orb``
and its stages, ``features.matching``) joined with the device trace.

    python3 benchmark/stages.py --seed <n> --seconds <s>
    python3 benchmark/stages.py --seed <n> --seconds <s> --alternate <w>

The first form runs the ``orb_kitti.stream`` cell's driver as a
``--trace 1`` run does, every traced frame also under
``tracing.recording()``, and prints one JSON line: per stage (the
innermost span, each ORB level apart) the launches, host ms, device ms,
idle ms and host syncs a traced frame; the cell's per-layer metrics over
the same frames; five stage metrics (``frontend.select_ms``,
``frontend.select_launches_per_frame``, ``frontend.describe_ms``,
``frontend.match_ms``, ``frontend.host_syncs_per_frame``); and checks
of the spans' coverage. The second form runs the window untraced, the
recording on in every other ``w``-s slice of it, and prints each slice's
frames a second. Both need a CUDA card; nothing is written to disk.

What the harness would need to report the stage metrics in every
``--trace 1`` run is in PERF.md (Open questions).
"""

from __future__ import annotations

import argparse
import bisect
import json
import os
import sys
import time
from typing import Dict, List, Optional

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark import harness  # noqa: E402
from benchmark.trace import ENQUEUES, MARKER, Traced, _merged  # noqa: E402

# runtime records that make the host wait for the device; "cudaMemcpy" is
# the blocking copy (cudaMemcpyAsync is not one)
SYNCS = {"cudaStreamSynchronize", "cudaDeviceSynchronize",
         "cudaEventSynchronize", "cudaMemcpy"}
OUTSIDE = "between calls"


class SpanIndex:
    """``harness.Spans.innermost`` by lookup, for rows that nest (the
    spans of one thread do): rows sorted by start, each with the nearest
    earlier row that encloses it; a time's innermost row is found by
    bisection and a walk out through the enclosing rows. Its labels equal
    the linear scan's: the shortest row that holds the time, the first in
    row order among equals."""

    def __init__(self, rows: List[tuple]):
        order = sorted(range(len(rows)),
                       key=lambda i: (rows[i][1], -rows[i][2], -i))
        self.rows = [rows[i] for i in order]
        self.starts = [r[1] for r in self.rows]
        self.parent: List[int] = []
        open_: List[int] = []
        for k, (_, t0, _, _) in enumerate(self.rows):
            while open_ and self.rows[open_[-1]][2] <= t0:
                open_.pop()
            self.parent.append(open_[-1] if open_ else -1)
            open_.append(k)

    def find(self, t_ns: int) -> int:
        """The sorted position of the innermost row holding ``t_ns``, or
        −1."""
        k = bisect.bisect_right(self.starts, t_ns) - 1
        while k >= 0 and not t_ns < self.rows[k][2]:
            k = self.parent[k]
        return k

    def innermost(self, t_ns: int) -> str:
        k = self.find(t_ns)
        return OUTSIDE if k < 0 else self.rows[k][0]


class StageTraced(Traced):
    """A :class:`Traced` whose calls also run under
    ``tracing.recording()``. Besides what Traced keeps (its frames and
    records are the same), each read frame keeps the host-clock times of
    its enqueue records (``enqueues``), its synchronising runtime records
    (``syncs``: name, time) and the program's span rows (``rows``: name,
    t0, t1, attr)."""

    def __init__(self):
        super().__init__()
        self.enqueues: List[int] = []
        self.syncs: List[tuple] = []
        self.rows: List[tuple] = []

    def call(self, fn):
        import torch
        from torch.profiler import ProfilerActivity, profile

        from kornia_tpu_torch.utils import tracing

        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            with tracing.recording() as rows:
                t0 = time.perf_counter_ns()
                out = fn()
                torch.cuda.synchronize()
                t1 = time.perf_counter_ns()
            mark = time.perf_counter_ns()
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
        self.take(prof.profiler.kineto_results.events(), t0, t1, mark,
                  rows)
        return out

    def take(self, events, t0: int, t1: int, mark: int, rows=()):
        """Read one session's raw records as ``Traced.call`` does, and
        keep the enqueue, synchronisation and span rows of the frame."""
        from torch.autograd import DeviceType

        runtime: Dict[int, tuple] = {}
        device, syncs = [], []
        for e in events:
            if e.device_type() == DeviceType.CUDA:
                device.append((e.name(), e.start_ns(),
                               e.start_ns() + e.duration_ns(),
                               e.correlation_id()))
                continue
            if e.name().startswith(ENQUEUES):
                runtime[e.correlation_id()] = (e.name(), e.start_ns())
            if e.name() in SYNCS:
                syncs.append((e.name(), e.start_ns()))
        marks = [runtime[c][1] for n, _, _, c in device
                 if MARKER in n and c in runtime]
        if marks:
            self.offset = marks[-1] - mark
        elif self.offset is None:
            return
        offset = self.offset
        busy, r0 = 0, len(self.records)
        for name, s, e, c in device:
            if MARKER in name:
                continue
            launch = runtime.get(c, (None, None))[1]
            self.records.append((name, s - offset, e - offset,
                                 None if launch is None else launch - offset))
        marker = {c for n, _, _, c in device if MARKER in n}
        launches = sum(1 for c in runtime if c not in marker)
        for s, e in _merged([(s - offset, e - offset) for n, s, e, _ in device
                             if MARKER not in n]):
            lo, hi = max(s, t0), min(e, t1)
            busy += max(0, hi - lo)
        self.enqueues.extend(sorted(t - offset for c, (_, t) in
                                    runtime.items() if c not in marker))
        self.syncs.extend((n, t - offset) for n, t in syncs
                          if t0 <= t - offset <= t1)
        self.rows.extend((r.name, r.t0_ns, r.t1_ns, r.attr) for r in rows)
        self.frames.append({"t0": t0, "t1": t1, "wall_ns": t1 - t0,
                            "busy_ns": busy, "launches": launches,
                            "records": (r0, len(self.records))})


# ------------------------------------------------------------------ readings
def merged_spans(rec) -> List[tuple]:
    """The harness's span rows and the program's, as (name, t0, t1, tag)."""
    return list(rec["spans"].rows) + [
        (n, t0, t1, attr) for n, t0, t1, attr in rec["traced"].rows]


def _stage_traced(rec) -> Optional[StageTraced]:
    tr = rec.get("traced")
    if not isinstance(tr, StageTraced) or not tr.frames:
        return None
    return tr


def _in_frames(tr, rows) -> List[tuple]:
    """The rows that lie inside a read frame."""
    starts = [f["t0"] for f in tr.frames]
    out = []
    for r in rows:
        i = bisect.bisect_right(starts, r[1]) - 1
        if i >= 0 and r[2] <= tr.frames[i]["t1"]:
            out.append(r)
    return out


def span_ms(rec, name: str) -> Optional[float]:
    """Host ms a read frame inside the spans named ``name``."""
    tr = _stage_traced(rec)
    if tr is None:
        return None
    rows = _in_frames(tr, [r for r in merged_spans(rec) if r[0] == name])
    return sum(r[2] - r[1] for r in rows) / len(tr.frames) / 1e6


def _count_inside(times, rows) -> int:
    """How many of the sorted ``times`` lie inside one of ``rows``."""
    return sum(bisect.bisect_left(times, t1) - bisect.bisect_left(times, t0)
               for _, t0, t1, _ in rows)


def launches_in(rec, name: str) -> Optional[float]:
    """Launches and copies a read frame enqueued inside the spans named
    ``name``."""
    tr = _stage_traced(rec)
    if tr is None:
        return None
    rows = [r for r in merged_spans(rec) if r[0] == name]
    return _count_inside(tr.enqueues, rows) / len(tr.frames)


def host_syncs(rec) -> Optional[float]:
    """Synchronising runtime records a read frame inside any span (the
    tracer's own synchronise at a frame's end lies outside them all)."""
    tr = _stage_traced(rec)
    if tr is None:
        return None
    index = SpanIndex(merged_spans(rec))
    return sum(1 for _, t in tr.syncs
               if index.find(t) >= 0) / len(tr.frames)


STAGE_METRICS = {
    "frontend.select_ms": lambda rec: span_ms(rec, "features.orb.select"),
    "frontend.select_launches_per_frame":
        lambda rec: launches_in(rec, "features.orb.select"),
    "frontend.describe_ms": lambda rec: span_ms(rec,
                                                "features.orb.describe"),
    "frontend.match_ms": lambda rec: span_ms(rec, "features.matching"),
    "frontend.host_syncs_per_frame": host_syncs,
}


def _label(name: str, attr) -> str:
    return f"{name}[{attr}]" if name == "features.orb.select" else name


def own_ms(rows, n_frames: int) -> Dict[str, float]:
    """Host ms a frame of each span name's own time: its rows' durations
    less those of the rows directly inside them."""
    index = SpanIndex(rows)
    own: Dict[str, float] = {}
    for r, p in zip(index.rows, index.parent):
        ms = (r[2] - r[1]) / 1e6 / n_frames
        own[r[0]] = own.get(r[0], 0.0) + ms
        if p >= 0:
            own[index.rows[p][0]] -= ms
    return own


def stage_table(rec) -> Optional[Dict[str, dict]]:
    """Per stage, named by the innermost span (each ORB level apart;
    "between calls" outside every span, "frame end" the device's wait
    from its last record to the frame's end), a read frame's launches,
    host ms (the span's own time, its inner spans' taken out), device ms
    (records launched there), idle ms (device gaps ended by a record
    launched there) and host syncs."""
    tr = _stage_traced(rec)
    if tr is None:
        return None
    rows = [(_label(r[0], r[3]), r[1], r[2], r[3])
            for r in _in_frames(tr, merged_spans(rec))]
    index = SpanIndex(rows)
    keys = ("launches", "host_ms", "device_ms", "idle_ms", "syncs")
    table: Dict[str, dict] = {}

    def add(label, key, value):
        table.setdefault(label, dict.fromkeys(keys, 0.0))[key] += value

    n = len(tr.frames)
    for label, ms in own_ms(rows, 1).items():
        add(label, "host_ms", ms)
    for f in tr.frames:
        add(OUTSIDE, "host_ms", f["wall_ns"] / 1e6)
    for k, p in enumerate(index.parent):
        if p < 0:
            add(OUTSIDE, "host_ms", -(index.rows[k][2] - index.rows[k][1])
                / 1e6)
    for t in tr.enqueues:
        add(index.innermost(t), "launches", 1)
    for _, t in tr.syncs:
        add(index.innermost(t), "syncs", 1)
    for f in tr.frames:
        r0, r1 = f["records"]
        cur = f["t0"]
        for _, s, e, launch in sorted(tr.records[r0:r1], key=lambda r: r[1]):
            label = OUTSIDE if launch is None else index.innermost(launch)
            add(label, "device_ms", (e - s) / 1e6)
            if s > cur:
                add(label, "idle_ms", (s - cur) / 1e6)
            cur = max(cur, e)
        if f["t1"] > cur:
            add("frame end", "idle_ms", (f["t1"] - cur) / 1e6)
    return {label: {k: v / n for k, v in row.items()}
            for label, row in table.items()}


def checks(rec) -> Optional[dict]:
    """The spans' coverage in the read frames: the ``features.orb`` span
    against the harness's ``orb`` span, the share of it its stages cover,
    the share of launches inside some span, and the stage that launched
    K1 and K3."""
    tr = _stage_traced(rec)
    if tr is None:
        return None
    rows = _in_frames(tr, merged_spans(rec))
    orb = [r for r in rows if r[0] == "features.orb"]
    outer = [r for r in rows if r[0] == "orb"]
    index = SpanIndex(rows)
    roots = {k for k, r in enumerate(index.rows) if r[0] == "features.orb"}
    covered = sum(index.rows[k][2] - index.rows[k][1]
                  for k, p in enumerate(index.parent) if p in roots)
    orb_ns = sum(r[2] - r[1] for r in orb)
    inside = sum(1 for t in tr.enqueues if index.find(t) >= 0)
    kernels = {}
    for label, key in (("k1", "fast_harris_kernel"),
                       ("k3", "brief_rotated_kernel")):
        kernels[label] = sorted({index.innermost(launch)
                                 for name, _, _, launch in tr.records
                                 if key in name and launch is not None})
    return {"orb_span_over_harness_orb": (orb_ns / len(orb)) / (
                sum(r[2] - r[1] for r in outer) / len(outer))
            if orb and outer else None,
            "orb_children_cover": covered / orb_ns if orb_ns else None,
            "launches_inside_spans": inside / max(len(tr.enqueues), 1),
            "kernel_stages": kernels}


# ------------------------------------------------------------------ runs
class _Alternating:
    """Stands in for the traced window: frames run untraced, under
    ``tracing.recording()`` in every other ``window_s`` slice (the first
    slice off); each frame's (on, start, end) on the host clock, and the
    span rows of the recorded frames, labelled as in the stage table."""

    def __init__(self, window_s: float):
        self.window_s = window_s
        self.frames: List[tuple] = []
        self.rows: List[tuple] = []
        self.start = None

    def call(self, fn):
        from kornia_tpu_torch.utils import tracing

        t0 = time.perf_counter()
        if self.start is None:
            self.start = t0
        on = int((t0 - self.start) / self.window_s) % 2 == 1
        if on:
            with tracing.recording() as rows:
                out = fn()
            self.rows.extend((_label(r.name, r.attr), r.t0_ns, r.t1_ns,
                              r.attr) for r in rows)
        else:
            out = fn()
        self.frames.append((on, t0, time.perf_counter()))
        return out

    def slices(self) -> List[dict]:
        out: List[dict] = []
        for on, t0, t1 in self.frames:
            k = int((t0 - self.start) / self.window_s)
            if not out or out[-1]["slice"] != k:
                out.append({"slice": k, "recording": on, "frames": 0,
                            "t0": t0})
            out[-1]["frames"] += 1
            out[-1]["t1"] = t1
        return [{"slice": s["slice"], "recording": s["recording"],
                 "frames_per_s": s["frames"] / (s["t1"] - s["t0"])}
                for s in out]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--alternate", type=float, default=0.0,
                    help="slice seconds: untraced, recording on in every "
                         "other slice")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("stages: needs a CUDA card", file=sys.stderr)
        return 3
    from benchmark.run import Context, per_layer

    cell = harness.Cell("orb_kitti.stream")
    alternating = _Alternating(args.alternate) if args.alternate else None

    class StageContext(Context):
        def traced(self):
            if alternating is not None:
                return alternating
            traced = StageTraced()
            traced.warm()
            return traced

    ctx = StageContext(cell, args.seed, args.seconds,
                       trace=alternating is None)
    driver = harness.load_module("drivers", cell.config["driver"])
    res = driver.run(ctx)
    t = time.perf_counter()
    rec = res["record"]
    line = {"card": ctx.card, "correct": res["check"].correct,
            "attempted": res["attempted"]}
    if alternating is not None:
        line["slices"] = alternating.slices()
        line["untraced_own_ms"] = own_ms(
            alternating.rows, sum(on for on, _, _ in alternating.frames))
    else:
        tr = rec["traced"]
        line["frames_read"] = len(tr.frames)
        line["metrics"] = {k: v["value"] for k, v in
                           per_layer(cell, rec).items()}
        line["stage_metrics"] = {name: fn(rec)
                                 for name, fn in STAGE_METRICS.items()}
        line["stages"] = stage_table(rec)
        line["checks"] = checks(rec)
        line["idle_gaps"] = tr.idle_gaps(SpanIndex(merged_spans(rec)))
    line["read_s"] = time.perf_counter() - t
    line["judge_s"] = res["judge_s"]
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
