"""The front end's time by program stage: the spans that
``kornia_tpu_torch`` records itself (``utils.tracing``: ``features.orb``
and its stages, ``features.matching``) joined with the device trace.

    python3 benchmark/stages.py --seed <n> --seconds <s>
    python3 benchmark/stages.py --seed <n> --seconds <s> --alternate <w>

The first form runs the ``orb_kitti.stream`` cell as a ``--trace 1`` run
does and prints one JSON line: per stage (the innermost span, each ORB
level apart) the launches, host ms, device ms, idle ms and host syncs a
traced frame; the cell's per-layer metrics over the same frames; checks
of the spans' coverage; and the idle gaps. The second form runs the
window untraced, the recording on in every other ``w``-s slice of it, and
prints each slice's frames a second. Both need a CUDA card; nothing is
written to disk.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Dict, List, Optional

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark import harness  # noqa: E402
from benchmark.harness import OUTSIDE, SpanIndex  # noqa: E402
from benchmark.metrics._common import (  # noqa: E402
    all_spans, in_frames, read_frames)


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
    tr = read_frames(rec)
    if tr is None:
        return None
    rows = [(_label(r[0], r[3]), r[1], r[2], r[3])
            for r in in_frames(tr, all_spans(rec))]
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
    tr = read_frames(rec)
    if tr is None:
        return None
    rows = in_frames(tr, all_spans(rec))
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

    class AlternatingContext(Context):
        def traced(self):
            return alternating

    ctx = (Context if alternating is None else AlternatingContext)(
        cell, args.seed, args.seconds, trace=alternating is None)
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
        line["stages"] = stage_table(rec)
        line["checks"] = checks(rec)
        line["idle_gaps"] = tr.idle_gaps(rec["spans"])
    line["read_s"] = time.perf_counter() - t
    line["judge_s"] = res["judge_s"]
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
