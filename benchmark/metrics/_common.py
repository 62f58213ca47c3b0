"""Shared arithmetic of the per-layer readers. A reader takes the run's
record (spans, the traced window, the program's span rows, frame kinds,
ORB work) and returns its number, or None where the run has nothing to
read."""

from __future__ import annotations

import bisect

from benchmark import roofline
from benchmark.harness import SpanIndex


def mean_ms(rows):
    """Mean duration in ms of span rows, or None without any."""
    if not rows:
        return None
    return sum(t1 - t0 for _, t0, t1, _ in rows) / len(rows) / 1e6


def launches_per_frame(rec):
    tr = rec.get("traced")
    if tr is None or not tr.frames:
        return None
    return sum(f["launches"] for f in tr.frames) / len(tr.frames)


def idle_percent(rec):
    tr = rec.get("traced")
    if tr is None or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)


def orb_roofline_percent(rec, span: str):
    """Counted work's least time over the device time of everything
    launched inside the ORB spans, in %; None without a traced ORB call or
    peaks for the card."""
    tr = rec.get("traced")
    spans = rec["spans"].of(span)
    if tr is None or not spans or not rec["orb_work"]:
        return None
    device_s = tr.device_s_in(spans)
    least = 0.0
    for work in rec["orb_work"][: len(spans)]:
        lt = roofline.least_time(work, rec["card"])
        if lt is None:
            return None
        least += lt[0]
    return 100.0 * least / device_s if device_s > 0 else None


# ------------------------------------------- the program's own span rows
# A traced run keeps every row the program's spans recorded in a read frame
# (``kornia_tpu_torch.utils.tracing``) as (name, t0_ns, t1_ns, attr) under
# ``rec["program"]``, apart from the harness's own spans (``rec["spans"]``).
# A count is such a row whose ``attr`` holds the number.

def read_frames(rec):
    """The traced window, or None where it read no frame."""
    tr = rec.get("traced")
    return tr if tr is not None and tr.frames else None


def in_frames(tr, rows):
    """The rows that lie inside a read frame."""
    starts = [f["t0"] for f in tr.frames]
    out = []
    for r in rows:
        i = bisect.bisect_right(starts, r[1]) - 1
        if i >= 0 and r[2] <= tr.frames[i]["t1"]:
            out.append(r)
    return out


def program(rec, name):
    """The program's rows named ``name`` inside the read frames (None
    without a read frame)."""
    tr = read_frames(rec)
    if tr is None:
        return None
    return in_frames(tr, [r for r in rec["program"] if r[0] == name])


def span_ms(rec, name):
    """Host ms a read frame inside the program's spans named ``name``, or
    None where there are none."""
    rows = program(rec, name)
    if not rows:
        return None
    return sum(t1 - t0 for _, t0, t1, _ in rows) / len(
        rec["traced"].frames) / 1e6


def _count_inside(times, rows):
    """How many of the sorted ``times`` lie inside one of ``rows``."""
    return sum(bisect.bisect_left(times, t1) - bisect.bisect_left(times, t0)
               for _, t0, t1, _ in rows)


def launches_in(rec, name):
    """Launches and copies a read frame enqueued inside the program's spans
    named ``name``, or None where there are none."""
    rows = program(rec, name)
    if not rows:
        return None
    tr = rec["traced"]
    return _count_inside(tr.enqueues, rows) / len(tr.frames)


def all_spans(rec):
    """The harness's span rows and the program's, as (name, t0, t1, tag)."""
    return list(rec["spans"].rows) + rec["program"]


def host_syncs(rec):
    """Synchronising runtime records a read frame inside any span, the
    harness's or the program's (the tracer's own synchronise at a frame's
    end lies outside them all)."""
    tr = read_frames(rec)
    if tr is None:
        return None
    index = SpanIndex(all_spans(rec))
    return sum(1 for _, t in tr.syncs
               if index.find(t) >= 0) / len(tr.frames)
