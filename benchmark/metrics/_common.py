"""Shared arithmetic of the per-layer readers. A reader takes the run's
record (spans, the traced window, frame kinds, ORB work) and returns its
number, or None where the run has nothing to read."""

from __future__ import annotations

from benchmark import roofline


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
