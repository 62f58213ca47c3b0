"""The device trace of a traced run, read from torch.profiler's raw records,
and the program's own span rows.

Each traced call (a frame) runs in a profiler session of its own
(``ProfilerActivity.CUDA``: CUPTI's runtime and device records, no ATen
op events), as chip_smoke.py's ``_frame_trace`` at commit adb6c1a does:
one session over a whole window would hold millions of records, more than
the tracer's buffers keep. The records are read raw
(``prof.profiler.kineto_results.events()``): building a FunctionEvent for
each takes seconds a frame. The call also runs under
``kornia_tpu_torch.utils.tracing.recording()``, which keeps the spans the
program records itself on the same host clock.

A device record belongs to the host span in which its launch was
enqueued: the runtime record that launched it shares its correlation id,
and the runtime record's time is put on the host's perf_counter clock by
a marker (``torch.cuda._sleep``, whose ``spin_kernel`` the program never
launches) enqueued at a perf_counter instant at the end of each session.
The tracer loses the device records of a session's first few launches,
so busy time is a slight underestimate.
"""

from __future__ import annotations

import time
from typing import Dict, List

from benchmark.harness import OUTSIDE, SpanIndex

ENQUEUES = ("cudaLaunch", "cuLaunch", "cudaMemcpy", "cudaMemset",
            "cuMemcpy", "cuMemset", "cudaGraphLaunch")
# runtime records that make the host wait for the device; "cudaMemcpy" is
# the blocking copy (cudaMemcpyAsync is not one)
SYNCS = {"cudaStreamSynchronize", "cudaDeviceSynchronize",
         "cudaEventSynchronize", "cudaMemcpy"}
MARKER = "spin_kernel"


class Traced:
    """What the traced calls left, on the host's perf_counter clock: for
    each read frame its wall and busy time and launches (``frames``), the
    device records (``records``), the times of its enqueue records
    (``enqueues``) and of its synchronising runtime records (``syncs``:
    name, time), and every row the program's spans recorded in it
    (``rows``: name, t0_ns, t1_ns, attr, as the recording gave them; rows
    of zero width too)."""

    def __init__(self):
        self.frames: List[dict] = []   # t0, t1, wall_ns, busy_ns, launches
        self.records: List[tuple] = []  # (name, start_ns, end_ns, launch_ns)
        self.enqueues: List[int] = []
        self.syncs: List[tuple] = []
        self.rows: List[tuple] = []
        # the clock offset of the last session whose marker was recorded
        # (the tracer now and then loses it); frames before the first
        # such session are not read
        self.offset = None

    def warm(self):
        """One empty session, so that the tracer's own start-up (~9 s on
        the H100 machines) is set-up and not a traced frame."""
        import torch
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CUDA]):
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()

    def call(self, fn):
        """Run ``fn()`` (which ends in a synchronisation) under a session
        and the program's recording; returns its result."""
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
        self.take(prof.profiler.kineto_results.events(), t0, t1, mark, rows)
        return out

    def take(self, events, t0: int, t1: int, mark: int, rows):
        """Read one session's raw records and keep the frame, unless no
        marker has yet put the profiler's clock on the host's."""
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
        if marks:                           # profiler ns - perf_counter ns
            self.offset = marks[-1] - mark
        elif self.offset is None:           # no clock yet: frame not read
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

    # ------------------------------------------------------------ readings
    @property
    def window_s(self) -> float:
        return sum(f["wall_ns"] for f in self.frames) / 1e9

    @property
    def busy_s(self) -> float:
        return sum(f["busy_ns"] for f in self.frames) / 1e9

    def device_s_in(self, spans) -> float:
        """Device seconds of the records launched inside ``spans``."""
        iv = sorted((t0, t1) for _, t0, t1, _ in spans)
        if not iv:
            return 0.0
        import bisect
        starts = [a for a, _ in iv]
        total = 0
        for _, s, e, launch in self.records:
            if launch is None:
                continue
            i = bisect.bisect_right(starts, launch) - 1
            if i >= 0 and launch < iv[i][1]:
                total += e - s
        return total / 1e9

    def top_ops(self, n: int = 10) -> List[list]:
        by: Dict[str, int] = {}
        for name, s, e, _ in self.records:
            by[name] = by.get(name, 0) + (e - s)
        return [[k, v / 1e9] for k, v in
                sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, spans, n: int = 10) -> List[list]:
        """The ``n`` longest device-idle gaps inside traced calls, each
        named by the innermost span, the harness's ``spans`` or the
        program's rows, that enqueued the work ending it (the host was
        busy there while the device waited), or "frame end" for the wait
        from the last record to the call's end."""
        index = SpanIndex(list(spans.rows) + self.rows)
        gaps = []
        for f in self.frames:
            r0, r1 = f["records"]
            cur = f["t0"]
            for _, s, e, launch in sorted(self.records[r0:r1],
                                          key=lambda r: r[1]):
                if s > cur:
                    gaps.append((s - cur, OUTSIDE if launch is None
                                 else index.innermost(launch)))
                cur = max(cur, e)
            if f["t1"] > cur:
                gaps.append((f["t1"] - cur, "frame end"))
        gaps.sort(key=lambda g: -g[0])
        return [[label, g / 1e9] for g, label in gaps[:n]]


def _merged(iv):
    out = []
    for s, e in sorted(iv):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [tuple(x) for x in out]
