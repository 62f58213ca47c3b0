"""The port's span recorder (``kornia_tpu_torch.utils.tracing``): off by
default, the span tree of ORB and the matcher, threads, ``Tracer.stage``
and ``profile_trace``. On the CPU, through the kernels' plain versions."""

import json
import os
import threading

import numpy as np
import pytest
import torch

from kornia_tpu_torch.features import matching, orb
from kornia_tpu_torch.utils import tracing

# One intra-op thread: these tests run many small ops, and torch's pool
# of a thread per core spins against the other test processes.
torch.set_num_threads(1)

ORB_CHILDREN = (["features.orb.upload", "features.orb.pyramid",
                 "features.orb.fast_harris"]
                + ["features.orb.select"]
                + ["features.orb.describe", "features.orb.assemble"])


@pytest.fixture(scope="module")
def frame():
    """A (240, 320) u8 frame of upsampled noise: corners on every one of
    the default configuration's 8 levels."""
    rng = np.random.default_rng(18)
    small = rng.random((240 // 8 + 2, 320 // 8 + 2))
    return (np.kron(small, np.ones((8, 8)))[:240, :320] * 255).astype(
        np.uint8)


def test_recording_off_keeps_no_rows_and_the_same_outputs(frame):
    assert tracing.span("a") is tracing.span("b", 3)
    with tracing.span("a"):
        plain = orb.orb_detect_and_describe(frame, device="cpu")
    with tracing.recording() as rows:
        recorded = orb.orb_detect_and_describe(frame, device="cpu")
    assert rows
    with tracing.recording() as empty:
        pass
    assert empty == []
    assert tracing.span("a") is tracing.span("c")
    for name, a, b in zip(orb.OrbFeatures._fields, plain, recorded):
        assert a.dtype == b.dtype and torch.equal(a, b), name


def test_orb_and_match_span_tree(frame):
    with tracing.recording() as rows:
        a = orb.orb_detect_and_describe(frame, device="cpu")
        m = matching.match_descriptors(a.descriptors, a.descriptors,
                                       a.mask, a.mask, device="cpu")
    assert int(m.mask.sum()) > 0
    root = rows[0]
    assert root.name == "features.orb" and root.parent is None
    kids = [r for r in rows if r.parent == 0]
    assert [r.name for r in kids] == ORB_CHILDREN
    # every level in one select stage (one orb.orb_select call)
    assert [r.attr for r in kids if r.name == "features.orb.select"] == \
        ["all"]
    assert len(rows) == 1 + len(kids) + 1
    t = root.t0_ns
    for r in kids:
        assert r.request == root.request
        assert t <= r.t0_ns <= r.t1_ns <= root.t1_ns
        t = r.t1_ns
    match = rows[-1]
    assert match.name == "features.matching" and match.parent is None
    assert match.request != root.request
    assert root.t1_ns <= match.t0_ns <= match.t1_ns


def test_threads_keep_their_own_parents():
    both = threading.Barrier(2, timeout=30)

    def work(tag):
        with tracing.span(f"outer.{tag}"):
            both.wait()
            with tracing.span(f"inner.{tag}", tag):
                both.wait()

    with tracing.recording() as rows:
        threads = [threading.Thread(target=work, args=(tag,))
                   for tag in ("a", "b")]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=30)
    assert not any(th.is_alive() for th in threads)
    by_name = {r.name: i for i, r in enumerate(rows)}
    assert len(rows) == 4
    for tag in ("a", "b"):
        outer, inner = rows[by_name[f"outer.{tag}"]], \
            rows[by_name[f"inner.{tag}"]]
        assert outer.parent is None and inner.attr == tag
        assert inner.parent == by_name[f"outer.{tag}"]
        assert inner.request == outer.request
    assert rows[by_name["outer.a"]].request != \
        rows[by_name["outer.b"]].request


def test_a_span_left_by_an_exception_is_closed():
    with tracing.recording() as rows:
        with pytest.raises(ValueError):
            with tracing.span("outer"):
                with tracing.span("failing"):
                    raise ValueError("stage failed")
        with tracing.span("after"):
            pass
    assert [(r.name, r.parent) for r in rows] == [
        ("outer", None), ("failing", 0), ("after", None)]
    assert all(r.t0_ns <= r.t1_ns for r in rows)


@pytest.mark.parametrize("force", [False, True])
def test_tracer_stages_are_recorded(force):
    lines = []

    class Stream:
        def write(self, text):
            lines.append(text)

        def flush(self):
            pass

    tracer = tracing.Tracer(force=force, stream=Stream())
    with tracing.recording() as rows:
        with tracer.stage("gray", sync=torch.ones(2)):
            with tracing.span("inside"):
                torch.ones(8).sum()
    assert [(r.name, r.parent) for r in rows] == [("gray", None),
                                                  ("inside", 0)]
    assert bool(lines) == force
    assert set(tracer.summary()) == ({"gray"} if force else set())


def test_profile_trace_shows_spans_and_keeps_recording(tmp_path):
    with tracing.recording() as rows:
        with tracing.profile_trace(str(tmp_path)):
            with tracing.span("features.test_stage"):
                torch.ones(64).sum()
    assert [r.name for r in rows] == ["features.test_stage"]
    traces = [f for f in os.listdir(tmp_path) if f.endswith(".json")]
    assert traces
    with open(os.path.join(tmp_path, traces[0])) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "features.test_stage" for e in events)
