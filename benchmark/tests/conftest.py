"""Shared fixtures of the benchmark's own tests (run them with
``python -m pytest benchmark/tests``; the repository's ``pytest tests/``
does not collect them)."""

import os
import sys
import time
import types

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def tiny(cell):
    """The cell cut to a size a CPU test holds: half the image (intrinsics
    halved), and for the front end 8 frames of 500 features over 4
    levels. Widths of the SLAM loop stay as configured."""
    cam = cell.config["camera"]
    cell.config["camera"] = {
        "height": cam["height"] // 2, "width": cam["width"] // 2,
        "fx": cam["fx"] / 2, "fy": cam["fy"] / 2, "cx": cam["cx"] / 2,
        "cy": cam["cy"] / 2}
    if cell.config["driver"] == "frontend_stream":
        cell.traffic["frames"] = 8
        cell.config["orb"].update(n_features=500, n_levels=4)
        cell.config["sample"]["frames"] = 2
    return cell


def dry_run(name, seconds, seed=7, control=False, trace=False):
    """One run of the tiny cell on the CPU through the plain route:
    (result dict, result line). With ``trace`` the window runs under the
    harness's tracer; on the CPU only with ``card_trace_on_cpu`` in
    force."""
    from benchmark import harness
    from benchmark.run import Context, result_line

    cell = tiny(harness.Cell(name))
    ctx = Context(cell, seed, seconds, trace, device="cpu", control=control,
                  t_process=time.time())
    res = harness.load_module("drivers", cell.config["driver"]).run(ctx)
    return res, result_line(cell, res, trace, 1, ctx.card)


class Event:
    """One raw profiler record, as ``kineto_results.events()`` yields it."""

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


def card_trace_on_cpu(mp):
    """Make the tracer run on the CPU (``mp``: a pytest MonkeyPatch): the
    card's synchronisations do nothing, and each profiler session records
    the tracer's clock marker alone, at the host time of its enqueue, so
    every frame is read with no device record and no launch in it. The
    program's recording runs as it does on the card."""
    from torch.autograd import DeviceType

    marker = {}

    class Profile:
        def __init__(self, activities):
            marker.pop("t", None)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            t = marker.get("t")
            events = [] if t is None else [
                Event(DeviceType.CPU, "cudaLaunchKernel", t, 5, 1),
                Event(DeviceType.CUDA, "spin_kernel", t + 10, 10, 1)]
            self.profiler = types.SimpleNamespace(
                kineto_results=types.SimpleNamespace(events=lambda: events))
            return False

    def sleep(_cycles):
        marker["t"] = time.perf_counter_ns()

    mp.setattr(torch.profiler, "profile", Profile)
    mp.setattr(torch.cuda, "synchronize", lambda *a: None)
    mp.setattr(torch.cuda, "_sleep", sleep)


@pytest.fixture
def cuda_dev():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels have no CPU mode")
    return "cuda"
