"""Tracing and stage timing (port of kornia_tpu/utils/tracing.py).

A ``stage`` context manager that times with the device synchronised when
``KORNIA_TPU_TRACE`` is set, a :class:`Tracer` that accumulates per-stage
stats, a :func:`profile_trace` scope over ``torch.profiler``, and
:func:`env_variant`, which reads the same ``KORNIA_TPU_<NAME>`` variables as
the reference (the port's entry points take their variants as arguments
and read none of them).

The program's stages are marked by :func:`span`, off unless a
:func:`recording` or :func:`profile_trace` scope is open: a recording
keeps each span's host interval on ``time.perf_counter_ns`` (the clock on
which a device trace's records can be placed), its parent and its request
(the root span it descends from); under ``profile_trace`` each span is
also a ``torch.profiler.record_function`` range of the same name.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import sys
import threading
import time
from collections import defaultdict
from typing import Dict, Iterator, List, NamedTuple, Optional

import torch

TRACE_ENV = "KORNIA_TPU_TRACE"


class SpanRow(NamedTuple):
    """One recorded span: its host interval on ``time.perf_counter_ns``,
    the index of its enclosing span in the recording's rows (None for a
    root), the request (every span under one root shares the root's) and
    the span's attribute (a pyramid level, say)."""

    name: str
    t0_ns: int
    t1_ns: int
    parent: Optional[int]
    request: int
    attr: object


class _Recorder:
    """What an open :func:`recording` or :func:`profile_trace` scope
    collects: raw rows (None when only profiling), each thread's stack of
    open spans, and whether spans open profiler ranges."""

    def __init__(self, rows: Optional[list], profile: bool):
        self.rows = rows
        self.profile = profile
        self.requests = itertools.count()
        self.local = threading.local()


# the open scope's recorder; None while no scope is open (spans are off)
_RECORDER: Optional[_Recorder] = None


class _Off:
    """The span of a process that records nothing: enters and leaves."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("rec", "name", "attr", "row", "range")

    def __init__(self, rec: _Recorder, name: str, attr):
        self.rec, self.name, self.attr = rec, name, attr
        self.row = self.range = None

    def __enter__(self):
        rec = self.rec
        if rec.profile:
            self.range = torch.profiler.record_function(self.name)
            self.range.__enter__()
        if rec.rows is not None:
            stack = rec.local.__dict__.setdefault("stack", [])
            parent = stack[-1] if stack else None
            # [name, t0, t1, parent row, request, attr]
            self.row = [self.name, 0, 0, parent,
                        next(rec.requests) if parent is None else parent[4],
                        self.attr]
            stack.append(self.row)
            rec.rows.append(self.row)
            self.row[1] = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        if self.row is not None:
            self.row[2] = time.perf_counter_ns()
            self.rec.local.stack.pop()
        if self.range is not None:
            self.range.__exit__(*exc)
        return False


def span(name: str, attr=None):
    """A context manager marking one stage of the program. Off (no scope
    open) it is one shared object that does nothing."""
    rec = _RECORDER
    if rec is None:
        return _OFF
    return _Span(rec, name, attr)


@contextlib.contextmanager
def _installed(rec: _Recorder) -> Iterator[None]:
    global _RECORDER
    outer, _RECORDER = _RECORDER, rec
    try:
        yield
    finally:
        _RECORDER = outer


@contextlib.contextmanager
def recording() -> Iterator[List[SpanRow]]:
    """Record every span opened in the scope, in any thread; yields a
    list that holds the rows, in the order the spans opened, once the
    scope has closed. Rows stay in memory; nothing is written out."""
    raw: list = []
    out: List[SpanRow] = []
    outer = _RECORDER
    with _installed(_Recorder(raw, outer is not None and outer.profile)):
        try:
            yield out
        finally:
            index = {id(r): i for i, r in enumerate(raw)}
            out[:] = [SpanRow(r[0], r[1], r[2],
                              None if r[3] is None else index[id(r[3])],
                              r[4], r[5]) for r in raw]


def trace_enabled() -> bool:
    return bool(os.environ.get(TRACE_ENV))


def _devices(x, out: set) -> set:
    """The CUDA devices of every tensor in ``x`` (nested lists, tuples,
    dicts and NamedTuples)."""
    if isinstance(x, torch.Tensor):
        if x.is_cuda:
            out.add(x.device)
    elif isinstance(x, dict):
        for v in x.values():
            _devices(v, out)
    elif isinstance(x, (list, tuple)):
        for v in x:
            _devices(v, out)
    return out


def _block_until_ready(x):
    """Wait for the devices that hold ``x``'s tensors (the counterpart of
    ``jax.block_until_ready``); returns ``x``."""
    for dev in _devices(x, set()):
        torch.cuda.synchronize(dev)
    return x


class Tracer:
    """Accumulates wall time per named stage.

    >>> tracer = Tracer(force=True)
    >>> with tracer.stage("gray", sync=out):
    ...     out = fn(x)
    >>> tracer.summary()   # {'gray': {'count': 1, 'total_ms': ..., ...}}
    """

    def __init__(self, force: bool = False, stream=None):
        self.enabled = force or trace_enabled()
        self.stream = stream if stream is not None else sys.stderr
        self._acc: Dict[str, list] = defaultdict(list)

    @contextlib.contextmanager
    def stage(self, name: str, sync: object = None) -> Iterator[None]:
        """Time a stage; the tensors in ``sync`` (on any device) are waited
        for before the clock stops (``torch.cuda.synchronize``). The stage
        is also a :func:`span` of the same name."""
        with span(name):
            if not self.enabled:
                yield
                return
            t0 = time.perf_counter()
            yield
            if sync is not None:
                _block_until_ready(sync)
            dt = (time.perf_counter() - t0) * 1e3
            self._acc[name].append(dt)
            print(f"[trace] {name}: {dt:.3f} ms", file=self.stream)

    def summary(self) -> Dict[str, Dict[str, float]]:
        out = {}
        for name, times in self._acc.items():
            out[name] = {
                "count": len(times),
                "total_ms": sum(times),
                "mean_ms": sum(times) / len(times),
                "min_ms": min(times),
            }
        return out

    def reset(self) -> None:
        self._acc.clear()


@contextlib.contextmanager
def profile_trace(logdir: str) -> Iterator[None]:
    """A ``torch.profiler`` scope (host ops, and the card's kernels where
    there is one) whose trace is written under ``logdir`` for TensorBoard
    or a Chrome trace viewer; the program's spans show in it as ranges
    above the ops they launched."""
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    outer = _RECORDER
    rec = _Recorder(None if outer is None else outer.rows, True)
    if outer is not None:
        rec.requests, rec.local = outer.requests, outer.local
    with profile(activities=acts,
                 on_trace_ready=tensorboard_trace_handler(logdir)), \
            _installed(rec):
        yield


def env_variant(name: str, default: str) -> str:
    """Kernel-variant switch: KORNIA_TPU_<NAME>, or ``default`` unset."""
    return os.environ.get(f"KORNIA_TPU_{name.upper()}", default)
