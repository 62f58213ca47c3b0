"""Tracing and stage timing (port of kornia_tpu/utils/tracing.py).

A ``stage`` context manager that times with the device synchronised when
``KORNIA_TPU_TRACE`` is set, a :class:`Tracer` that accumulates per-stage
stats, a :func:`profile_trace` scope over ``torch.profiler``, and
:func:`env_variant`, which reads the same ``KORNIA_TPU_<NAME>`` variables as
the reference (the port's entry points take their variants as arguments
and read none of them).
"""

from __future__ import annotations

import contextlib
import os
import sys
import time
from collections import defaultdict
from typing import Dict, Iterator

import torch

TRACE_ENV = "KORNIA_TPU_TRACE"


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
        for before the clock stops (``torch.cuda.synchronize``)."""
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
    or a Chrome trace viewer."""
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts,
                 on_trace_ready=tensorboard_trace_handler(logdir)):
        yield


def env_variant(name: str, default: str) -> str:
    """Kernel-variant switch: KORNIA_TPU_<NAME>, or ``default`` unset."""
    return os.environ.get(f"KORNIA_TPU_{name.upper()}", default)
