"""Rolling frame-rate meter (port of kornia_tpu/io/fps_counter.py;
reference: kornia-io/src/fps_counter.rs)."""

from __future__ import annotations

import time
from collections import deque


class FpsCounter:
    """Windowed FPS meter for live pipelines.

    >>> fps = FpsCounter(window=30)
    >>> fps.tick()          # call once per frame
    >>> rate = fps.fps()    # frames/sec over the window
    """

    def __init__(self, window: int = 60):
        if window < 2:
            raise ValueError("window must be >= 2")
        self._times: deque = deque(maxlen=window)

    def tick(self) -> None:
        self._times.append(time.perf_counter())

    def fps(self) -> float:
        if len(self._times) < 2:
            return 0.0
        span = self._times[-1] - self._times[0]
        if span <= 0:
            return 0.0
        return (len(self._times) - 1) / span

    def reset(self) -> None:
        self._times.clear()
