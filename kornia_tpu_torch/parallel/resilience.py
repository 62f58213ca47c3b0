"""Job health + preemption recovery for long multi-host runs (a copy of
kornia_tpu/parallel/resilience.py, which imports no JAX; the port keeps
its own so that it imports nothing of the JAX package).

SURVEY.md §5.3: the reference is a single-process library and has
nothing here ("the TPU build needs what the reference never had:
multi-host job health, checkpointed BA state for preemption recovery").
This module is that story:

* :class:`PreemptionGuard` — turns SIGTERM/SIGINT (the TPU preemption
  notice) into a cooperative flag the step loop polls, so the final
  checkpoint is written from a consistent state instead of dying
  mid-write.
* :class:`Heartbeat` / :func:`stalled_processes` — per-process liveness
  files on shared storage; a monitor (or any peer) detects wedged hosts
  without any collective traffic on the hot path.
* :func:`run_with_recovery` — a generic checkpointed step loop:
  resumes from the newest checkpoint, saves every N steps and on
  preemption, writes atomically (tmp + rename, versioned files + a
  ``latest`` pointer) so a kill at ANY instant leaves a loadable state.

The SLAM map checkpointing in slam/checkpoint.py provides the
save/load payload for the full system; this module supplies the loop
discipline and works for any state with (save, load) functions.
"""

from __future__ import annotations

import json
import os
import signal
import tempfile
import threading
import time
from dataclasses import dataclass
from typing import Callable, List, Optional, Tuple, TypeVar

S = TypeVar("S")


class PreemptionGuard:
    """Cooperative preemption flag driven by SIGTERM/SIGINT.

    >>> with PreemptionGuard() as guard:
    ...     while not guard.preempted:
    ...         state = step(state)
    ...     save(state)          # reached on preemption too

    Re-entrant safe: nested guards chain to the previously-installed
    handlers on exit. ``raise_after`` (seconds) optionally escalates to
    KeyboardInterrupt if the loop fails to drain in time — a stuck
    device dispatch must not eat the whole preemption grace window.
    """

    def __init__(self, signals: Tuple[int, ...] = (signal.SIGTERM,),
                 raise_after: Optional[float] = None):
        self._signals = signals
        self._raise_after = raise_after
        self._flag = threading.Event()
        self._prev = {}
        self._t_preempt: Optional[float] = None

    @property
    def preempted(self) -> bool:
        if self._flag.is_set():
            if (self._raise_after is not None
                    and self._t_preempt is not None
                    and time.monotonic() - self._t_preempt
                    > self._raise_after):
                raise KeyboardInterrupt("preemption grace expired")
            return True
        return False

    def _handler(self, signum, frame):
        self._t_preempt = time.monotonic()
        self._flag.set()

    def __enter__(self) -> "PreemptionGuard":
        for s in self._signals:
            self._prev[s] = signal.signal(s, self._handler)
        return self

    def __exit__(self, *exc):
        for s, h in self._prev.items():
            signal.signal(s, h)
        self._prev.clear()
        return False


@dataclass
class Heartbeat:
    """Periodic liveness marker: ``{dir}/hb_{process_id}.json`` with a
    monotonic-ish wall timestamp + step counter. Write cost is one tiny
    atomic rename; call :meth:`beat` once per step (it self-throttles
    to ``interval`` seconds)."""

    directory: str
    process_id: int = 0
    interval: float = 10.0
    _last: float = 0.0

    def beat(self, step: int = -1) -> None:
        now = time.time()
        if now - self._last < self.interval:
            return
        self._last = now
        os.makedirs(self.directory, exist_ok=True)
        payload = {"t": now, "step": step, "pid": os.getpid()}
        fd, tmp = tempfile.mkstemp(dir=self.directory, suffix=".tmp")
        with os.fdopen(fd, "w") as f:
            json.dump(payload, f)
        os.replace(tmp, os.path.join(
            self.directory, f"hb_{self.process_id}.json"))


def stalled_processes(directory: str, timeout: float,
                      expected: Optional[int] = None) -> List[int]:
    """Process ids whose heartbeat is older than ``timeout`` seconds
    (or missing entirely, when ``expected`` is given). Run from a
    monitor or any healthy peer; no collective participation needed
    from the suspects."""
    now = time.time()
    seen = {}
    if os.path.isdir(directory):
        for name in os.listdir(directory):
            if not (name.startswith("hb_") and name.endswith(".json")):
                continue
            try:
                with open(os.path.join(directory, name)) as f:
                    payload = json.load(f)
                seen[int(name[3:-5])] = float(payload["t"])
            except (ValueError, OSError, KeyError):
                continue
    stalled = [pid for pid, t in seen.items() if now - t > timeout]
    if expected is not None:
        stalled.extend(pid for pid in range(expected) if pid not in seen)
    return sorted(set(stalled))


# --------------------------------------------------------------------------
# checkpointed step loop
# --------------------------------------------------------------------------


def _ckpt_path(directory: str, step: int) -> str:
    return os.path.join(directory, f"ckpt_{step:08d}.npz")


def latest_checkpoint(directory: str) -> Optional[Tuple[int, str]]:
    """(step, path) of the newest complete checkpoint, or None.

    Only checkpoints recorded in the ``latest`` pointer (written after
    the rename) count — a kill mid-write leaves either the old pointer
    or a fully-renamed new file, never a torn state."""
    pointer = os.path.join(directory, "latest")
    if not os.path.exists(pointer):
        return None
    try:
        with open(pointer) as f:
            step = int(f.read().strip())
    except (OSError, ValueError):
        return None
    path = _ckpt_path(directory, step)
    return (step, path) if os.path.exists(path) else None


def save_checkpoint(directory: str, step: int, state,
                    save_fn: Callable[[str, S], None],
                    keep: int = 2) -> str:
    """Atomic versioned save: write to tmp, rename to the versioned
    name, then flip the ``latest`` pointer; prune old versions."""
    os.makedirs(directory, exist_ok=True)
    final = _ckpt_path(directory, step)
    # the tmp name must END in .npz: np.savez appends the extension to
    # anything else, leaving the opened tmp file empty
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".tmp.npz")
    os.close(fd)
    try:
        save_fn(tmp, state)
        os.replace(tmp, final)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".ptr.tmp")
    with os.fdopen(fd, "w") as f:
        f.write(str(step))
    os.replace(tmp, os.path.join(directory, "latest"))
    kept = sorted(
        n for n in os.listdir(directory)
        if n.startswith("ckpt_") and n.endswith(".npz"))
    for name in kept[:-keep]:
        try:
            os.unlink(os.path.join(directory, name))
        except OSError:
            pass
    return final


def run_with_recovery(
    step_fn: Callable[[S, int], S],
    init_state: S,
    directory: str,
    save_fn: Callable[[str, S], None],
    load_fn: Callable[[str], S],
    max_steps: int,
    checkpoint_every: int = 50,
    heartbeat: Optional[Heartbeat] = None,
    guard_signals: Tuple[int, ...] = (signal.SIGTERM,),
) -> Tuple[S, int, bool]:
    """Run ``step_fn`` for ``max_steps``, checkpointing + resuming.

    Returns (state, steps_completed, was_preempted). On entry, resumes
    from the newest checkpoint in ``directory`` if one exists (so the
    caller just re-launches the same command after preemption — the
    orbax-style resume contract). On SIGTERM the current step finishes,
    a final checkpoint is written, and the function returns with
    ``was_preempted=True``.
    """
    state = init_state
    start = 0
    resumed = latest_checkpoint(directory)
    if resumed is not None:
        start, path = resumed
        state = load_fn(path)
    preempted = False
    with PreemptionGuard(signals=guard_signals) as guard:
        step = start
        while step < max_steps:
            state = step_fn(state, step)
            step += 1
            if heartbeat is not None:
                heartbeat.beat(step)
            if guard.preempted:
                preempted = True
                save_checkpoint(directory, step, state, save_fn)
                return state, step, True
            if step % checkpoint_every == 0:
                save_checkpoint(directory, step, state, save_fn)
    if step > start and step % checkpoint_every != 0:
        save_checkpoint(directory, step, state, save_fn)
    return state, step, preempted
