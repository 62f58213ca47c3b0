"""tests/test_resilience.py run against the port's copy of the module
(kornia_tpu_torch/parallel/resilience.py): job health and preemption
recovery, the same cases and checks."""

import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest

from kornia_tpu_torch.parallel.resilience import (
    Heartbeat,
    PreemptionGuard,
    latest_checkpoint,
    run_with_recovery,
    save_checkpoint,
    stalled_processes,
)


def _save(path, state):
    np.savez(path, v=state)


def _load(path):
    return np.load(path)["v"]


class TestCheckpointLoop:
    def test_runs_to_completion(self, tmp_path):
        state, steps, preempted = run_with_recovery(
            lambda s, i: s + 1, np.int64(0), str(tmp_path), _save,
            _load, max_steps=7, checkpoint_every=3)
        assert (int(state), steps, preempted) == (7, 7, False)
        # final partial-interval checkpoint exists and is loadable
        step, path = latest_checkpoint(str(tmp_path))
        assert step == 7 and int(_load(path)) == 7

    def test_resume_after_crash(self, tmp_path):
        class Crash(RuntimeError):
            pass

        def crashy(s, i):
            if i == 4:
                raise Crash()
            return s + 1

        with pytest.raises(Crash):
            run_with_recovery(crashy, np.int64(0), str(tmp_path),
                              _save, _load, max_steps=9,
                              checkpoint_every=2)
        # crashed at i=4 -> newest checkpoint is step 4
        assert latest_checkpoint(str(tmp_path))[0] == 4
        state, steps, preempted = run_with_recovery(
            lambda s, i: s + 1, np.int64(-99), str(tmp_path), _save,
            _load, max_steps=9, checkpoint_every=2)
        # init state ignored: resumed from checkpoint value 4
        assert (int(state), steps, preempted) == (9, 9, False)

    def test_checkpoint_pruning_keeps_latest(self, tmp_path):
        for step in (2, 4, 6):
            save_checkpoint(str(tmp_path), step, np.int64(step), _save,
                            keep=2)
        names = sorted(n for n in os.listdir(tmp_path)
                       if n.startswith("ckpt_"))
        assert names == ["ckpt_00000004.npz", "ckpt_00000006.npz"]
        assert latest_checkpoint(str(tmp_path))[0] == 6

    def test_sigterm_checkpoints_and_resumes(self, tmp_path):
        """Full preemption drill: a real process gets SIGTERM mid-run,
        writes a consistent checkpoint, and a relaunch completes from
        it."""
        script = f"""
import sys, time, numpy as np
sys.path.insert(0, {os.getcwd()!r})
from kornia_tpu_torch.parallel.resilience import run_with_recovery

def save(path, s): np.savez(path, v=s)
def load(path): return np.load(path)["v"]

def step(s, i):
    if i == 2:
        print("READY", flush=True)   # guard installed, loop running
    time.sleep(0.05)
    return s + 1

state, steps, preempted = run_with_recovery(
    step, np.int64(0), {str(tmp_path)!r}, save, load,
    max_steps=200, checkpoint_every=1000)
print("RESULT", int(state), steps, int(preempted), flush=True)
"""
        proc = subprocess.Popen(
            [sys.executable, "-c", script], stdout=subprocess.PIPE,
            text=True,
            env={**os.environ, "JAX_PLATFORMS": "cpu"})
        # wait for the loop to be live before preempting (imports on a
        # loaded single-core box can take many seconds)
        line = proc.stdout.readline()
        assert "READY" in line, line
        time.sleep(0.3)
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=60)
        assert "RESULT" in out, out
        _, state_s, steps_s, preempted_s = out.split()[-4:]
        assert preempted_s == "1"
        ckpt_step, path = latest_checkpoint(str(tmp_path))
        assert ckpt_step == int(steps_s) == int(state_s) > 0
        # relaunch resumes and completes the remaining steps
        state, steps, preempted = run_with_recovery(
            lambda s, i: s + 1, np.int64(0), str(tmp_path),
            lambda p, s: np.savez(p, v=s),
            lambda p: np.load(p)["v"], max_steps=ckpt_step + 3,
            checkpoint_every=1000)
        assert (int(state), steps, preempted) == (ckpt_step + 3,
                                                  ckpt_step + 3, False)


class TestGuardAndHeartbeat:
    def test_guard_flag_and_restore(self):
        prev = signal.getsignal(signal.SIGTERM)
        with PreemptionGuard() as guard:
            assert not guard.preempted
            os.kill(os.getpid(), signal.SIGTERM)
            for _ in range(100):
                if guard.preempted:
                    break
                time.sleep(0.01)
            assert guard.preempted
        assert signal.getsignal(signal.SIGTERM) is prev

    def test_heartbeat_and_stall_detection(self, tmp_path):
        hb0 = Heartbeat(str(tmp_path), process_id=0, interval=0.0)
        hb1 = Heartbeat(str(tmp_path), process_id=1, interval=0.0)
        hb0.beat(step=5)
        hb1.beat(step=5)
        assert stalled_processes(str(tmp_path), timeout=5.0) == []
        # age process 1's heartbeat beyond the timeout
        p1 = os.path.join(tmp_path, "hb_1.json")
        payload = json.load(open(p1))
        payload["t"] -= 100.0
        json.dump(payload, open(p1, "w"))
        assert stalled_processes(str(tmp_path), timeout=5.0) == [1]
        # a missing expected process counts as stalled
        assert stalled_processes(str(tmp_path), timeout=5.0,
                                 expected=3) == [1, 2]
