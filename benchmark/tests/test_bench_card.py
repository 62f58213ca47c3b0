"""On the card: the control at the cell's own size on three seeds, and one
traced run (``python -m pytest benchmark/tests -m cuda``)."""

import json
import subprocess
import sys

import pytest

from benchmark import harness
from benchmark.control import readings


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["orb_kitti.stream"])
def test_control_fails_and_the_program_passes_at_cell_size(cuda_dev, name):
    cell = harness.Cell(name)
    rows = readings(cell, [11, 12, 13], 3.0, device=cuda_dev,
                    log=lambda text: None)
    limits = cell.config["limits"]
    for _, prog, ctrl in rows:
        assert all(prog[n] <= lim for n, lim in limits.items())
        assert any(ctrl[n] > lim for n, lim in limits.items())


@pytest.mark.cuda
def test_a_traced_run_reads_every_layer_metric(cuda_dev):
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "orb_kitti.stream",
         "--seed", "21", "--seconds", "10", "--trace", "1"],
        cwd=harness.ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    cell = harness.Cell("orb_kitti.stream")
    assert set(line["metrics"]) == {m["name"] for m in cell.per_layer()}
    assert 0 < line["device"]["busy_s"] <= line["device"]["window_s"]
    assert line["metrics"]["frontend.orb_roofline"]["value"] <= 100
    assert line["correct"] is True
