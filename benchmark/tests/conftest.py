"""Shared fixtures of the benchmark's own tests (run them with
``python -m pytest benchmark/tests``; the repository's ``pytest tests/``
does not collect them)."""

import os
import sys
import time

import pytest

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


def dry_run(name, seconds, seed=7, control=False):
    """One run of the tiny cell on the CPU through the plain route:
    (result dict, result line; None for a cell held out of
    BENCHMARK.json)."""
    from benchmark import harness
    from benchmark.run import Context, result_line

    cell = tiny(harness.Cell(name))
    ctx = Context(cell, seed, seconds, False, device="cpu", control=control,
                  t_process=time.time())
    res = harness.load_module("drivers", cell.config["driver"]).run(ctx)
    listed = name in {w["name"] for w in cell.bench["workloads"]}
    return res, result_line(cell, res, False, 1, ctx.card) if listed else None


@pytest.fixture
def cuda_dev():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels have no CPU mode")
    return "cuda"
