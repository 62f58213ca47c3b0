"""The port's ``slam_demo`` and ``frontend_step`` examples
(kornia_tpu_torch/examples/) on the CPU, against the JAX package.

``slam_demo``'s synthetic mode keeps its own copy of tests/test_slam.py's
scene helpers (on the port's liegroup); they are held equal to the
reference's here. The reference's own synthetic run (examples/slam_demo.py's
``run_synthetic``, in-process, its device stages jitted as
test_torch_slam.py runs them) takes about 90 s on one CPU core, and the
loop's programs compile per shape bucket, so a shorter circle that still
closes a loop costs about as much: the comparison with it, and the
``--mesh 2`` run against the single process, are marked slow. Tier-1 runs
the port's synthetic mode and holds its printed ATE to the reference
library's evaluation of the same keyframes.
"""

import argparse
import contextlib
import importlib
import io as stdio
import os
import re
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import __graft_entry__
import chip_smoke
import test_slam as ref_slam
import test_torch_slam
from kornia_tpu import slam as jslam
from kornia_tpu.geometry import liegroup as jlg
from kornia_tpu_torch.examples import frontend_step, slam_demo

from test_torch_examples import ROOT, run

# One intra-op thread: these tests run many small ops, and torch's pool
# of a thread per core spins against the other test processes.
torch.set_num_threads(1)

# the reference's distributed against single-host BA bound on poses
# (tests/test_ba_dist.py:33-43; chip_smoke.PAR_BA_TOL)
MESH_POSE_TOL = 5e-4


@pytest.fixture(scope="module")
def synthetic():
    """The port's synthetic run, once for the file."""
    return run(slam_demo)


@pytest.fixture(scope="module")
def reference_synthetic():
    """The reference example's ``run_synthetic`` in-process (stdout
    captured), its device stages jitted, the MonocularSlam it builds
    kept: (printed lines, that system)."""
    systems = []
    out = stdio.StringIO()
    with pytest.MonkeyPatch.context() as mp:
        # the example puts "." on sys.path and imports tests.test_slam
        mp.setattr(sys, "path", [ROOT] + sys.path)
        ref_demo = importlib.import_module("examples.slam_demo")
        test_torch_slam.jit_reference_stages(mp)
        build = jslam.MonocularSlam
        mp.setattr(jslam, "MonocularSlam",
                   lambda *a, **k: systems.append(build(*a, **k))
                   or systems[-1])
        with contextlib.redirect_stdout(out):
            ref_demo.run_synthetic(argparse.Namespace(mesh=0, viz=None,
                                                      cpu=True))
    return out.getvalue().splitlines(), systems[0]


def test_slam_scene_helpers_equal_reference():
    """The example's copies of _make_scene, _camera_poses_circle and
    _observe give the reference test helpers' arrays: the scene exactly;
    each pose's quaternion within 1 float32 ULP (ATen's CPU float32 sqrt
    is not correctly rounded on every input, XLA's is; 24 of 280 values
    differ, by 1 ULP) and its translation exactly; of the 43 frames'
    observations the same points and codes, their pixels within 1e-3 px
    (measured 3.5e-4; 37 frames bit-equal). The loop takes the same path
    on either (the printed run below)."""
    a, b = np.random.default_rng(0), np.random.default_rng(0)
    pts, desc = slam_demo._make_scene(a, 900)
    ref_pts, ref_desc = ref_slam._make_scene(b, 900)
    np.testing.assert_array_equal(pts, ref_pts)
    np.testing.assert_array_equal(desc, ref_desc)
    gt = slam_demo._camera_poses_circle(40, full=1.0)
    ref_gt = ref_slam._camera_poses_circle(40, full=1.0)
    np.testing.assert_allclose(gt[:, :4], ref_gt[:, :4], rtol=0,
                               atol=2 ** -24)
    np.testing.assert_array_equal(gt[:, 4:], ref_gt[:, 4:])
    np.testing.assert_array_equal(slam_demo.K, ref_slam.K)
    for i in range(43):
        xy, d, ids = slam_demo._observe(pts, desc, gt[i % 40], slam_demo.K,
                                        0.3, a)
        rx, rd, rids = ref_slam._observe(ref_pts, ref_desc, ref_gt[i % 40],
                                         ref_slam.K, 0.3, b)
        np.testing.assert_array_equal(ids, rids)
        np.testing.assert_allclose(xy, rx, rtol=0, atol=1e-3)
        np.testing.assert_array_equal(d, rd)


def _kf_centres(poses):
    """Camera centres of world→camera poses (n, 7), as the reference
    example takes them (float32 se3_inverse, tests/test_slam.py's
    liegroup)."""
    return np.stack([np.asarray(jlg.se3_inverse(jnp.asarray(
        p, jnp.float32)))[4:7] for p in poses])


def test_slam_demo_synthetic_closes_the_loop(synthetic, record_property):
    """The synthetic run (43 frames: the 40-pose circle, then its first 3
    poses again) keeps every frame as a keyframe, closes the loop on the
    revisit and prints its summary; its ATE is under the reference loop
    test's 5% of the radius and equals, to float32 rounding (1e-6), the
    reference library's ``absolute_trajectory_error`` of the same
    keyframe centres against the reference helpers' ground truth
    (measured 6.7e-9)."""
    out, res = synthetic
    lines = out.splitlines()
    assert res["keyframes"] == 43 and res["loops"]
    assert lines[-1] == (f"keyframes 43, map points {res['map_points']}, "
                         f"ATE RMSE {res['ate']:.4f} (radius 3.0)")
    gt = ref_slam._camera_poses_circle(40, full=1.0)
    ref_ate = jslam.absolute_trajectory_error(
        _kf_centres(res["poses"]),
        _kf_centres(gt[np.asarray(res["kf_frames"]) % 40])).rmse
    record_property("ate_against_reference", abs(res["ate"] - ref_ate))
    assert res["ate"] < 0.05 * 3.0
    assert abs(res["ate"] - ref_ate) <= 1e-6


@pytest.mark.slow
def test_slam_demo_synthetic_prints_the_reference_run(
        synthetic, reference_synthetic, record_property):
    """The port's synthetic run against the reference example's, run
    in-process on the same observations: the same printed lines (each
    keyframe's tracked count, the loop closures at frames 38-42, the
    keyframe and map-point counts, the ATE to its 4 printed decimals);
    the keyframes' frames equal; their poses within 1e-3 (the port draws
    its RANSAC hypotheses from a torch generator, the reference from
    PRNGKey splits, and BA sums in another order: the tolerance of
    test_torch_slam.py's loop, measured 3.9e-4); the ATEs within 1e-4 of
    each other (measured 4.3e-5). The reference run takes
    ~90 s, hence slow."""
    out, res = synthetic
    ref_lines, ref = reference_synthetic
    assert out.splitlines() == ref_lines
    assert res["kf_frames"] == [kf.frame_idx for kf in ref.map.keyframes]
    ref_poses = np.stack([kf.pose for kf in ref.map.keyframes])
    d_pose = float(np.abs(res["poses"] - ref_poses).max())
    record_property("poses_max", d_pose)
    assert d_pose <= 1e-3
    gt = ref_slam._camera_poses_circle(40, full=1.0)
    ref_ate = jslam.absolute_trajectory_error(
        _kf_centres(ref_poses),
        _kf_centres(gt[np.asarray(res["kf_frames"]) % 40])).rmse
    printed = float(re.search(r"ATE RMSE ([\d.]+)", ref_lines[-1]).group(1))
    assert abs(ref_ate - printed) <= 5e-5
    record_property("ate_diff", abs(res["ate"] - ref_ate))
    assert abs(res["ate"] - ref_ate) <= 1e-4


@pytest.mark.slow
def test_slam_demo_mesh_2_matches_single_process(synthetic):
    """``--mesh 2`` on two gloo CPU ranks (rank 0 runs the loop and leads
    each global BA and PGO, rank 1 follows): the same printed loop,
    keyframes, map points and loops as the single process; the keyframe
    poses within MESH_POSE_TOL of it (the summed Schur BA adds its
    observations in another order, so they are not bit-equal: measured
    7.8e-6); the follower joined every solve rank 0 led. (~25 s, hence
    slow.)"""
    out, res = run(slam_demo, "--mesh", 2)
    lines = out.splitlines()
    assert lines[0].startswith("distributed mode: 2-rank mesh")
    single_out, single = synthetic
    assert lines[1:] == single_out.splitlines()
    assert res["kf_frames"] == single["kf_frames"]
    assert res["loops"] == single["loops"]
    assert res["map_points"] == single["map_points"]
    np.testing.assert_allclose(res["poses"], single["poses"], rtol=0,
                               atol=MESH_POSE_TOL)
    # each closure leads one PGO and one global BA
    assert res["jobs"] == [2 * len(single["loops"])]


def test_slam_demo_tum_runs(tmp_path):
    """``--tum DIR`` on a 6-frame TUM RGB-D layout of the frame-loop scene
    (chip_smoke.slam_sequence, 480×752), cut at 5 frames by
    ``--max-frames``: it runs to the end and prints its lines. The
    sequence is not taken with TUM's intrinsics, so nothing is held of
    the pose."""
    frames, gt, _ = chip_smoke.slam_sequence(n=6)
    root = str(tmp_path / "tum")
    os.makedirs(root)
    chip_smoke._tum_layout(root, frames, gt)
    out, res = run(slam_demo, "--tum", root, "--max-frames", 5)
    assert out.splitlines()[0].startswith("frame 0: ")
    assert "keyframes: " in out and res["frames"] == 5
    assert len(res["tracked"]) == 5


# ---------------------------------------------------------------------------
# frontend_step
# ---------------------------------------------------------------------------


def test_forward_step_matches_reference_entry():
    """``forward_step("cpu")`` against ``__graft_entry__.entry()``: the
    same seed-0 noise frames; on them the pyramid differs from the
    reference in 0-3 pixels a level (ROADMAP.md §3), so ≤ 2% of keypoint
    slots and ≤ 1% of match entries differ (tests/test_torch_slice.py's
    bounds for this pair)."""
    fn, (a, b) = frontend_step.forward_step("cpu")
    ref_fn, (ra, rb) = __graft_entry__.entry()
    np.testing.assert_array_equal(a.numpy(), np.asarray(ra))
    np.testing.assert_array_equal(b.numpy(), np.asarray(rb))
    got = [t.numpy() for t in fn(a, b)]
    want = [np.asarray(t) for t in jax.jit(ref_fn)(ra, rb)]
    for g, w in zip(got[:2], want[:2]):
        assert (~(g == w).all(1)).mean() <= 0.02
    assert (got[2] != want[2]).mean() <= 0.01
    assert (got[3] != want[3]).mean() <= 0.01


def test_distributed_step_two_cpu_ranks():
    """``distributed_step(2, "cpu")``: two gloo CPU ranks run the sharded
    front end, the keyframe-sharded BA step, the co-located layout and
    distributed PGO; it prints its line, both ranks agree bit for bit,
    and the two layouts reach the same cost (rtol 1e-3, as
    tests/test_torch_parallel.py holds the 8-rank run)."""
    out = stdio.StringIO()
    with contextlib.redirect_stdout(out):
        ranks = frontend_step.distributed_step(2, "cpu")
    assert out.getvalue().startswith("distributed_step OK: 2 ranks")
    r0, r1 = ranks
    assert r0["n_det"] == r1["n_det"] > 0
    np.testing.assert_array_equal(r0["kf"]["poses"], r1["kf"]["poses"])
    assert r0["pgo"] == r1["pgo"]
    np.testing.assert_allclose(r0["colo"]["final_cost"],
                               r0["kf"]["final_cost"], rtol=1e-3)
    assert np.isfinite(r0["kf"]["final_cost"])


# the dryrun's printed line: keypoints, BA and PGO cost before and after
# The dryrun's BA fixes pose 0 only, so its scale is free: ROADMAP.md §3
# records a 3e-3 float32 drift of such a solve. On the 2-device
# problem (4 poses, 8 points, one LM step) the two packages' single-host
# solves already end 8.3e-4 apart (6.3635 and 6.3582), the distributed
# ones 1.1e-3; on 8 devices 1e-6.
BA_FREE_SCALE = 3e-3
DRYRUN_LINE = (r"front-end (\d+) kp, kf-sharded BA cost ([\d.]+) -> "
               r"([\d.]+), PGO cost ([\d.]+) -> ([\d.]+)")


@pytest.mark.slow
def test_distributed_step_matches_reference_dryrun(record_property):
    """``distributed_step(2, "cpu")`` against the reference's
    ``__graft_entry__.dryrun_multichip(2)``, run in-process on 2 of the 8
    virtual CPU devices: the keypoints exact; the keyframe-sharded BA's
    initial cost and PGO's costs within 1e-3 relative plus half a unit of
    the reference's 4th printed decimal (test_torch_parallel.py's bound
    for the 8-rank run), the BA's final cost within BA_FREE_SCALE
    relative (its reason above); the co-located layout at the same cost
    (rtol 1e-3). The reference's eager ``shard_map`` takes ~40 s, hence
    slow; Tier-1 holds the same rank function on 8 ranks to the
    reference's recorded 8-device line
    (test_torch_parallel.py::test_dryrun_multichip_8_ranks_matches_record).
    """
    out = stdio.StringIO()
    with contextlib.redirect_stdout(out):
        __graft_entry__.dryrun_multichip(2)
    n_kp, c0, c1, p0, p1 = (float(x) for x in re.search(
        DRYRUN_LINE, out.getvalue()).groups())
    with contextlib.redirect_stdout(stdio.StringIO()):
        r0 = frontend_step.distributed_step(2, "cpu")[0]
    assert r0["n_det"] == n_kp
    record_property("ba_final_rel", abs(r0["kf"]["final_cost"] - c1) / c1)
    for value, want, rel in ((r0["kf"]["initial_cost"], c0, 1e-3),
                             (r0["kf"]["final_cost"], c1, BA_FREE_SCALE),
                             (r0["pgo"][0], p0, 1e-3),
                             (r0["pgo"][1], p1, 1e-3)):
        assert abs(value - want) <= rel * abs(want) + 5e-5, (value, want)
    np.testing.assert_allclose(r0["colo"]["final_cost"],
                               r0["kf"]["final_cost"], rtol=1e-3)
