"""Baseline config 5: the whole SLAM loop with ATE evaluation, on the card
(port of examples/slam_demo.py; SURVEY.md §7.7). Runs on a TUM RGB-D
directory when given one, else on a synthetic circular trajectory that
closes a loop.

    python -m kornia_tpu_torch.examples.slam_demo [--tum DIR]
        [--max-frames 200] [--mesh N] [--viz OUT.html] [--cpu]

``--mesh N`` runs map-wide refinement (global BA and PGO) distributed
over N ranks started by ``parallel.mesh.spawn``: rank 0 runs the loop
and leads each distributed solve, the other ranks join them in
``parallel.follow``. The ranks take a card each where the host has one
for each, else they share ``cuda:0`` over gloo; with ``--cpu`` they are
CPU ranks.
"""

from __future__ import annotations

import numpy as np
import torch

from kornia_tpu_torch import io as kio
from kornia_tpu_torch import parallel, slam
from kornia_tpu_torch.bow import Vocabulary
from kornia_tpu_torch.examples._common import (base_parser,
                                               configure_backend, make_mesh)
from kornia_tpu_torch.geometry import liegroup as lg

# the synthetic scene's camera (tests/test_slam.py:97) and the TUM
# intrinsics the reference hard-codes for every TUM sequence
K = np.array([[500.0, 0, 320], [0, 500.0, 240], [0, 0, 1]])
K_TUM = np.array([[525.0, 0, 319.5], [0, 525.0, 239.5], [0, 0, 1]])
RANK_TIMEOUT = 900.0        # seconds for the --mesh ranks to finish


# ---------------------------------------------------------------------------
# the synthetic scene (tests/test_slam.py:54-94, on the port's liegroup in
# float32 on the CPU)
# ---------------------------------------------------------------------------


def _make_scene(rng, n_points=800, r_in=7.0, r_out=12.0):
    """Points on an annulus wall around the camera circle (outward-looking
    cameras always see a dense patch); distinctive random binary codes."""
    ang = rng.uniform(0, 2 * np.pi, n_points)
    rad = rng.uniform(r_in, r_out, n_points)
    pts = np.stack([rad * np.cos(ang), rad * np.sin(ang),
                    rng.uniform(-2.0, 2.0, n_points)], axis=1)
    desc = rng.integers(0, 256, (n_points, 32), np.uint8)
    return pts, desc


def _camera_poses_circle(n, radius=3.0, full=1.0):
    """world→camera poses looking outward along a circle in the z=0
    plane. Returns (n, 7)."""
    poses = []
    for i in range(n):
        a = full * 2 * np.pi * i / n
        center = np.array([radius * np.cos(a), radius * np.sin(a), 0.0])
        fwd = np.array([np.cos(a), np.sin(a), 0.0])  # look outward
        up = np.array([0.0, 0.0, 1.0])
        right = np.cross(fwd, up)
        r_wc = np.stack([right, -up, fwd], axis=0)  # rows: cam x/y/z in world
        t = -r_wc @ center
        q = lg.matrix_to_quat(torch.as_tensor(r_wc, dtype=torch.float32))
        poses.append(np.concatenate([q.numpy(), t]))
    return np.stack(poses)


def _observe(pts, desc, pose7, k, noise, rng, img_wh=(640, 480)):
    """Project the scene into a camera; returns (xy, desc, ids)."""
    cam = lg.se3_apply(
        torch.as_tensor(pose7, dtype=torch.float32)[None],
        torch.as_tensor(pts, dtype=torch.float32)).numpy().astype(np.float64)
    vis = cam[:, 2] > 0.5
    uv = cam[:, :2] / cam[:, 2:]
    uv = uv * [k[0, 0], k[1, 1]] + [k[0, 2], k[1, 2]]
    vis &= ((uv[:, 0] > 5) & (uv[:, 0] < img_wh[0] - 5)
            & (uv[:, 1] > 5) & (uv[:, 1] < img_wh[1] - 5))
    ids = np.nonzero(vis)[0]
    xy = uv[ids] + rng.normal(0, noise, (len(ids), 2))
    return xy, desc[ids], ids


def _centre(pose7) -> np.ndarray:
    """The camera centre of a world→camera pose, in float32."""
    return lg.se3_inverse(torch.as_tensor(
        np.asarray(pose7), dtype=torch.float32))[4:7].numpy()


def _summary(system, frames: int) -> dict:
    return {"frames": frames,
            "keyframes": len(system.map.keyframes),
            "kf_frames": [kf.frame_idx for kf in system.map.keyframes],
            "map_points": int(system.map.n_points),
            "poses": system.trajectory(),
            "loops": [r.loop_closed_with for r in system.results
                      if r.loop_closed_with is not None],
            "tracked": [r.n_tracked for r in system.results]}


# ---------------------------------------------------------------------------
# the two modes
# ---------------------------------------------------------------------------


def run_tum(args, device, mesh=None, out=print) -> dict:
    """``process_frame`` over up to ``--max-frames`` frames of a TUM
    RGB-D directory (ORB on ``device``: K1, K2, K3 a frame)."""
    ds = kio.TumRgbdDataset(args.tum)
    system = slam.MonocularSlam(K_TUM, slam.SlamConfig(), device=device,
                                mesh=mesh)
    n = min(len(ds), args.max_frames)
    for i in range(n):
        fr = ds[i]
        gray = np.asarray(fr.rgb).mean(-1).astype(np.uint8)
        r = system.process_frame(gray)
        if i % 20 == 0:
            out(f"frame {i}: {r.state.value}, tracked {r.n_tracked}")
    res = _summary(system, n)
    out(f"keyframes: {res['keyframes']}, map points: {res['map_points']}")
    res["ate"] = None
    if ds.groundtruth is not None and len(system.map.keyframes) > 3:
        kf_t = np.asarray([ds.timestamps[kf.frame_idx]
                           for kf in system.map.keyframes])
        gt_t = ds.groundtruth["timestamps"]
        idx = np.searchsorted(gt_t, kf_t).clip(0, len(gt_t) - 1)
        gt_c = ds.groundtruth["poses"][idx][:, 4:7]
        est_c = np.stack([_centre(kf.pose) for kf in system.map.keyframes])
        ate = slam.absolute_trajectory_error(est_c, gt_c)
        out(f"ATE RMSE: {ate.rmse:.4f} m (scale {ate.scale:.3f})")
        res["ate"] = float(ate.rmse)
    if args.viz:
        from kornia_tpu_torch.utils.viz import slam_viz

        slam_viz(args.viz, system, title="slam_demo TUM")
        out(f"wrote {args.viz}")
    return res


def run_synthetic(args, device, mesh=None, out=print) -> dict:
    """``process_observations`` over 43 frames of the outward-looking
    camera circle (40 poses, then the first 3 again: a loop closure), the
    vocabulary (k 8, depth 3, seed 1) built from the scene's codes."""
    rng = np.random.default_rng(0)
    pts, desc = _make_scene(rng, 900)
    n_frames = 40
    gt = _camera_poses_circle(n_frames, full=1.0)
    vocab = Vocabulary.build(desc, k=8, depth=3, seed=1, device=device)
    cfg = slam.SlamConfig(
        min_init_matches=30, keyframe_min_tracked_ratio=0.95,
        keyframe_min_interval=1, ba_window=4,
        loop_min_kf_gap=8, loop_min_score=0.10, loop_min_matches=15)
    if mesh is not None:
        out(f"distributed mode: {mesh.size}-rank mesh (global BA = "
            f"keyframe-sharded exchange -> summed Schur; PGO = "
            f"edge-sharded Gauss-Newton)")
    system = slam.MonocularSlam(K, cfg, vocabulary=vocab, device=device,
                                mesh=mesh)
    for i in range(n_frames + 3):
        xy, d, _ = _observe(pts, desc, gt[i % n_frames], K, 0.3, rng)
        r = system.process_observations(xy, d)
        tag = " KF" if r.is_keyframe else ""
        loop = (f" LOOP->kf{r.loop_closed_with}"
                if r.loop_closed_with is not None else "")
        if r.is_keyframe or loop:
            out(f"frame {r.frame_idx}: tracked {r.n_tracked}{tag}{loop}")
    res = _summary(system, n_frames + 3)
    est_c = np.stack([_centre(kf.pose) for kf in system.map.keyframes])
    gt_c = np.stack([_centre(gt[i % n_frames]) for i in res["kf_frames"]])
    ate = slam.absolute_trajectory_error(est_c, gt_c)
    res["ate"] = float(ate.rmse)
    out(f"keyframes {res['keyframes']}, map points {res['map_points']}, "
        f"ATE RMSE {ate.rmse:.4f} (radius 3.0)")
    if args.viz:
        from kornia_tpu_torch.utils.viz import slam_viz

        slam_viz(args.viz, system, gt_centers=gt_c,
                 title="slam_demo synthetic circle")
        out(f"wrote {args.viz}")
    return res


def _run(args, device, mesh=None, out=print) -> dict:
    return (run_tum if args.tum else run_synthetic)(args, device, mesh, out)


def mesh_rank(mesh, args):
    """One rank of ``--mesh N``: rank 0 runs the loop with the mesh and
    returns its printed lines and result; the others follow its solves."""
    if mesh.device.type == "cpu":
        torch.set_num_threads(1)    # the ranks share the host's cores
    if mesh.rank != 0:
        return {"jobs": parallel.follow(mesh)}
    lines = []
    try:
        res = _run(args, mesh.device, mesh, lines.append)
    finally:
        parallel.controller.stop(mesh)
    return {"lines": lines, "result": res}


def parse_args(argv=None):
    """The example's flags (``--mesh N``'s rank function takes them)."""
    p = base_parser(__doc__)
    p.add_argument("--tum", default=None, help="TUM RGB-D directory")
    p.add_argument("--max-frames", type=int, default=200)
    p.add_argument("--mesh", type=int, default=0, metavar="N",
                   help="run map-wide refinement distributed over N "
                        "ranks (with --cpu: N CPU ranks)")
    p.add_argument("--viz", default=None, metavar="OUT.html",
                   help="write a self-contained interactive 3-D view "
                        "of the trajectory/map/loop edges (the rerun "
                        "bridge equivalent, SURVEY §5.5)")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    dev = configure_backend(args)
    devices = make_mesh(args)
    if devices is None:
        return _run(args, dev)
    ranks = parallel.mesh.spawn(mesh_rank, len(devices), args,
                                devices=devices, timeout=RANK_TIMEOUT)
    for line in ranks[0]["lines"]:
        print(line)
    res = ranks[0]["result"]
    res["jobs"] = [r["jobs"] for r in ranks[1:]]
    return res


if __name__ == "__main__":
    main()
