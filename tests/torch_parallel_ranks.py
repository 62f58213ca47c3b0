"""What each rank runs in tests/test_torch_parallel.py: spawned processes
(``kornia_tpu_torch.parallel.mesh.spawn``) import this module, which
imports neither jax nor kornia_tpu. Every function takes the rank's mesh
and host inputs made by the test and returns numpy results."""

import numpy as np
import torch

from kornia_tpu_torch.features import orb
from kornia_tpu_torch.geometry import liegroup as lg
from kornia_tpu_torch.optim import ba as ba_mod
from kornia_tpu_torch.optim import pgo as pgo_mod
from kornia_tpu_torch.parallel import (ba_dist, controller, exchange,
                                       frontend_dist, pgo_dist)
from kornia_tpu_torch.slam import system as slam


def _np(x):
    return x.detach().cpu().numpy()


def _counted(mesh, fn):
    """(fn's result, the collectives it made on this rank)."""
    n0 = mesh.counts["collectives"]
    out = fn()
    return out, mesh.counts["collectives"] - n0


def _ba(res):
    return {"poses": _np(res.poses), "points": _np(res.points),
            "initial_cost": float(res.initial_cost),
            "final_cost": float(res.final_cost)}


def cases(mesh, inputs):
    """Every case of the 4-rank fixture; ``inputs`` is a dict of host
    problems and frames made by the test."""
    torch.set_num_threads(1)
    out = {"rank": mesh.rank, "ba": {}, "exchange": {}}
    for name, (kind, problem, params, s_mat) in inputs["ba"].items():
        fn = (ba_dist.bundle_adjust_schur_dist if kind == "colo"
              else ba_dist.bundle_adjust_schur_dist_kf)
        saved = ba_dist._S_MAT_BYTES
        ba_dist._S_MAT_BYTES = s_mat
        try:
            mode = ba_dist._solver_mode(params, problem.poses.shape[0],
                                        problem.points.shape[1])
            res, n = _counted(mesh, lambda: fn(problem, mesh, params))
        finally:
            ba_dist._S_MAT_BYTES = saved
        out["ba"][name] = dict(_ba(res), collectives=n, mode=mode)

    pgo, n = _counted(mesh, lambda: pgo_dist.pose_graph_optimize_dist(
        inputs["pgo"], mesh, pgo_mod.PGOParams(max_iterations=15)))
    out["pgo"] = {"poses": _np(pgo.poses), "collectives": n,
                  "initial_cost": float(pgo.initial_cost),
                  "final_cost": float(pgo.final_cost)}

    for name, plan in inputs["exchange"].items():
        fields, n = _counted(mesh, lambda: exchange.exchange_observations(
            plan, mesh))
        out["exchange"][name] = ([_np(f) for f in fields], n)

    frames, cfg = inputs["frames"]
    feats = frontend_dist.detect_and_describe_batch(frames, cfg, mesh,
                                                    device="cpu")
    out["features"] = [_np(f) for f in feats]
    m = frontend_dist.match_batch(
        feats.descriptors, feats.descriptors.roll(1, 0), feats.mask,
        feats.mask.roll(1, 0), mesh, device="cpu")
    out["matches"] = [_np(f) for f in m]

    # the single controller: rank 0 runs MonocularSlam with the mesh and
    # leads its global BA and PGO; the other ranks follow
    k, slam_map = inputs["slam"]
    if mesh.rank == 0:
        system = slam.MonocularSlam(k, device="cpu", mesh=mesh)
        system.map = slam_map
        ok_ba = system.global_ba()
        system._run_pgo()
        controller.stop(mesh)
        out["slam"] = {"ok": ok_ba, "poses": system.trajectory(),
                       "points": system.map.point_xyz}
    else:
        out["slam"] = {"jobs": controller.follow(mesh)}
    return out


def dryrun(mesh):
    """The port's counterpart of ``__graft_entry__.dryrun_multichip(D)``
    on a D-rank mesh: the sharded front end on D random 96×128 frames,
    the keyframe-sharded exchange → summed Schur BA (1 iteration, Huber
    2), the point-co-located layout, and distributed PGO (2 iterations),
    from the reference's seeded draws in its order."""
    torch.set_num_threads(1)
    d = mesh.size
    rng = np.random.default_rng(0)
    frames = rng.integers(0, 256, (d, 96, 128), np.uint8)
    feats = frontend_dist.detect_and_describe_batch(
        frames, orb.OrbConfig(n_features=64, n_levels=2), mesh,
        device="cpu")
    n_det = int(feats.mask.sum())

    n_poses, n_points = max(4, d), 4 * d
    k = np.array([[100.0, 0, 32], [0, 100.0, 24], [0, 0, 1]], np.float32)
    pts = rng.uniform([-1, -1, 3], [1, 1, 6], (n_points, 3)).astype(
        np.float32)
    poses = np.zeros((n_poses, 7), np.float32)
    poses[:, 0] = 1.0
    poses[:, 4] = 0.1 * np.arange(n_poses)
    obs_cam, obs_pt, obs_uv = [], [], []
    for c in range(n_poses):
        pc = _np(lg.se3_apply(torch.as_tensor(poses[c])[None],
                              torch.as_tensor(pts)))
        uv = pc[:, :2] / pc[:, 2:] * [k[0, 0], k[1, 1]] + [k[0, 2], k[1, 2]]
        obs_cam += [c] * n_points
        obs_pt += list(range(n_points))
        obs_uv += list(uv + rng.normal(0, 0.5, (n_points, 2)))
    fixed = np.zeros(n_poses, bool)
    fixed[0] = True
    problem = ba_mod.build_problem(
        poses, pts + rng.normal(0, 0.02, pts.shape).astype(np.float32), k,
        np.asarray(obs_cam, np.int32), np.asarray(obs_pt, np.int32),
        np.asarray(obs_uv, np.float32), fixed_poses=fixed, device="cpu")
    params = ba_mod.BAParams(max_iterations=1, loss="huber", loss_scale=2.0)
    res_kf = ba_dist.bundle_adjust_schur_dist_kf(
        ba_dist.shard_problem_by_keyframe(problem, d), mesh, params)
    res_co = ba_dist.bundle_adjust_schur_dist(
        ba_dist.shard_problem(problem, d), mesh, params)

    ei = np.arange(n_poses - 1, dtype=np.int32)
    ej = ei + 1
    pt = torch.as_tensor(poses)
    meas = _np(lg.se3_compose(pt[ej], lg.se3_inverse(pt[ei])))
    noisy = poses.copy()
    noisy[1:, 4:] += rng.normal(0, 0.05, (n_poses - 1, 3)).astype(np.float32)
    pgo = pgo_dist.pose_graph_optimize_dist(
        pgo_dist.shard_pgo(noisy, ei, ej, meas, n_devices=d), mesh,
        pgo_mod.PGOParams(max_iterations=2))
    return {"n_det": n_det, "kf": _ba(res_kf), "colo": _ba(res_co),
            "pgo": (float(pgo.initial_cost), float(pgo.final_cost))}


def fail_on_rank(mesh, bad):
    """Rank ``bad`` raises; the others wait in a collective it never
    joins."""
    if mesh.rank == bad:
        raise ValueError(f"rank {bad} fails on purpose")
    mesh.all_reduce_(torch.zeros(1))
