"""What each rank runs in tests/test_torch_parallel.py: spawned processes
(``kornia_tpu_torch.parallel.mesh.spawn``) import this module, which
imports neither jax nor kornia_tpu. Every function takes the rank's mesh
and host inputs made by the test and returns numpy results."""

import torch

from kornia_tpu_torch.optim import pgo as pgo_mod
from kornia_tpu_torch.parallel import (ba_dist, controller, exchange,
                                       frontend_dist, pgo_dist)
from kornia_tpu_torch.slam import system as slam
# the port's counterpart of ``__graft_entry__.dryrun_multichip(D)`` on a
# D-rank mesh is the frontend_step example's rank function
from kornia_tpu_torch.examples.frontend_step import (  # noqa: F401
    distributed_rank as dryrun)


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


def fail_on_rank(mesh, bad):
    """Rank ``bad`` raises; the others wait in a collective it never
    joins."""
    if mesh.rank == bad:
        raise ValueError(f"rank {bad} fails on purpose")
    mesh.all_reduce_(torch.zeros(1))
