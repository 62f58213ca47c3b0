"""The ORB front-end step on the card, and one distributed SLAM step over
spawned ranks (the port's counterparts of the root ``__graft_entry__.py``'s
``entry()`` and ``dryrun_multichip(n)``).

    python -m kornia_tpu_torch.examples.frontend_step [--ranks N] [--cpu]

``forward_step(device)``: the forward step, ORB on a 240×320 gray frame
pair then the ratio-tested match, and its inputs on ``device``.

``distributed_step(n_ranks, device)``: one step of each distributed stage
on ``n_ranks`` ranks started by ``parallel.mesh.spawn``:

  1. the sharded front end — one 96×128 gray frame a rank, ORB on each
     rank, the features all-gathered (``parallel.frontend_dist``);
  2. the keyframe-sharded observation exchange feeding the summed Schur
     BA (``parallel.ba_dist.bundle_adjust_schur_dist_kf``), and the
     point-co-located layout without an exchange;
  3. Gauss-Newton PGO over edge shards
     (``parallel.pgo_dist.pose_graph_optimize_dist``).
"""

from __future__ import annotations

import numpy as np
import torch

from kornia_tpu_torch import parallel, resolve_device
from kornia_tpu_torch.examples._common import (base_parser,
                                               configure_backend,
                                               rank_devices)
from kornia_tpu_torch.features import matching, orb
from kornia_tpu_torch.geometry import liegroup as lg
from kornia_tpu_torch.optim import ba as ba_mod
from kornia_tpu_torch.optim import pgo as pgo_mod
from kornia_tpu_torch.parallel import ba_dist, frontend_dist, pgo_dist

RANK_TIMEOUT = 600.0        # seconds for the ranks of distributed_step


def forward_step(device="cuda"):
    """(fn, example_args): ``fn(gray_a, gray_b)`` runs ORB
    (``OrbConfig(n_features=512, n_levels=4)``) on both frames and the
    ratio-tested match on ``device`` and returns (xy_a, xy_b, idx, mask);
    the args are two seed-made 240×320 u8 frames on ``device``."""
    dev = resolve_device(device)
    cfg = orb.OrbConfig(n_features=512, n_levels=4)

    def forward(gray_a: torch.Tensor, gray_b: torch.Tensor):
        fa = orb.orb_detect_and_describe(gray_a, cfg, device=dev)
        fb = orb.orb_detect_and_describe(gray_b, cfg, device=dev)
        m = matching.match_descriptors(
            fa.descriptors, fb.descriptors, a_mask=fa.mask, b_mask=fb.mask,
            max_distance=64, ratio=0.8, device=dev)
        return fa.xy, fb.xy, m.idx, m.mask

    rng = np.random.default_rng(0)
    a = torch.as_tensor(rng.integers(0, 256, (240, 320), np.uint8),
                        device=dev)
    b = torch.as_tensor(rng.integers(0, 256, (240, 320), np.uint8),
                        device=dev)
    return forward, (a, b)


def _np(t):
    return t.detach().cpu().numpy()


def _ba(res):
    return {"poses": _np(res.poses), "points": _np(res.points),
            "initial_cost": float(res.initial_cost),
            "final_cost": float(res.final_cost)}


def distributed_rank(mesh):
    """What each rank of :func:`distributed_step` runs on ``mesh.device``,
    from the seeded draws of ``dryrun_multichip`` in its order: the
    sharded front end on D random 96×128 frames, the keyframe-sharded
    exchange → summed Schur BA (1 iteration, Huber 2), the point-co-located
    layout, and distributed PGO (2 iterations). Returns host values."""
    dev = mesh.device
    if dev.type == "cpu":
        torch.set_num_threads(1)    # D processes share the host's cores
    d = mesh.size
    rng = np.random.default_rng(0)
    frames = rng.integers(0, 256, (d, 96, 128), np.uint8)
    feats = frontend_dist.detect_and_describe_batch(
        frames, orb.OrbConfig(n_features=64, n_levels=2), mesh, device=dev)
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
        np.asarray(obs_uv, np.float32), fixed_poses=fixed, device=dev)
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


def distributed_step(n_ranks: int, device="cuda",
                     timeout: float = RANK_TIMEOUT) -> list:
    """:func:`distributed_rank` on ``n_ranks`` spawned ranks
    (``_common.rank_devices`` of ``device``). Checks that the front end
    found keypoints and that BA and PGO lowered their costs, prints one
    line and returns every rank's result."""
    devices = rank_devices(n_ranks, resolve_device(device))
    ranks = parallel.mesh.spawn(distributed_rank, n_ranks, devices=devices,
                                timeout=timeout)
    r0 = ranks[0]
    kf, (p0, p1) = r0["kf"], r0["pgo"]
    if r0["n_det"] <= 0:
        raise AssertionError("the sharded front end detected nothing")
    for name, (c0, c1) in (("BA", (kf["initial_cost"], kf["final_cost"])),
                           ("PGO", (p0, p1))):
        if not (np.isfinite(c1) and c1 <= c0):
            raise AssertionError(f"the distributed {name} step did not "
                                 f"reduce its cost: {c0} -> {c1}")
    print(f"distributed_step OK: {n_ranks} ranks — front-end "
          f"{r0['n_det']} kp, kf-sharded BA cost {kf['initial_cost']:.4f} "
          f"-> {kf['final_cost']:.4f}, PGO cost {p0:.4f} -> {p1:.4f}")
    return ranks


def main(argv=None) -> dict:
    p = base_parser(__doc__)
    p.add_argument("--ranks", type=int, default=0,
                   help="ranks of the distributed step (default: one a "
                        "card, at most 8; 8 with --cpu)")
    args = p.parse_args(argv)
    dev = configure_backend(args)
    fn, example = forward_step(dev)
    out = fn(*example)
    print("forward_step OK:", [tuple(o.shape) for o in out])
    n = args.ranks or (8 if args.cpu else min(8, torch.cuda.device_count()))
    ranks = distributed_step(n, dev)
    return {"forward": [_np(o) for o in out], "ranks": ranks,
            "orb_frames": 2}


if __name__ == "__main__":
    main()
