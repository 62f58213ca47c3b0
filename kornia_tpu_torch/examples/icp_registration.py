"""Baseline config 4: ICP registration + a pose graph over point clouds, on
the card (port of examples/icp_registration.py; examples/icp_registration
and ply_rerun). Makes a synthetic scan sequence (or reads --ply files),
registers consecutive pairs with ICP, chains them into a pose graph and
optimizes it with PGO.

    python -m kornia_tpu_torch.examples.icp_registration [--ply a.ply ...]
        [--n-scans 4] [--cpu]
"""

from __future__ import annotations

import numpy as np
import torch

from kornia_tpu_torch import io as kio
from kornia_tpu_torch.examples._common import base_parser, configure_backend
from kornia_tpu_torch.geometry import icp, liegroup as lg
from kornia_tpu_torch.optim import pgo


def synthetic_scans(n_scans: int, rng):
    """``n_scans`` noisy views of one surface (1500 points) from drifting
    poses, each moved on the CPU in float32."""
    base = rng.uniform(-1, 1, (1500, 3)).astype(np.float32)
    base[:, 2] = 0.2 * np.sin(3 * base[:, 0]) + 0.1 * base[:, 1] ** 2
    clouds = []
    for i in range(n_scans):
        xi = np.array([0, 0, 0.06 * i, 0.08 * i, 0.02 * i, 0], np.float32)
        t = lg.se3_exp(torch.as_tensor(xi))
        moved = lg.se3_apply(t[None], torch.as_tensor(base)).numpy()
        clouds.append((moved + rng.normal(0, 0.003, moved.shape))
                      .astype(np.float32))
    return base, clouds


def register(clouds, device):
    """ICP (30 iterations) pair by pair on ``device``: (the chained poses,
    the (i, i + 1, relative pose) edges)."""
    poses = [np.array([1, 0, 0, 0, 0, 0, 0], np.float32)]
    edges = []
    for i in range(len(clouds) - 1):
        res = icp.icp_vanilla(clouds[i + 1], clouds[i],
                              icp.ICPParams(max_iterations=30),
                              device=device)
        r = res.rotation.cpu()
        t = res.translation.cpu().numpy()
        q = lg.matrix_to_quat(r).numpy()
        rel = np.concatenate([q, t]).astype(np.float32)
        print(f"pair {i}->{i+1}: rmse {float(res.rmse):.4f}, "
              f"|t| {np.linalg.norm(t):.3f}")
        poses.append(lg.se3_compose(torch.as_tensor(rel),
                                    torch.as_tensor(poses[-1])).numpy())
        edges.append((i, i + 1, rel))
    return poses, edges


def main(argv=None) -> dict:
    p = base_parser(__doc__)
    p.add_argument("--ply", nargs="*", default=None)
    p.add_argument("--n-scans", type=int, default=4)
    args = p.parse_args(argv)
    dev = configure_backend(args)

    rng = np.random.default_rng(0)
    if args.ply:
        clouds = [kio.read_ply(f)["points"].astype(np.float32)
                  for f in args.ply]
        print(f"loaded {len(clouds)} PLY clouds")
    else:
        base, clouds = synthetic_scans(args.n_scans, rng)
        print(f"synthesized {len(clouds)} scans of {base.shape[0]} points")

    poses, edges = register(clouds, dev)
    ei = np.asarray([e[0] for e in edges], np.int32)
    ej = np.asarray([e[1] for e in edges], np.int32)
    meas = np.stack([e[2] for e in edges])
    res = pgo.pose_graph_optimize(
        torch.as_tensor(np.stack(poses), device=dev), ei, ej, meas,
        params=pgo.PGOParams(max_iterations=10))
    c0, c1 = float(res.initial_cost), float(res.final_cost)
    print(f"PGO: cost {c0:.6f} -> {c1:.6f}")
    out = res.poses.cpu().numpy()
    for i, pose in enumerate(out):
        print(f"  scan {i}: t = {pose[4:].round(3)}")
    return {"initial_cost": c0, "final_cost": c1, "poses": out,
            "relative": meas}


if __name__ == "__main__":
    main()
