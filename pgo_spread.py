"""How far two summation orders leave the PGO solve of ``chip_smoke.py``'s
256-keyframe ring apart, after 2 and after 15 LM iterations.

    python3 pgo_spread.py                    # card solves against the CPU route
    python3 pgo_spread.py --device cpu       # CPU solves with permuted edges

On the card each solve sums with atomics in its own order; on the CPU the
edges are permuted instead (this reorders ``index_add_`` and the cost's
sum). Prints one JSON object: for each iteration count the largest and
smallest pose difference from the unpermuted CPU solve, how many trials
are over 1e-3, and the largest relative final-cost difference.
"""

import argparse
import json

import torch

import chip_smoke as cs
from kornia_tpu_torch.optim import pgo

EDGE_KEYS = ("edge_i", "edge_j", "edge_meas", "edge_weight")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--trials", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    ring, _ = cs.pgo_ring(args.device)
    cpu_ring = {k: v.cpu() for k, v in ring.items()}
    gen = torch.Generator().manual_seed(args.seed)
    n_edges = ring["edge_i"].shape[0]
    perms = [torch.randperm(n_edges, generator=gen)
             for _ in range(args.trials)]
    out = {"device": args.device, "trials": args.trials}
    for iters in (2, 15):
        params = pgo.PGOParams(max_iterations=iters)
        ref = pgo.pose_graph_optimize(**cpu_ring, params=params)
        d_pose, d_cost = [], []
        for perm in perms:
            trial = dict(ring)
            if args.device == "cpu":
                trial.update({k: ring[k][perm] for k in EDGE_KEYS})
            res = pgo.pose_graph_optimize(**trial, params=params)
            d_pose.append(float((res.poses.cpu() - ref.poses).abs().max()))
            d_cost.append(abs(float(res.final_cost) - float(ref.final_cost))
                          / float(ref.final_cost))
        out[str(iters)] = {"pose_max": max(d_pose), "pose_min": min(d_pose),
                           "over_1e-3": sum(d > 1e-3 for d in d_pose),
                           "cost_rel_max": max(d_cost)}
    if args.device == "cuda":
        out["card"] = cs.card()
    print(json.dumps(out))


if __name__ == "__main__":
    main()
