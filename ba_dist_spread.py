"""How far the distributed Schur BA of ``chip_smoke.py``'s ``parallel``
phase lands from the single-process solve, solve after solve, for the
Dense (170 × 3000, chol) and PCG (600 × 8000, cg_dense) global BA
configurations, after 2 and 12 LM iterations (Huber 2).

    python3 ba_dist_spread.py [--trials N]

On the card each segmented sum adds every segment in one order, so two
single-process solves of one problem give the same bits; the distributed
solve, on 4 gloo ranks that share the card, keyframe-sharded, adds in
another order. Prints one JSON object: per
configuration and iteration count the largest pose, point and relative
cost difference of the single-process solves from the first one, and of
the distributed solves from it.
"""

import argparse
import json

import numpy as np

import chip_smoke as cs
from kornia_tpu_torch import parallel
from kornia_tpu_torch.optim import ba
from kornia_tpu_torch.parallel import ba_dist

CONFIGS = {"dense 170x3000": (170, 3000, 1, 0.2),
           "pcg 600x8000": (600, 8000, 1, 0.0375)}


def _params(iters):
    return ba.BAParams(max_iterations=iters, loss="huber", loss_scale=2.0)


def _host(res):
    return (res.poses.cpu().numpy(), res.points.cpu().numpy(),
            float(res.final_cost))


def rank_trials(mesh, problems, trials):
    """Every rank: ``trials`` distributed solves of each problem; rank
    0's results."""
    out = {}
    for (name, iters), sharded in problems.items():
        runs = [_host(ba_dist.bundle_adjust_schur_dist_kf(
            sharded, mesh, _params(iters))) for _ in range(trials)]
        out[(name, iters)] = runs
    return out if mesh.rank == 0 else None


def _diff(a, b):
    return (float(np.abs(a[0] - b[0]).max()), float(np.abs(a[1] - b[1])
            .max()), abs(a[2] - b[2]) / b[2])


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trials", type=int, default=6)
    args = ap.parse_args()
    problems, single = {}, {}
    for name, shape in CONFIGS.items():
        prob, _ = cs.synth_ba_problem(*shape, "cpu")
        card = cs._problem_to(prob, "cuda")
        for iters in (2, cs.PAR_BA_ITERS):
            problems[(name, iters)] = ba_dist.shard_problem_by_keyframe(
                prob, cs.PAR_RANKS)
            single[(name, iters)] = [
                _host(ba.bundle_adjust_schur(card, _params(iters)))
                for _ in range(args.trials)]
    dist = parallel.mesh.spawn(
        rank_trials, cs.PAR_RANKS, problems, args.trials,
        devices=[cs.PAR_DEVICE] * cs.PAR_RANKS, timeout=1800)[0]
    out = {"trials": args.trials, "ranks": cs.PAR_RANKS, "card": cs.card()}
    for key, runs in single.items():
        ref = runs[0]
        s = [_diff(r, ref) for r in runs[1:]]
        d = [_diff(r, ref) for r in dist[key]]
        out[f"{key[0]}, {key[1]} iterations"] = {
            "single_vs_single": [max(x[i] for x in s) for i in range(3)],
            "dist_vs_single_max": [max(x[i] for x in d) for i in range(3)],
            "dist_vs_single_min": [min(x[i] for x in d) for i in range(3)]}
    print(json.dumps(out))


if __name__ == "__main__":
    main()
