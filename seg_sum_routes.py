"""The back end's solves on the card with each route of its segmented
sums, in turns within one process: ``atomic`` (``index_add_``, whose
atomics add in another order each run), ``sorted`` (every sum through
``index_put_(accumulate=True)``, which sorts its index each call) and
``planned`` (what ``optim/ba.py`` runs: each step sorts the camera and
point indices once, ``ba._segments``, and sums by ``segment_reduce``;
the camera coupling's pair index and PGO stay ``sorted``).

    python3 seg_sum_routes.py [--reps 4]

Cases: BA on chip_smoke.py's Dense (170 × 3000) and PCG (600 × 8000)
configurations, 12 LM iterations, Huber 2; one PCG reduced solve (60 CG
steps) at the PCG configuration's first iterate; PGO on the 256-keyframe
ring, 15 iterations. Prints one JSON line per case: call ms (host clock
around a synchronised call; median and min over ``--reps`` turns), device
ms (``chip_smoke.device_ms``), whether every run of a route gave the same
bits, and whether the tree's route waits for the device (sync debug mode
"error"); then the card's name and power limit.
"""

import argparse
import json
import time

import numpy as np
import torch

import chip_smoke as cs
from kornia_tpu_torch.optim import ba, pgo


def _seg_sum_atomic(vals, idx, n):
    out = torch.zeros((n,) + vals.shape[1:], dtype=vals.dtype,
                      device=vals.device)
    return out.index_add_(0, idx, vals)


def _indices(obs_cam, obs_pt, p, n):
    return obs_cam, obs_pt


ROUTES = {"atomic": (_seg_sum_atomic, _indices),
          "sorted": (ba._seg_sum, _indices),
          "planned": (ba._seg_sum, ba._segments)}


def _use(route):
    ba._seg_sum = pgo._seg_sum = ROUTES[route][0]
    ba._segments = ROUTES[route][1]


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=4)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("seg_sum_routes: no CUDA device")
    dev = cs.DEV
    dense = cs._problem_to(cs.synth_ba_problem(170, 3000, 1, 0.2, "cpu")[0],
                           dev)
    pcg = cs._problem_to(cs.synth_ba_problem(600, 8000, 1, 0.0375,
                                             "cpu")[0], dev)
    ring, _ = cs.pgo_ring(dev)
    huber = dict(max_iterations=12, loss="huber", loss_scale=2.0)
    pd, pc = ba.BAParams(**huber), ba.BAParams(**huber, solver="pcg")
    eqs = ba.schur_normal_equations(pcg, pcg.poses, pcg.points, pc)
    lam = torch.full((), pc.lambda_init, device=dev)
    all3 = ("atomic", "sorted", "planned")
    cases = {
        "BA dense 170x3000": (
            lambda: ba.bundle_adjust_schur(dense, pd).poses, all3),
        "BA PCG 600x8000": (
            lambda: ba.bundle_adjust_schur(pcg, pc).poses, all3),
        "PCG reduced solve 600x8000": (
            lambda: ba._pcg_reduced_solve(pcg, *eqs, lam, pc.cg_iters)[0],
            all3),
        "PGO ring 256 x15": (
            lambda: pgo.pose_graph_optimize(**ring, params=pgo.PGOParams(
                max_iterations=15)).poses, ("atomic", "sorted"))}
    for name, (fn, routes) in cases.items():
        res = {r: {"ms": [], "out": []} for r in routes}
        for _ in range(args.reps):
            for route in routes + routes[::-1]:
                _use(route)
                torch.cuda.synchronize()
                t = time.perf_counter()
                out = fn()
                torch.cuda.synchronize()
                res[route]["ms"].append((time.perf_counter() - t) * 1e3)
                res[route]["out"].append(out.cpu())
        row = {"case": name}
        for route, r in res.items():
            _use(route)
            row[route] = {
                "call_ms_median": float(np.median(r["ms"][1:])),
                "call_ms_min": float(np.min(r["ms"])),
                "device_ms": cs.device_ms(fn, reps=2, warmup=1,
                                          cuda_only=True),
                "same_bits_every_run": all(torch.equal(o, r["out"][0])
                                           for o in r["out"])}
        _use(routes[-1])
        try:
            cs._no_wait(fn)
            row["tree_route_waits_for_device"] = False
        except RuntimeError:
            row["tree_route_waits_for_device"] = True
        _use("planned")
        print(json.dumps(row), flush=True)
    print(json.dumps({"card": cs.card()}))


if __name__ == "__main__":
    main()
