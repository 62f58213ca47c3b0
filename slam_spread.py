"""How far repeated runs of ``chip_smoke.py``'s SLAM loop spread: the
keyframe ATE, keyframe count, loops, tracked share and loop time that its
ground-truth gates read.

    python3 slam_spread.py                  # 5 trials on the card
    python3 slam_spread.py --trials 8 --device cpu

Every trial runs ``MonocularSlam`` over the same rendered 480×752
out-and-back sequence (``chip_smoke.slam_sequence``) with the same
vocabulary; trial i seeds the RANSAC draws with i (chip_smoke.py's run is
seed 0); the card's segmented sums give the same bits every run, so
the trials differ by their draws alone. Prints one JSON line per trial, then a summary:
the worst value of each gated quantity, and which trials fail the gates.
"""

import argparse
import json

import numpy as np
import torch

import chip_smoke as cs


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--trials", type=int, default=5)
    args = ap.parse_args()
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("slam_spread: no CUDA device; pass --device cpu")
    frames, _, centres = cs.slam_sequence()
    vocab = cs.slam_vocabulary(frames, args.device)
    runs = []
    for seed in range(args.trials):
        system, ms = cs.run_slam(frames, vocab, args.device, seed=seed)
        s = cs.slam_summary(system, ms, centres, args.device)
        s.update(seed=seed, failed=cs.slam_gates(s))
        runs.append(s)
        print(json.dumps(s), flush=True)
    ate = [r["ate_rmse"] for r in runs]
    out = {"device": args.device, "trials": args.trials,
           "ate_rmse": {"max": max(ate), "min": min(ate),
                        "median": float(np.median(ate))},
           "keyframes": sorted({r["keyframes"] for r in runs}),
           "tracked_min": min(r["tracked"] for r in runs),
           "first_loop_frame": [r["loops"][0][0] if r["loops"] else None
                                for r in runs],
           "oldest_loop_keyframe": [min(o for _, o in r["loops"])
                                    if r["loops"] else None for r in runs],
           "loop_s": [r["loop_s"] for r in runs],
           "ate_gate": cs.SLAM_ATE_BOUND,
           "failing_trials": [r["seed"] for r in runs if r["failed"]]}
    if args.device == "cuda":
        out["card"] = cs.card()
    print(json.dumps(out))


if __name__ == "__main__":
    main()
