"""How far repeated runs of the ``slam_demo`` example's synthetic mode
(43 frames of the camera circle, 5 loop closures) spread on the card,
alone and against ``--mesh N``: the figures ``chip_smoke.py``'s gates of
the example read (keyframe poses, loops, map points, ATE).

    python3 slam_demo_spread.py                  # 3 single runs, 2 --mesh 4
    python3 slam_demo_spread.py --single 4 --mesh-runs 1 --ranks 2

Every run takes the same observations and the same RANSAC seed (0); on
the card each segmented sum adds in one order, so the single runs give
the same bits, and the mesh's summed Schur BA adds its observations in
another order than the single process. Prints one JSON line per run,
then a summary: the largest |Δ| of the keyframe poses between single runs
(each against the first) and between each mesh run and each single run,
and every printed line, keyframe list and map-point count that differs
from the first single run's.
"""

import argparse
import contextlib
import io
import json
import time

import numpy as np
import torch

import chip_smoke as cs
from kornia_tpu_torch.examples import slam_demo


def run(argv):
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        res = slam_demo.main(argv)
    torch.cuda.synchronize()
    return res, out.getvalue().splitlines(), time.perf_counter() - t0


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--single", type=int, default=3)
    ap.add_argument("--mesh-runs", type=int, default=2)
    ap.add_argument("--ranks", type=int, default=4)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("slam_demo_spread: no CUDA device")
    runs = {"single": [], "mesh": []}
    for kind, n, argv in (("single", args.single, []),
                          ("mesh", args.mesh_runs,
                           ["--mesh", str(args.ranks)])):
        for i in range(n):
            res, lines, s = run(argv)
            runs[kind].append((res, lines))
            print(json.dumps({"run": kind, "i": i, "s": s,
                              "ate": res["ate"], "loops": res["loops"],
                              "keyframes": res["keyframes"],
                              "map_points": res["map_points"]}),
                  flush=True)

    def d(a, b):
        if a["poses"].shape != b["poses"].shape:
            return float("inf")
        return float(np.abs(a["poses"] - b["poses"]).max())

    single, mesh = runs["single"], runs["mesh"]
    base = single[0]

    def diff(res, lines):
        """What of a run differs from the first single run."""
        lines = [x for x in lines
                 if not x.startswith(("--mesh", "distributed"))]
        return {"lines": [[a, b] for a, b in zip(base[1], lines) if a != b]
                + ([["<count>", f"{len(base[1])} vs {len(lines)}"]]
                   if len(lines) != len(base[1]) else []),
                "kf_frames_equal": res["kf_frames"] == base[0]["kf_frames"],
                "map_points": [base[0]["map_points"], res["map_points"]],
                "loops": [base[0]["loops"], res["loops"]]}

    out = {
        "single_vs_first": [d(r, base[0]) for r, _ in single[1:]],
        "single_lines_equal": [ln == base[1] for _, ln in single[1:]],
        "mesh_vs_single": [[d(m, r) for r, _ in single] for m, _ in mesh],
        "mesh_lines_equal_single": [
            [x for x in ln if not x.startswith(("--mesh", "distributed"))]
            == base[1] for _, ln in mesh],
        "single_diffs": [diff(r, ln) for r, ln in single[1:]],
        "mesh_diffs": [diff(m, ln) for m, ln in mesh],
        "ate_single": [r["ate"] for r, _ in single],
        "ate_mesh": [m["ate"] for m, _ in mesh],
        "ranks": args.ranks,
        "card": cs.card(),
    }
    print(json.dumps(out))


if __name__ == "__main__":
    main()
