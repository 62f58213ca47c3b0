"""How far the AprilTag scene's corner and pose errors spread over scene
draws: the quantities that ``chip_smoke.py``'s ``apriltag`` gates read.

    python3 apriltag_spread.py                    # seeds 30-45 on the card
    python3 apriltag_spread.py --device cpu --first 30 --count 8

Each seed draws the 16 tag poses and the noise of ``chip_smoke.tag_scene``
anew (chip_smoke.py's scene is seed 30) and decodes the 1080p frame with
``AprilTagDecoder(DetectorConfig())``. Prints one JSON line per seed, then
a summary: the worst corner and rotation errors of all tags, of the tags
within ``TAG_GATES["near_m"]``, the rotation error that
``estimate_tag_pose`` makes from the true corners, and which seeds fail
the gates.
"""

import argparse
import json

import numpy as np
import torch

import chip_smoke as cs
from kornia_tpu_torch import apriltag


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--first", type=int, default=cs.SEED + 30)
    ap.add_argument("--count", type=int, default=16)
    args = ap.parse_args()
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("apriltag_spread: no CUDA device; pass --device cpu")
    dec = apriltag.AprilTagDecoder(device=args.device)
    tag_corners = np.array([[-1.0, -1], [1, -1], [1, 1], [-1, 1]])
    rows, failed, exact = [], [], 0.0
    for seed in range(args.first, args.first + args.count):
        gray, truth = cs.tag_scene(seed)
        errs = cs.tag_errors(dec.decode(gray), truth)
        bad = cs.tag_gate_failures(errs)
        for _, rot, t, corners in truth:
            det = apriltag.Detection(
                0, "tag36h11", 0, 0.0, corners.mean(0), corners,
                apriltag.detector._homography_dlt4(tag_corners, corners))
            pair = apriltag.estimate_tag_pose(det, cs.TAG_K, cs.TAG_SIZE)
            exact = max(exact, cs.rot_err_deg(pair.best.rotation, rot))
        near = [r for r in errs if r["depth_m"] <= cs.TAG_GATES["near_m"]]
        line = {"seed": seed, "failed": bad,
                "corner_px_max": max(r["corner_px"] for r in errs),
                "rot_deg_max": max(r["rot_deg"] for r in errs),
                "near_rot_deg_max": max(r["rot_deg"] for r in near),
                "trans_share_max": max(r["trans_share"] for r in errs),
                "corner_px_median": float(np.median(
                    [r["corner_px"] for r in errs])),
                "rot_deg_median": float(np.median(
                    [r["rot_deg"] for r in errs]))}
        rows.append(line)
        if bad:
            failed.append(seed)
        print(json.dumps(line), flush=True)
    print(json.dumps({
        "device": args.device, "seeds": [r["seed"] for r in rows],
        **{k: max(r[k] for r in rows) for k in (
            "corner_px_max", "rot_deg_max", "near_rot_deg_max",
            "trans_share_max", "corner_px_median", "rot_deg_median")},
        "rot_deg_from_true_corners_max": exact, "failed_seeds": failed}))


if __name__ == "__main__":
    main()
