"""Two-view relative pose on the EuRoC MH01 frame pair, on the card (port
of examples/two_view.py; benchmarks.md §Two-view): ORB on both frames,
Hamming match, then the 8-point or 5-point RANSAC bootstrap.

    python -m kornia_tpu_torch.examples.two_view --frame-a PATH
        --frame-b PATH [--solver 8pt|5pt] [--cpu]
"""

from __future__ import annotations

import numpy as np
import torch

from kornia_tpu_torch import io as kio
from kornia_tpu_torch.examples._common import (MH01_A, MH01_B, base_parser,
                                               configure_backend,
                                               ms_per_call, require_file)
from kornia_tpu_torch.features import matching, orb
from kornia_tpu_torch.geometry import twoview

K_EUROC = np.array([[458.654, 0, 367.215],
                    [0, 457.296, 248.375], [0, 0, 1]], np.float32)
ORB_CONFIG = orb.OrbConfig(n_features=800, n_levels=4)


def front_end(g1, g2, device):
    """ORB on both frames and the ratio-tested match: (f1, f2, matches)."""
    f1 = orb.orb_detect_and_describe(g1, ORB_CONFIG, device=device)
    f2 = orb.orb_detect_and_describe(g2, ORB_CONFIG, device=device)
    m = matching.match_descriptors(
        f1.descriptors, f2.descriptors, a_mask=f1.mask, b_mask=f2.mask,
        max_distance=64, ratio=0.8, device=device)
    return f1, f2, m


def pose(f1, f2, m, params: twoview.TwoViewParams, device, samples=None):
    """The bootstrap on the matched points. The hypotheses come from a
    generator seeded 0 on ``device`` (the reference's ``PRNGKey(0)``) or,
    given, from ``samples`` (``estimate_relative_pose``'s seam)."""
    x2 = f2.xy[torch.clamp(m.idx, min=0).long()]
    gen = (None if samples is not None
           else torch.Generator(device=device).manual_seed(0))
    return twoview.estimate_relative_pose(
        f1.xy, x2, K_EUROC, K_EUROC, mask=m.mask, params=params,
        generator=gen, samples=samples, device=device)


def bootstrap(g1, g2, params: twoview.TwoViewParams, device):
    f1, f2, m = front_end(g1, g2, device)
    return pose(f1, f2, m, params, device), m


def main(argv=None) -> dict:
    p = base_parser(__doc__)
    p.add_argument("--solver", default="8pt", choices=["8pt", "5pt"])
    p.add_argument("--frame-a", default=None)
    p.add_argument("--frame-b", default=None)
    args = p.parse_args(argv)
    require_file(p, args.frame_a, "--frame-a", MH01_A)
    require_file(p, args.frame_b, "--frame-b", MH01_B)
    dev = configure_backend(args)

    g1 = kio.read_image_any_gray8(args.frame_a)[:, :, 0]
    g2 = kio.read_image_any_gray8(args.frame_b)[:, :, 0]
    params = twoview.TwoViewParams(solver=args.solver)

    (res, m), reps = bootstrap(g1, g2, params, dev), 10
    ms = ms_per_call(lambda: bootstrap(g1, g2, params, dev), reps, dev)

    n_matches = int(m.mask.sum())
    r = res.rotation.cpu().numpy()
    t = res.translation.cpu().numpy()
    ang = np.rad2deg(np.arccos(np.clip((np.trace(r) - 1) / 2, -1, 1)))
    n_inl = int(res.n_inliers)
    use_h = bool(res.use_homography)
    print(f"solver: {args.solver}")
    print(f"matches: {n_matches}, inliers: {n_inl}, "
          f"model: {'H' if use_h else 'E/F'}")
    print(f"rotation magnitude: {ang:.2f}°, t = {t.round(3)}")
    print(f"detect+match+pose: {ms:.3f} ms")
    return {"matches": n_matches, "inliers": n_inl, "homography": use_h,
            "rotation": r, "translation": t, "ms": ms, "orb_frames": 2 * (1 + reps)}


if __name__ == "__main__":
    main()
