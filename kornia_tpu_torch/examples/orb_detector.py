"""Baseline config 2: ORB detect + describe + match over an image pair, on
the card (port of examples/orb_detector.py: the reprojection error under
a known warp, benchmarks.md §ORB e2e quality).

    python -m kornia_tpu_torch.examples.orb_detector --image PATH
        [--n-features 1000] [--cpu]
"""

from __future__ import annotations

import numpy as np

from kornia_tpu_torch import io as kio
from kornia_tpu_torch.examples._common import (DOG_JPEG, base_parser,
                                               configure_backend,
                                               ms_per_call, require_file)
from kornia_tpu_torch.features import matching, orb
from kornia_tpu_torch.ops import color


def warped_pair(img, device):
    """(gray, warped, m): the gray image, the same rotated by 8° about its
    centre, scaled by 0.95 and moved 6 px right (cv2), and that 2×3 warp."""
    import cv2

    gray = color.rgb_to_gray(img, device=device)[..., 0].cpu().numpy()
    m = cv2.getRotationMatrix2D(
        (gray.shape[1] / 2, gray.shape[0] / 2), 8.0, 0.95)
    m[0, 2] += 6
    warped = cv2.warpAffine(gray, m, (gray.shape[1], gray.shape[0]))
    return gray, warped, m


def step(a, b, cfg: orb.OrbConfig, device):
    """ORB on both frames, then the ratio-tested Hamming match."""
    fa = orb.orb_detect_and_describe(a, cfg, device=device)
    fb = orb.orb_detect_and_describe(b, cfg, device=device)
    mm = matching.match_descriptors(
        fa.descriptors, fb.descriptors, a_mask=fa.mask, b_mask=fb.mask,
        max_distance=64, ratio=0.8, device=device)
    return fa, fb, mm


def reprojection(fa, fb, mm, m):
    """(matches, each match's error under the known warp ``m`` in px)."""
    ok = mm.mask.cpu().numpy()
    ia = np.nonzero(ok)[0]
    ib = mm.idx.cpu().numpy()[ok]
    xa = fa.xy.cpu().numpy()[ia]
    xb = fb.xy.cpu().numpy()[ib]
    proj = xa @ m[:, :2].T + m[:, 2]
    return int(ok.sum()), np.linalg.norm(proj - xb, axis=1)


def main(argv=None) -> dict:
    p = base_parser(__doc__)
    p.add_argument("--image", default=None)
    p.add_argument("--n-features", type=int, default=1000)
    args = p.parse_args(argv)
    require_file(p, args.image, "--image", DOG_JPEG)
    dev = configure_backend(args)

    img = kio.read_image_any_rgb8(args.image)
    gray, warped, m = warped_pair(img, dev)
    cfg = orb.OrbConfig(n_features=args.n_features, n_levels=4)

    (fa, fb, mm), reps = step(gray, warped, cfg, dev), 5
    ms = ms_per_call(lambda: step(gray, warped, cfg, dev), reps, dev)
    print(f"detect+describe+match: {ms:.2f} ms/pair")

    n, err = reprojection(fa, fb, mm, m)
    inl = err < 3.0
    med = float(np.median(err[inl]))
    print(f"matches: {n}, inlier rate {inl.mean():.2f}, "
          f"median reproj err {med:.2f} px")
    return {"matches": n, "inlier_rate": float(inl.mean()),
            "median_err": med, "ms": ms, "orb_frames": 2 * (1 + reps)}


if __name__ == "__main__":
    main()
