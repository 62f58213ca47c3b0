"""Baseline config 1: decode → grayscale → FAST corners, on the card
(port of examples/fast_detector.py; SURVEY.md §3.1's call stack).

    python -m kornia_tpu_torch.examples.fast_detector --image PATH
        [--threshold 20] [--max-keypoints 2048] [--output out.png] [--cpu]
"""

from __future__ import annotations

from kornia_tpu_torch import io as kio
from kornia_tpu_torch.examples._common import (DOG_JPEG, base_parser,
                                               configure_backend,
                                               ms_per_call, require_file)
from kornia_tpu_torch.features import fast
from kornia_tpu_torch.ops import color, draw


def detect(img, threshold: float, max_keypoints: int, device):
    """(H, W, 3) u8 RGB → FAST keypoints on ``device``: gray, then one
    ``fast_detect`` (K1's score-only entry)."""
    gray = color.rgb_to_gray(img, device=device)[..., 0]
    return fast.fast_detect(gray, threshold=threshold,
                            max_keypoints=max_keypoints, device=device)


def main(argv=None) -> dict:
    p = base_parser(__doc__)
    p.add_argument("--image", default=None)
    p.add_argument("--threshold", type=float, default=20.0)
    p.add_argument("--max-keypoints", type=int, default=2048)
    p.add_argument("--output", default=None,
                   help="write a visualization PNG")
    args = p.parse_args(argv)
    require_file(p, args.image, "--image", DOG_JPEG)
    dev = configure_backend(args)

    img = kio.read_image_any_rgb8(args.image)
    print(f"image: {args.image} {img.shape}")

    def step():
        return detect(img, args.threshold, args.max_keypoints, dev)

    kps, reps = step(), 10
    ms = ms_per_call(step, reps, dev)
    print(f"detect: {ms:.3f} ms/frame")

    mask = kps.mask.cpu().numpy()
    n = int(mask.sum())
    print(f"corners: {n}")
    xy = kps.xy.cpu().numpy()[mask]
    for x, y in xy[:5]:
        print(f"  ({x:.0f}, {y:.0f})")

    if args.output:
        vis = draw.draw_keypoints(img, xy, device=dev)
        kio.write_image_png(args.output, vis.cpu().numpy())
        print(f"wrote {args.output}")
    return {"corners": n, "xy": xy, "ms": ms, "detect_calls": 1 + reps}


if __name__ == "__main__":
    main()
