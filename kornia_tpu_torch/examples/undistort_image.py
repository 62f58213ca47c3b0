"""Undistort an image with Brown-Conrady calibration, on the card (port of
examples/undistort_image.py; examples/undistort_image and
undistort_points_image): the correction map, then K7's remap.

    python -m kornia_tpu_torch.examples.undistort_image --image PATH
        [--output out.png] [--k1 -0.25] [--k2 0.06] [--cpu]
"""

from __future__ import annotations

import numpy as np

from kornia_tpu_torch import io as kio
from kornia_tpu_torch.examples._common import (DOG_JPEG, base_parser,
                                               configure_backend,
                                               ms_per_call, require_file)
from kornia_tpu_torch.geometry import camera


def calibration(h: int, w: int, k1: float, k2: float):
    """(K, dist): focal 0.9·w, the centre, radial k1 and k2."""
    k = np.array([[0.9 * w, 0, w / 2], [0, 0.9 * w, h / 2], [0, 0, 1]],
                 np.float32)
    return k, np.array([k1, k2, 0, 0, 0], np.float32)


def main(argv=None) -> dict:
    p = base_parser(__doc__)
    p.add_argument("--image", default=None)
    p.add_argument("--output", default=None)
    p.add_argument("--k1", type=float, default=-0.25)
    p.add_argument("--k2", type=float, default=0.06)
    args = p.parse_args(argv)
    require_file(p, args.image, "--image", DOG_JPEG)
    dev = configure_backend(args)

    img = kio.read_image_any_rgb8(args.image)
    h, w = img.shape[:2]
    k, dist = calibration(h, w, args.k1, args.k2)

    def step():
        return camera.undistort_image(img, k, dist, device=dev)

    out, reps = step(), 10
    ms = ms_per_call(step, reps, dev)
    print(f"undistort {h}x{w}: {ms:.3f} ms")

    out = out.cpu().numpy()
    if args.output:
        kio.write_image_png(args.output, out)
        print(f"wrote {args.output}")
    return {"image": out, "ms": ms, "undistort_calls": 1 + reps}


if __name__ == "__main__":
    main()
