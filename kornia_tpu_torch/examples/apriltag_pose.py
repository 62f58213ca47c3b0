"""Baseline config 3: AprilTag detection + 6-DOF pose over a sequence, the
threshold on the card (port of examples/apriltag_pose.py; examples/
apriltag and apriltag_pose, SURVEY.md §3.5). Runs on the reference photo
fixture by default, or renders a synthetic moving-tag sequence with
--synthetic.

    python -m kornia_tpu_torch.examples.apriltag_pose (--image PATH |
        --synthetic N) [--tag-size 0.16] [--cpu]
"""

from __future__ import annotations

import numpy as np

from kornia_tpu_torch import apriltag as at
from kornia_tpu_torch.examples._common import (APRILTAG_JPG, base_parser,
                                               configure_backend, require_file)

K = np.array([[600.0, 0, 320], [0, 600.0, 240], [0, 0, 1]])


def synthetic_frame(i: int, tag_size: float) -> np.ndarray:
    """Frame ``i`` of the synthetic sequence: tag36h11 id 42 warped by cv2
    onto a 640×480 white frame, 0.8 + 0.05·i m away, 0.02·i m right."""
    import cv2

    tag = at.render_tag(at.get_family("tag36h11"), 42, scale=20)
    s = tag.shape[0]
    src = np.array([[s * .1, s * .1], [s * .9, s * .1],
                    [s * .9, s * .9], [s * .1, s * .9]], np.float32)
    z = 0.8 + 0.05 * i
    half = tag_size / 2
    obj = np.array([[-half, -half, 0], [half, -half, 0],
                    [half, half, 0], [-half, half, 0]])
    cam = obj + [0.02 * i, 0, z]
    px = cam @ K.T
    px = (px[:, :2] / px[:, 2:]).astype(np.float32)
    h, _ = cv2.findHomography(src, px)
    return cv2.warpPerspective(tag, h, (640, 480), borderValue=255)


def main(argv=None) -> dict:
    p = base_parser(__doc__)
    p.add_argument("--image", default=None)
    p.add_argument("--synthetic", type=int, default=0,
                   help="render an N-frame synthetic sequence instead")
    p.add_argument("--tag-size", type=float, default=0.16)
    args = p.parse_args(argv)
    if not args.synthetic:
        require_file(p, args.image, "--image", APRILTAG_JPG)
    dev = configure_backend(args)

    det = at.AprilTagDecoder(device=dev)
    found = []

    if args.synthetic:
        for i in range(args.synthetic):
            ds = det.decode(synthetic_frame(i, args.tag_size))
            if not ds:
                print(f"frame {i}: no detection")
                found.append(None)
                continue
            pose = at.estimate_tag_pose(ds[0], K, args.tag_size)
            t = pose.best.translation
            print(f"frame {i}: id {ds[0].tag_id} "
                  f"t=({t[0]:+.3f}, {t[1]:+.3f}, {t[2]:.3f}) m "
                  f"ambiguity {pose.ambiguity:.2f}")
            found.append((ds[0].tag_id, np.asarray(t, np.float64)))
        return {"frames": found}

    import cv2

    gray = cv2.imread(args.image, cv2.IMREAD_GRAYSCALE)
    if gray is None:
        raise SystemExit(f"cannot read {args.image}")
    ds = det.decode(gray)
    print(f"{len(ds)} tags detected")
    for d in ds:
        pose = at.estimate_tag_pose(d, K, args.tag_size)
        t = pose.best.translation
        print(f"  id {d.tag_id} ham {d.hamming} "
              f"center ({d.center[0]:.0f}, {d.center[1]:.0f}) "
              f"t=({t[0]:+.2f}, {t[1]:+.2f}, {t[2]:.2f})")
        found.append((d.tag_id, np.asarray(t, np.float64)))
    return {"tags": found}


if __name__ == "__main__":
    main()
