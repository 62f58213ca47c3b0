"""Live ORB tracking loop with an FPS meter, ORB and matching on the card
(port of examples/orb_tracking_live.py; the orb_detector example's live
V4L2 match loop and FpsCounter, kornia-io/src/fps_counter.rs).

Grabs frames from a camera (``v4l2:/dev/video0``), a directory-backed
virtual camera (``dir:frames/``), or — with no source — a synthetic
panning camera over a textured scene; runs ORB and the cross-checked
match frame to frame; prints tracked-match counts and the rolling frame
rate; optionally writes the matched-track trajectory view.

    python -m kornia_tpu_torch.examples.orb_tracking_live
        [--source dir:frames] [--frames 120] [--n-features 800]
        [--viz tracks.html] [--cpu]
"""

from __future__ import annotations

import numpy as np

from kornia_tpu_torch.examples._common import base_parser, configure_backend
from kornia_tpu_torch.features import matching, orb
from kornia_tpu_torch.io.fps_counter import FpsCounter


def _synthetic_frames(n, rng):
    """A 640×480 window panning 2 px a frame over a cubic-upsampled noise
    texture (cv2)."""
    import cv2

    tex = cv2.resize((rng.random((120, 160)) * 255).astype("uint8"),
                     (1280, 960), interpolation=cv2.INTER_CUBIC)
    for i in range(n):
        x0 = 2 * i
        yield tex[240: 720, x0: x0 + 640]


def track(prev, feats, device):
    """(tracked matches, median flow (dx, dy) in px) from ``prev``'s
    features to ``feats``' (cross-checked Hamming match)."""
    m = matching.match_descriptors(
        prev.descriptors, feats.descriptors,
        a_mask=prev.mask, b_mask=feats.mask, cross_check=True,
        device=device)
    ok = m.mask.cpu().numpy()
    nm = int(ok.sum())
    ia = np.nonzero(ok)[0]
    ib = m.idx.cpu().numpy()[ia]
    flow = feats.xy.cpu().numpy()[ib] - prev.xy.cpu().numpy()[ia]
    med = np.median(flow, axis=0) if nm else (0.0, 0.0)
    return nm, med


def main(argv=None) -> dict:
    p = base_parser(__doc__)
    p.add_argument("--source", default=None,
                   help="v4l2:/dev/videoN | dir:PATH | camera index; "
                        "default: synthetic panning scene")
    p.add_argument("--frames", type=int, default=120)
    p.add_argument("--n-features", type=int, default=800)
    p.add_argument("--viz", default=None, metavar="OUT.html")
    args = p.parse_args(argv)
    dev = configure_backend(args)

    cfg = orb.OrbConfig(n_features=args.n_features, n_levels=4)
    rng = np.random.default_rng(0)
    if args.source is None:
        frames = _synthetic_frames(args.frames, rng)
        grab = lambda: next(frames)  # noqa: E731
    else:
        from kornia_tpu_torch.io.video import CameraCapture, NativeCapture

        if args.source.isdigit():
            cap = CameraCapture(int(args.source))
        else:
            cap = NativeCapture(args.source)
        grab = lambda: np.asarray(cap.grab_frame()).mean(-1).astype(  # noqa
            np.uint8)

    meter = FpsCounter(window=30)
    prev = None
    centers, counts = [], []
    n_frames = 0
    for i in range(args.frames):
        try:
            g = grab()
        except StopIteration:
            break
        if g.ndim == 3:
            g = g.mean(-1).astype(np.uint8)
        feats = orb.orb_detect_and_describe(np.ascontiguousarray(g), cfg,
                                            device=dev)
        n_frames += 1
        if prev is not None:
            nm, med = track(prev, feats, dev)
            counts.append(nm)
            centers.append([float(med[0]), float(med[1]), 0.0])
            meter.tick()
            if i % 10 == 0:
                print(f"frame {i}: {nm} tracked matches, median flow "
                      f"({med[0]:+.1f}, {med[1]:+.1f}) px, "
                      f"{meter.fps():.1f} fps")
        prev = feats

    print(f"done: {meter.fps():.1f} fps over the last "
          f"{min(30, args.frames)} frames")
    if args.viz and centers:
        from kornia_tpu_torch.utils.viz import write_trajectory_html

        traj = np.cumsum(np.asarray(centers), axis=0)
        write_trajectory_html(args.viz, traj,
                              title="orb_tracking_live median-flow path")
        print(f"wrote {args.viz}")
    return {"tracked": counts, "flow": np.asarray(centers),
            "orb_frames": n_frames}


if __name__ == "__main__":
    main()
