"""Video read → per-frame processing on the card → video write loop (port
of examples/video_player.py; examples/video_player and video_write).
The container is the built-in MJPEG AVI writer and reader or cv2's, the
per-frame op a gray + Sobel edge overlay, and FpsCounter reports the
loop rate.

    python -m kornia_tpu_torch.examples.video_player [--video in.avi]
        [--out out.avi] [--frames 8] [--cpu]

With no --video, a synthetic moving-square clip is written first so the
demo always runs headless.
"""

from __future__ import annotations

import os
import tempfile

import numpy as np
import torch

from kornia_tpu_torch import to_device
from kornia_tpu_torch.examples._common import base_parser, configure_backend
from kornia_tpu_torch.io import FpsCounter, VideoReader, VideoWriter
from kornia_tpu_torch.ops.color import rgb_to_gray
from kornia_tpu_torch.ops.filters import sobel


def _synth_clip(path: str, n: int = 8, h: int = 240, w: int = 320) -> None:
    yy, xx = np.mgrid[0:h, 0:w]
    with VideoWriter(path, fps=20.0, size_hw=(h, w), codec="mjpg") as vw:
        for i in range(n):
            f = np.stack([xx * 255 // (w - 1), yy * 255 // (h - 1),
                          np.full((h, w), 30)], -1).astype(np.uint8)
            x0 = 20 + 30 * i
            f[80:160, x0:x0 + 60] = (240, 60, 60)
            vw.write(f)


def edge_overlay(rgb_u8, device) -> torch.Tensor:
    """(H, W, 3) u8 → the frame at half brightness with the normalised
    Sobel magnitude of its gray added to green, u8."""
    x = to_device(rgb_u8, device, torch.uint8)
    g = rgb_to_gray(x, device=device).squeeze(-1).to(torch.float32)
    gx = sobel(g, 1, 0)
    gy = sobel(g, 0, 1)
    mag = torch.sqrt(gx * gx + gy * gy)
    mag = torch.clamp(mag / (mag.max() + 1e-6) * 255.0, 0, 255)
    edge = mag.to(torch.uint8)
    out = x.to(torch.float32) * 0.5
    out[..., 1] += 0.5 * edge.to(torch.float32)
    return torch.clamp(out, 0, 255).to(torch.uint8)


def main(argv=None) -> dict:
    p = base_parser("video player: read, process on the card, write")
    p.add_argument("--video", default=None, help="input video path")
    p.add_argument("--out", default=None, help="output video path")
    p.add_argument("--frames", type=int, default=0,
                   help="stop after N frames (0 = all)")
    args = p.parse_args(argv)
    dev = configure_backend(args)

    video = args.video
    if video is None:
        video = os.path.join(tempfile.mkdtemp(prefix="kornia_vp_"),
                             "clip.avi")
        _synth_clip(video)
        print(f"synthesized clip: {video}")
    out_path = args.out or os.path.join(
        os.path.dirname(video), "processed.avi")

    fps = FpsCounter()
    n = 0
    with VideoReader(video) as vr:
        print(f"input: {vr.n_frames} frames @ {vr.fps:.1f} fps, "
              f"size {vr.size}")
        with VideoWriter(out_path, fps=vr.fps or 20.0, size_hw=vr.size,
                         codec="mjpg") as vw:
            for frame in vr:
                vw.write(edge_overlay(frame, dev).cpu().numpy())
                fps.tick()
                n += 1
                if args.frames and n >= args.frames:
                    break
    print(f"wrote {n} frames to {out_path} ({fps.fps():.1f} loop fps)")
    return {"frames": n, "out": out_path}


if __name__ == "__main__":
    raise SystemExit(0 if main()["frames"] > 0 else 1)
