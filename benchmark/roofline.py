"""The yardstick of the kernels' rooflines: the chip's peaks and the work
ORB needs for a frame, counted from its shapes, whatever implements it.

Peaks (NVIDIA H100 SXM data sheet, at its 700 W limit): 3.35e12 bytes/s of
HBM, and the issue rates outside the tensor cores that PERF.md's kernel
table states: 64 int32 and 128 f32 thread-operations per SM per clock
(an FMA counts as one) × 132 SMs × 1980 MHz = 16.7e12 and 33.5e12 a
second. A card not in the table has no roofline.

ORB's work for one frame (operations per pixel from PERF.md's K1 row at
commit 7a07e2e: 99 int32 operations for the FAST-9 test with its 3×3
non-maximum suppression, 76 f32 for the central-gradient Harris score;
the rest counted here):
* per pyramid level ≥ 1, the bilinear resize: 2 taps × 2 passes = 4 f32
  operations an output pixel;
* per level, the 7×7 separable Gaussian blur: 14 f32 operations a pixel;
* per kept keypoint, the intensity-centroid orientation over the 31×31
  circle of radius 15 (709 pixels × 2 moments) and the rotated BRIEF-256:
  512 taps rotated (4 operations and 2 roundings each) and 256 compares;
* bytes: the u8 frame read once, and per kept keypoint its output written
  once: xy 8, angle 4, score 4, octave 4, a 32-byte descriptor, 1 mask.
"""

from __future__ import annotations

from typing import Optional

PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bytes_per_s": 3.35e12, "int32_per_s": 16.7e12,
                              "f32_per_s": 33.5e12},
}
FAST_INT32_PER_PIXEL = 99
HARRIS_F32_PER_PIXEL = 76
RESIZE_F32_PER_PIXEL = 4
BLUR_F32_PER_PIXEL = 14
CIRCLE_PIXELS = 709          # pixels with dx² + dy² ≤ 15²
ORIENT_F32_PER_KP = 2 * CIRCLE_PIXELS
BRIEF_F32_PER_KP = 512 * 6 + 256
OUT_BYTES_PER_KP = 8 + 4 + 4 + 4 + 32 + 1


def level_shapes(hw, n_levels: int, scale: float):
    h, w = hw
    return [(h, w)] + [(int(round(h / scale ** i)), int(round(w / scale ** i)))
                       for i in range(1, n_levels)]


def orb_work(hw, n_levels: int, scale: float, keypoints: int) -> dict:
    """int32 and f32 operations and bytes ORB needs for one (H, W) frame
    with ``keypoints`` kept."""
    shapes = level_shapes(hw, n_levels, scale)
    pixels = sum(h * w for h, w in shapes)
    resized = pixels - hw[0] * hw[1]
    return {
        "int32": FAST_INT32_PER_PIXEL * pixels,
        "f32": ((HARRIS_F32_PER_PIXEL + BLUR_F32_PER_PIXEL) * pixels
                + RESIZE_F32_PER_PIXEL * resized
                + (ORIENT_F32_PER_KP + BRIEF_F32_PER_KP) * keypoints),
        "bytes": hw[0] * hw[1] + OUT_BYTES_PER_KP * keypoints,
    }


def least_time(work: dict, card: str) -> Optional[tuple]:
    """(seconds, the bound that binds) for ``work`` on ``card``, or None
    for a card without peaks."""
    peak = PEAKS.get(card)
    if peak is None:
        return None
    times = {"int32": work["int32"] / peak["int32_per_s"],
             "f32": work["f32"] / peak["f32_per_s"],
             "bytes": work["bytes"] / peak["bytes_per_s"]}
    by = max(times, key=times.get)
    return times[by], by
