"""Canny edges (port of kornia_tpu/ops/canny.py): Gaussian blur → Sobel →
magnitude and four direction bins → non-maximum suppression → hysteresis,
an entry point with ``device=``.

The hysteresis is the reference's fixed number of dilate-and-gate sweeps
(a ``lax.scan`` of 16 steps, canny.py:56-67), a plain loop here, with no
convergence test, so nothing waits for the device.
"""

from __future__ import annotations

import math

import torch

from kornia_tpu_torch import entry
from kornia_tpu_torch.ops.filters import gaussian_blur, sobel


@entry
def canny(gray: torch.Tensor, low_threshold: float = 100.0,
          high_threshold: float = 200.0, ksize: int = 5, sigma: float = 1.4,
          hysteresis_iters: int = 16) -> torch.Tensor:
    """(H, W) grayscale → (H, W) u8 edge map of 0 / 255."""
    x = gray.to(torch.float32)
    if ksize > 1:
        x = gaussian_blur(x[..., None], (ksize, ksize), sigma)[..., 0]
    gx = sobel(x[..., None], 1, 0)[..., 0]
    gy = sobel(x[..., None], 0, 1)[..., 0]
    mag = torch.hypot(gx, gy)

    # direction in four bins: 0, 45, 90, 135 degrees
    ang = torch.atan2(gy, gx)
    ang = torch.where(ang < 0, ang + math.pi, ang)
    dirq = torch.remainder(torch.floor(
        (ang + math.pi / 8) / torch.full_like(ang, math.pi / 4)).to(
            torch.int32), 4)

    h, w = mag.shape
    p = torch.nn.functional.pad(mag, (1, 1, 1, 1))

    def shift(dy, dx):
        return p[1 + dy: 1 + dy + h, 1 + dx: 1 + dx + w]

    pairs = ((shift(0, 1), shift(0, -1)),       # horizontal gradient: E/W
             (shift(-1, 1), shift(1, -1)),      # 45°
             (shift(1, 0), shift(-1, 0)),       # vertical
             (shift(-1, -1), shift(1, 1)))      # 135°
    na, nb = pairs[3]
    for k in (2, 1, 0):
        na = torch.where(dirq == k, pairs[k][0], na)
        nb = torch.where(dirq == k, pairs[k][1], nb)
    nms = torch.where((mag >= na) & (mag >= nb), mag, torch.zeros_like(mag))

    strong = nms >= high_threshold
    weak = nms >= low_threshold
    edges = strong
    for _ in range(hysteresis_iters):
        sp = torch.nn.functional.pad(edges, (1, 1, 1, 1))
        grown = torch.zeros_like(edges)
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                grown = grown | sp[1 + dy: 1 + dy + h, 1 + dx: 1 + dx + w]
        edges = edges | (grown & weak)
    return torch.where(edges, 255, 0).to(torch.uint8)
