"""Drawing (port of kornia_tpu/ops/draw.py): lines, circles and rectangles
as analytic inequalities over the pixel grid, and keypoints stamped as
filled circles; entry points with ``device=``. Images are (H, W, C).

``draw_keypoints`` tests only the pixels of each keypoint's disc
neighbourhood and scatters them into the mask: the reference's dense form
builds an (N, H, W) distance stack, 17 GB at 1080p for 2048 keypoints.
The per-pixel test is the reference's expression, so the mask is the same.
"""

from __future__ import annotations

import math

import torch

from kornia_tpu_torch import entry
from kornia_tpu_torch.ops.filters import const_on
from kornia_tpu_torch.ops.interpolation import meshgrid_pixel


def _blend(img: torch.Tensor, mask: torch.Tensor, color) -> torch.Tensor:
    c = torch.tensor(tuple(color)).to(img.dtype)    # the reference's cast
    return torch.where(mask[..., None],
                       const_on(tuple(c.tolist()), img.device, img.dtype),
                       img)


def _f32(v, device) -> torch.Tensor:
    """A coordinate as a 0-dim float32 tensor on ``device`` (a fill, not an
    upload), so every operation on it rounds as the reference's."""
    if isinstance(v, torch.Tensor):
        return v.to(device=device, dtype=torch.float32).reshape(())
    return torch.full((), float(v), dtype=torch.float32, device=device)


def _grid(img: torch.Tensor):
    return meshgrid_pixel(img.shape[0], img.shape[1], device=img.device)


@entry
def draw_line(img: torch.Tensor, p0, p1, color, thickness: float = 1.0
              ) -> torch.Tensor:
    """The segment p0 → p1 ((x, y) pixels) with round caps."""
    gx, gy = _grid(img)
    dev = img.device
    x0, y0 = (_f32(v, dev) for v in p0)
    x1, y1 = (_f32(v, dev) for v in p1)
    dx, dy = x1 - x0, y1 - y0
    len2 = torch.clamp(dx * dx + dy * dy, min=1e-12)
    t = torch.clamp(((gx - x0) * dx + (gy - y0) * dy) / len2, 0.0, 1.0)
    px, py = x0 + t * dx, y0 + t * dy
    dist2 = (gx - px) ** 2 + (gy - py) ** 2
    r = _f32(max(thickness * 0.5, 0.5), dev)
    return _blend(img, dist2 <= r * r, color)


@entry
def draw_circle(img: torch.Tensor, center, radius: float, color,
                thickness: float = 1.0) -> torch.Tensor:
    """A ring of the given thickness; thickness < 0 fills."""
    gx, gy = _grid(img)
    cx, cy = (_f32(v, img.device) for v in center)
    d = torch.hypot(gx - cx, gy - cy)
    if thickness < 0:
        mask = d <= radius
    else:
        mask = torch.abs(d - radius) <= max(thickness * 0.5, 0.5)
    return _blend(img, mask, color)


@entry
def draw_rect(img: torch.Tensor, top_left, bottom_right, color,
              thickness: float = 1.0) -> torch.Tensor:
    gx, gy = _grid(img)
    x0, y0 = (_f32(v, img.device) for v in top_left)
    x1, y1 = (_f32(v, img.device) for v in bottom_right)
    inside = (gx >= x0) & (gx <= x1) & (gy >= y0) & (gy <= y1)
    if thickness < 0:
        return _blend(img, inside, color)
    t = max(thickness, 1.0)
    inner = ((gx >= x0 + t) & (gx <= x1 - t) & (gy >= y0 + t)
             & (gy <= y1 - t))
    return _blend(img, inside & ~inner, color)


@entry
def draw_keypoints(img: torch.Tensor, xy: torch.Tensor, color=(0, 255, 0),
                   radius: float = 2.0) -> torch.Tensor:
    """Filled circles of ``radius`` at (N, 2) keypoints (x, y): a pixel is
    set where (gx − x)² + (gy − y)² ≤ radius² for some keypoint."""
    h, w = img.shape[0], img.shape[1]
    dev = img.device
    xy = xy.to(torch.float32)
    reach = math.ceil(radius)
    # pixels within `radius` of x lie in [floor(x) − reach, floor(x) +
    # reach + 1]
    off = torch.arange(2 * reach + 2, device=dev)
    px = torch.floor(xy[:, 0]).to(torch.int64)[:, None] - reach + off
    py = torch.floor(xy[:, 1]).to(torch.int64)[:, None] - reach + off
    ddx = (px.to(torch.float32) - xy[:, 0, None]) ** 2
    ddy = (py.to(torch.float32) - xy[:, 1, None]) ** 2
    hit = ((ddx[:, None, :] + ddy[:, :, None] <= radius * radius)
           & ((px >= 0) & (px < w))[:, None, :]
           & ((py >= 0) & (py < h))[:, :, None])
    flat = torch.where(hit, py[:, :, None] * w + px[:, None, :], h * w)
    mask = torch.zeros(h * w + 1, dtype=torch.bool, device=dev)
    mask = mask.scatter_(0, flat.reshape(-1), True)[: h * w].reshape(h, w)
    return _blend(img, mask, color)
