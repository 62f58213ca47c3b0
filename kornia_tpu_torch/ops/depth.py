"""Depth-map operations (port of kornia_tpu/ops/depth.py): sampling a
depth map at keypoints, back-projection to camera-frame points, surface
normals, and the warp of a source image into a frame through its depth.

Entry points with ``device=`` (default "cuda"). :func:`warp_frame_depth`
samples through :func:`kornia_tpu_torch.ops.interpolation.remap`, so on
the card it is one launch of the K7 kernel (csrc/remap.cu).
"""

from __future__ import annotations

from typing import Tuple

import torch

from kornia_tpu_torch import entry
from kornia_tpu_torch.ops.interpolation import remap


def _nanmedian(vals: torch.Tensor, ok: torch.Tensor) -> torch.Tensor:
    """Per row, the median of the ``ok`` values as ``jnp.nanmedian`` takes
    it: the mean of the two middle values of an even count (torch's
    ``nanmedian`` takes the lower one). Rows without one give NaN."""
    s, _ = torch.sort(torch.where(ok, vals, torch.full_like(vals,
                                                            float("inf"))),
                      dim=1)
    k = ok.sum(dim=1)
    lo = torch.clamp((k - 1) // 2, min=0)
    hi = torch.clamp(k // 2, min=0)
    a = s.gather(1, lo[:, None])[:, 0]
    b = s.gather(1, hi[:, None])[:, 0]
    med = a + (b - a) * 0.5
    return torch.where(k > 0, med, torch.full_like(med, float("nan")))


@entry
def sample_depth(depth: torch.Tensor, xy: torch.Tensor, mode: str = "nearest",
                 min_depth: float = 1e-6, window: int = 0
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sample an (H, W) depth map at (N, 2) pixel locations: (values (N,)
    float32, valid (N,) bool). Invalid: out of bounds or depth <=
    ``min_depth``. ``mode`` "nearest" or "bilinear" (a hole at any of the
    four taps invalidates); ``window`` > 0 takes the median of the valid
    depths of a (2w+1)² patch (nearest only)."""
    h, w = depth.shape
    x = xy[:, 0]
    y = xy[:, 1]
    inb = (x >= 0) & (x <= w - 1) & (y >= 0) & (y <= h - 1)
    if mode == "nearest":
        xi = torch.clamp(torch.round(x).to(torch.int64), 0, w - 1)
        yi = torch.clamp(torch.round(y).to(torch.int64), 0, h - 1)
        if window > 0:
            r = torch.arange(-window, window + 1, device=depth.device)
            oy, ox = torch.meshgrid(r, r, indexing="ij")
            ys = torch.clamp(yi[:, None] + oy.reshape(-1)[None, :], 0, h - 1)
            xs = torch.clamp(xi[:, None] + ox.reshape(-1)[None, :], 0, w - 1)
            patch = depth[ys, xs]                        # (N, (2w+1)²)
            ok = patch > min_depth
            med = _nanmedian(patch, ok)
            val = torch.where(ok.any(dim=1), med, torch.zeros_like(med))
        else:
            val = depth[yi, xi]
        return val.to(torch.float32), inb & (val > min_depth)
    if mode == "bilinear":
        x0 = torch.clamp(torch.floor(x).to(torch.int64), 0, w - 2)
        y0 = torch.clamp(torch.floor(y).to(torch.int64), 0, h - 2)
        fx = torch.clamp(x - x0, 0.0, 1.0)
        fy = torch.clamp(y - y0, 0.0, 1.0)
        c00 = depth[y0, x0]
        c01 = depth[y0, x0 + 1]
        c10 = depth[y0 + 1, x0]
        c11 = depth[y0 + 1, x0 + 1]
        all_valid = ((c00 > min_depth) & (c01 > min_depth)
                     & (c10 > min_depth) & (c11 > min_depth))
        val = ((1 - fy) * ((1 - fx) * c00 + fx * c01)
               + fy * ((1 - fx) * c10 + fx * c11))
        return val.to(torch.float32), inb & all_valid
    raise ValueError(f"unknown mode {mode!r}")


def _points(depth: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    h, w = depth.shape
    k = k.to(torch.float32)
    fx, fy = k[0, 0], k[1, 1]
    cx, cy = k[0, 2], k[1, 2]
    dev = depth.device
    xs = torch.arange(w, dtype=torch.float32, device=dev)[None, :]
    ys = torch.arange(h, dtype=torch.float32, device=dev)[:, None]
    z = depth.to(torch.float32)
    x = (xs - cx) / fx * z
    y = (ys - cy) / fy * z
    return torch.stack(torch.broadcast_tensors(x, y, z), dim=-1)


@entry
def depth_to_3d(depth: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """(H, W) depth → (H, W, 3) camera-frame points (depth 0 → the
    origin)."""
    return _points(depth, k)


@entry
def depth_to_normals(depth: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Unit surface normals from central differences of the 3-D map (the
    image wraps around at its edges, as the reference's ``roll``), turned
    to face the camera (n_z < 0)."""
    pts = _points(depth, k)
    dzdx = (torch.roll(pts, -1, 1) - torch.roll(pts, 1, 1)) / 2.0
    dzdy = (torch.roll(pts, -1, 0) - torch.roll(pts, 1, 0)) / 2.0
    n = torch.linalg.cross(dzdx, dzdy, dim=-1)
    norm = torch.linalg.vector_norm(n, dim=-1, keepdim=True)
    n = n / torch.clamp(norm, min=1e-12)
    flip = torch.sign(n[..., 2:3])
    return -n * torch.where(flip == 0, torch.ones_like(flip), flip)


@entry
def warp_frame_depth(image_src: torch.Tensor, depth_dst: torch.Tensor,
                     src_trans_dst: torch.Tensor, k: torch.Tensor
                     ) -> torch.Tensor:
    """Warp the source image into the destination frame through the
    destination's depth: x_src = K·T·K⁻¹·[u·z, v·z, z], sampled bilinearly
    with zero padding (one K7 launch on the card)."""
    pts = _points(depth_dst, k)                          # dst camera frame
    t44 = src_trans_dst.to(torch.float32)
    k = k.to(torch.float32)
    src_pts = pts @ t44[:3, :3].T + t44[:3, 3]
    z = torch.clamp(src_pts[..., 2], min=1e-9)
    u = src_pts[..., 0] / z * k[0, 0] + k[0, 2]
    v = src_pts[..., 1] / z * k[1, 1] + k[1, 2]
    return remap(image_src, u, v, device=image_src.device)
