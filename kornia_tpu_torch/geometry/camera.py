"""Camera models: pinhole, Brown-Conrady distortion, Kannala-Brandt fisheye
(port of kornia_tpu/geometry/camera.py).

All functions are batched over points; intrinsics are (3, 3) K matrices or
the explicit (fx, fy, cx, cy) plus distortion coefficient vectors. The
public functions take numpy arrays or tensors and ``device=``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from kornia_tpu_torch import resolve_device, to_device
from kornia_tpu_torch.ops.interpolation import meshgrid_pixel, remap

_F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class PinholeCamera:
    """Static camera description; tensors are built on demand."""

    fx: float
    fy: float
    cx: float
    cy: float
    width: int = 0
    height: int = 0

    def k_matrix(self, device="cuda") -> torch.Tensor:
        return torch.tensor([[self.fx, 0.0, self.cx], [0.0, self.fy, self.cy],
                             [0.0, 0.0, 1.0]], dtype=_F32,
                            device=resolve_device(device))

    @classmethod
    def from_matrix(cls, k, width: int = 0, height: int = 0
                    ) -> "PinholeCamera":
        k = np.asarray(k.cpu() if isinstance(k, torch.Tensor) else k)
        return cls(float(k[0, 0]), float(k[1, 1]), float(k[0, 2]),
                   float(k[1, 2]), width, height)


def _intrinsics(k: torch.Tensor):
    return k[..., 0, 0], k[..., 1, 1], k[..., 0, 2], k[..., 1, 2]


def normalize_points(px: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Pixels → normalized image coordinates (K⁻¹ applied)."""
    fx, fy, cx, cy = _intrinsics(k)
    return torch.stack([(px[..., 0] - cx) / fx, (px[..., 1] - cy) / fy],
                       dim=-1)


def _to_pixels(xy: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    fx, fy, cx, cy = _intrinsics(k)
    return torch.stack([xy[..., 0] * fx + cx, xy[..., 1] * fy + cy], dim=-1)


def _project(pts_cam: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """(..., 3) camera-frame points → (..., 2) pixels, |z| < 1e-9 taken
    as 1e-9: the tensor-level projection for hot paths (no copy, no new
    tensor from the host)."""
    z = pts_cam[..., 2:3]
    z = torch.where(z.abs() < 1e-9, torch.full_like(z, 1e-9), z)
    return _to_pixels(pts_cam[..., :2] / z, k)


def project_points(pts_cam, k, device="cuda") -> torch.Tensor:
    """(..., 3) camera-frame points → (..., 2) pixels (z > 0 assumed)."""
    dev = resolve_device(device)
    return _project(to_device(pts_cam, dev, _F32), to_device(k, dev, _F32))


def unproject_points(px, depth, k, device="cuda") -> torch.Tensor:
    """(..., 2) pixels + (...,) depth → (..., 3) camera-frame points."""
    dev = resolve_device(device)
    px = to_device(px, dev, _F32)
    depth = to_device(depth, dev, _F32)
    fx, fy, cx, cy = _intrinsics(to_device(k, dev, _F32))
    x = (px[..., 0] - cx) / fx * depth
    y = (px[..., 1] - cy) / fy * depth
    return torch.stack([x, y, depth], dim=-1)


# --------------------------------------------------------------------------
# Brown-Conrady polynomial distortion (k1 k2 p1 p2 k3 [k4 k5 k6])
# --------------------------------------------------------------------------


def _distort(xy: torch.Tensor, dist: torch.Tensor) -> torch.Tensor:
    d = torch.zeros(8, dtype=xy.dtype, device=xy.device)
    d[: dist.shape[0]] = dist.to(xy.dtype)
    k1, k2, p1, p2, k3, k4, k5, k6 = (d[i] for i in range(8))
    x, y = xy[..., 0], xy[..., 1]
    r2 = x * x + y * y
    r4 = r2 * r2
    r6 = r4 * r2
    radial = ((1.0 + k1 * r2 + k2 * r4 + k3 * r6)
              / (1.0 + k4 * r2 + k5 * r4 + k6 * r6))
    xd = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    yd = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    return torch.stack([xd, yd], dim=-1)


def distort_points_polynomial(xy_norm, dist, device="cuda") -> torch.Tensor:
    """Apply Brown-Conrady distortion to (..., 2) normalized coordinates;
    ``dist`` has 5 or 8 coefficients (cv2 order)."""
    dev = resolve_device(device)
    xy = to_device(xy_norm, dev, _F32)
    return _distort(xy, to_device(dist, dev, _F32))


def _undistort_iterative(xy_dist: torch.Tensor, dist: torch.Tensor,
                         iters: int) -> torch.Tensor:
    xy = xy_dist
    for _ in range(iters):
        xy = xy_dist - (_distort(xy, dist) - xy)
    return xy


def undistort_points_iterative(xy_dist_norm, dist, iters: int = 8,
                               device="cuda") -> torch.Tensor:
    """Invert the distortion by fixed-point iteration (a fixed count, as
    the reference's undistort_normalized_point_iter)."""
    dev = resolve_device(device)
    return _undistort_iterative(to_device(xy_dist_norm, dev, _F32),
                                to_device(dist, dev, _F32), iters)


def undistort_points(px, k, dist, iters: int = 8,
                     device="cuda") -> torch.Tensor:
    """Pixels → undistorted pixels (cv2.undistortPoints with P = K)."""
    dev = resolve_device(device)
    k = to_device(k, dev, _F32)
    xy = normalize_points(to_device(px, dev, _F32), k)
    xyu = _undistort_iterative(xy, to_device(dist, dev, _F32), iters)
    return _to_pixels(xyu, k)


def generate_correction_map_polynomial(
        k, dist, size_hw: Tuple[int, int], new_k=None, device="cuda"
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(map_x, map_y), each (h, w) f32, for remap-based undistortion
    (cv2.initUndistortRectifyMap with R = I)."""
    dev = resolve_device(device)
    h, w = size_hw
    k = to_device(k, dev, _F32)
    new_k = k if new_k is None else to_device(new_k, dev, _F32)
    gx, gy = meshgrid_pixel(h, w, device=dev)
    xy = normalize_points(torch.stack([gx, gy], dim=-1), new_k)
    xyd = _distort(xy, to_device(dist, dev, _F32))
    fx, fy, cx, cy = _intrinsics(k)
    return xyd[..., 0] * fx + cx, xyd[..., 1] * fy + cy


def undistort_image(img, k, dist, new_k=None, mode: str = "bilinear",
                    device="cuda") -> torch.Tensor:
    """Undistort an (H, W) or (H, W, C) image (cv2.undistort): the
    correction map, then :func:`~kornia_tpu_torch.ops.interpolation.remap`
    (the K7 kernel for bilinear and nearest). The JAX package passes
    ``nsel=4`` to size its TPU kernel; the port's remap ignores ``nsel``."""
    dev = resolve_device(device)
    img = to_device(img, dev)
    h, w = img.shape[:2]
    map_x, map_y = generate_correction_map_polynomial(k, dist, (h, w),
                                                      new_k, device=dev)
    return remap(img, map_x, map_y, mode, nsel=4, device=dev)


# --------------------------------------------------------------------------
# Kannala-Brandt fisheye
# --------------------------------------------------------------------------


def fisheye_project(pts_cam, k, kb, device="cuda") -> torch.Tensor:
    """Kannala-Brandt model, θ_d = θ(1 + k1θ² + k2θ⁴ + k3θ⁶ + k4θ⁸)
    (cv2.fisheye convention)."""
    dev = resolve_device(device)
    pts = to_device(pts_cam, dev, _F32)
    kb = to_device(kb, dev, _F32)
    x, y, z = pts[..., 0], pts[..., 1], pts[..., 2]
    r = torch.sqrt(torch.clamp(x * x + y * y, min=1e-18))
    theta = torch.atan2(r, z)
    t2 = theta * theta
    theta_d = theta * (1.0 + kb[0] * t2 + kb[1] * t2 ** 2 + kb[2] * t2 ** 3
                       + kb[3] * t2 ** 4)
    scale = theta_d / r
    return _to_pixels(torch.stack([x * scale, y * scale], dim=-1),
                      to_device(k, dev, _F32))


def fisheye_unproject(px, k, kb, iters: int = 10,
                      device="cuda") -> torch.Tensor:
    """Invert Kannala-Brandt: pixels → unit bearing vectors (..., 3)."""
    dev = resolve_device(device)
    kb = to_device(kb, dev, _F32)
    xy = normalize_points(to_device(px, dev, _F32), to_device(k, dev, _F32))
    theta_d = torch.sqrt(torch.clamp(torch.sum(xy * xy, dim=-1), min=1e-18))
    theta = theta_d
    for _ in range(iters):
        t2 = theta * theta
        f = theta * (1.0 + kb[0] * t2 + kb[1] * t2 ** 2 + kb[2] * t2 ** 3
                     + kb[3] * t2 ** 4) - theta_d
        fp = (1.0 + 3 * kb[0] * t2 + 5 * kb[1] * t2 ** 2
              + 7 * kb[2] * t2 ** 3 + 9 * kb[3] * t2 ** 4)
        theta = theta - f / torch.clamp(fp, min=1e-6)
    scale = torch.tan(theta) / torch.clamp(theta_d, min=1e-12)
    xn = xy * scale[..., None]
    bearing = torch.cat([xn, torch.ones_like(xn[..., :1])], dim=-1)
    return bearing / torch.linalg.norm(bearing, dim=-1, keepdim=True)
