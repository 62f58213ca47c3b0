"""Geometric warps (port of kornia_tpu/ops/warp.py).

warp_affine / warp_perspective with cv2 semantics: the matrix maps source
→ destination, and each destination pixel samples the source at the
inverse map. ``method="auto"`` runs the exact K7 sampler
(:mod:`kornia_tpu_torch.ops.warp_exact`): the CUDA kernel on the card, its
plain version on the CPU. ``method="shear"`` runs the approximate
shear-decomposition route (:mod:`kornia_tpu_torch.ops.warp_shear`, K9).
Bicubic sampling takes the gather route (``grid_sample``) on either
method, as in the JAX package.
"""

from __future__ import annotations

from typing import Tuple

import torch

from kornia_tpu_torch import resolve_device, to_device
from kornia_tpu_torch.ops.interpolation import grid_sample, meshgrid_pixel
from kornia_tpu_torch.ops.warp_exact import (_finalize, warp_affine_exact,
                                             warp_perspective_exact)
from kornia_tpu_torch.ops.warp_shear import warp_affine_shear

_JAX_ROUTES = ("pallas", "gather")


def invert_affine(m, device="cuda") -> torch.Tensor:
    """Invert a (2, 3) affine matrix (reference warp/affine.rs invert)."""
    dev = resolve_device(device)
    m = to_device(m, dev, torch.float32)
    ainv = torch.linalg.inv(m[:, :2])
    tinv = -ainv @ m[:, 2]
    return torch.cat([ainv, tinv[:, None]], dim=1)


def get_rotation_matrix2d(center: Tuple[float, float], angle_deg, scale,
                          device="cuda") -> torch.Tensor:
    """cv2.getRotationMatrix2D equivalent; returns (2, 3) f32."""
    dev = resolve_device(device)
    angle = torch.deg2rad(torch.as_tensor(angle_deg, dtype=torch.float32,
                                          device=dev))
    alpha = torch.cos(angle) * scale
    beta = torch.sin(angle) * scale
    cx, cy = center
    return torch.stack([
        torch.stack([alpha, beta, (1.0 - alpha) * cx - beta * cy]),
        torch.stack([-beta, alpha, beta * cx + (1.0 - alpha) * cy]),
    ]).to(torch.float32)


def _check_method(method: str) -> None:
    if method in _JAX_ROUTES:
        raise ValueError(
            f"method={method!r} names a route of the JAX package; the port "
            f"has method='auto' (the exact K7 sampler: the CUDA kernel on "
            f"the card, its plain version on the CPU) and method='shear'")
    if method not in ("auto", "shear"):
        raise ValueError(f"unknown warp method {method!r}; pass 'auto' or "
                         f"'shear'")


def _gather_warp(img, dev, dsize, mode, padding_mode, fill_value, coords):
    """The gather route: ``coords(gx, gy) -> (sx, sy)`` over the
    destination grid, then grid_sample."""
    img = to_device(img, dev)
    new_h, new_w = dsize
    squeeze = img.ndim == 2
    x = img[..., None] if squeeze else img
    gx, gy = meshgrid_pixel(new_h, new_w, device=dev)
    sx, sy = coords(gx, gy)
    out = grid_sample(x, sx, sy, mode=mode, padding_mode=padding_mode,
                      fill_value=fill_value, device=dev)
    out = _finalize(out, img.dtype)
    return out[..., 0] if squeeze else out


def warp_affine(img, m, dsize: Tuple[int, int], mode: str = "bilinear",
                padding_mode: str = "zeros", fill_value: float = 0.0,
                method: str = "auto", device="cuda") -> torch.Tensor:
    """Warp (H, W, C) or (H, W) by the 2×3 source → destination matrix
    ``m`` into ``dsize`` = (new_h, new_w).

    method "auto": the exact single-pass sampler (K7) for bilinear and
    nearest. method "shear": the shear decomposition (K9 passes and band
    matmuls), bilinear with zero padding only, ≈3% off; kept for A/B
    comparison. Other modes take the gather route."""
    _check_method(method)
    dev = resolve_device(device)
    if method == "auto" and mode in ("bilinear", "nearest"):
        return warp_affine_exact(img, m, dsize, mode=mode,
                                 padding_mode=padding_mode,
                                 fill_value=fill_value, device=dev)
    if method == "shear" and mode == "bilinear" and padding_mode == "zeros":
        return warp_affine_shear(img, m, dsize, device=dev)
    minv = invert_affine(m, device=dev)

    def coords(gx, gy):
        return (minv[0, 0] * gx + minv[0, 1] * gy + minv[0, 2],
                minv[1, 0] * gx + minv[1, 1] * gy + minv[1, 2])

    return _gather_warp(img, dev, dsize, mode, padding_mode, fill_value,
                        coords)


def warp_perspective(img, m, dsize: Tuple[int, int], mode: str = "bilinear",
                     padding_mode: str = "zeros", fill_value: float = 0.0,
                     method: str = "auto", device="cuda") -> torch.Tensor:
    """Warp by a 3×3 homography (cv2.warpPerspective semantics).

    method "auto": the exact sampler (K7) for bilinear and nearest; other
    modes take the gather route. There is no shear route for
    homographies."""
    _check_method(method)
    if method == "shear":
        raise ValueError("warp_perspective has no shear route; pass "
                         "method='auto'")
    dev = resolve_device(device)
    if mode in ("bilinear", "nearest"):
        return warp_perspective_exact(img, m, dsize, mode=mode,
                                      padding_mode=padding_mode,
                                      fill_value=fill_value, device=dev)
    minv = torch.linalg.inv(to_device(m, dev, torch.float32))
    eps = torch.tensor(1e-8, dtype=torch.float32, device=dev)

    def coords(gx, gy):
        den = minv[2, 0] * gx + minv[2, 1] * gy + minv[2, 2]
        den = torch.where(den.abs() < eps, eps, den)
        return ((minv[0, 0] * gx + minv[0, 1] * gy + minv[0, 2]) / den,
                (minv[1, 0] * gx + minv[1, 1] * gy + minv[1, 2]) / den)

    return _gather_warp(img, dev, dsize, mode, padding_mode, fill_value,
                        coords)
