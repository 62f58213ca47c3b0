"""Stereo rectification (Bouguet) and the rectification remap (port of
kornia_tpu/geometry/stereo.py).

``stereo_rectify`` and the Rodrigues helpers are numpy float64, copied as
they are: calibration is host state. ``init_undistort_rectify_map`` builds
the f32 maps on a device and ``StereoRectifier.rectify_left/right`` remap
through them (the K7 kernel on the card, one launch per image).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from kornia_tpu_torch import resolve_device, to_device
from kornia_tpu_torch.geometry.camera import _distort
from kornia_tpu_torch.ops.interpolation import remap

_F32 = torch.float32


def _rodrigues_matrix(rvec: np.ndarray) -> np.ndarray:
    theta = np.linalg.norm(rvec)
    if theta < 1e-12:
        return np.eye(3)
    k = rvec / theta
    kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(theta) * kx + (1 - np.cos(theta)) * kx @ kx


def _rodrigues_vector(r: np.ndarray) -> np.ndarray:
    cos_t = np.clip((np.trace(r) - 1) / 2, -1, 1)
    theta = np.arccos(cos_t)
    if theta < 1e-12:
        return np.zeros(3)
    axis = np.array([r[2, 1] - r[1, 2], r[0, 2] - r[2, 0],
                     r[1, 0] - r[0, 1]]) / (2 * np.sin(theta))
    return axis * theta


def stereo_rectify(
    k1: np.ndarray, d1: Optional[np.ndarray],
    k2: np.ndarray, d2: Optional[np.ndarray],
    image_size: Tuple[int, int],  # (h, w)
    r: np.ndarray, t: np.ndarray,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Bouguet stereo rectification (cv2.stereoRectify's contract, with the
    alpha = -1 scaling approximated by the mean focal length).

    k1/k2: 3×3 intrinsics; d1/d2: (k1 k2 p1 p2 k3) or None; image_size:
    (h, w); r, t: cam1 → cam2 rotation and translation. Returns (R1, R2,
    P1, P2, Q), float64."""
    k1 = np.asarray(k1, np.float64)
    k2 = np.asarray(k2, np.float64)
    r = np.asarray(r, np.float64)
    t = np.asarray(t, np.float64).reshape(3)

    # split the rotation: each camera turns halfway toward the other
    om = _rodrigues_vector(r)
    r_half = _rodrigues_matrix(-0.5 * om)
    t_rect = r_half @ t

    # new x-axis along the baseline; positive toward camera order
    idx = 0 if abs(t_rect[0]) >= abs(t_rect[1]) else 1
    uu = np.zeros(3)
    uu[idx] = 1.0 if t_rect[idx] >= 0 else -1.0
    e1 = t_rect / np.linalg.norm(t_rect)
    ww = np.cross(e1, uu)
    nw = np.linalg.norm(ww)
    if nw > 1e-12:
        ww = ww / nw * np.arccos(np.clip(
            abs(t_rect[idx]) / np.linalg.norm(t_rect), -1, 1))
    r_align = _rodrigues_matrix(ww)

    r1 = r_align @ r_half.T
    r2 = r_align @ r_half
    t_new = r2 @ t

    f = (k1[0, 0] + k1[1, 1] + k2[0, 0] + k2[1, 1]) / 4.0
    cx = (k1[0, 2] + k2[0, 2]) / 2.0
    cy = (k1[1, 2] + k2[1, 2]) / 2.0

    p1 = np.array([[f, 0, cx, 0], [0, f, cy, 0], [0, 0, 1, 0]])
    p2 = np.array([[f, 0, cx, f * t_new[idx]],
                   [0, f, cy, 0], [0, 0, 1, 0]])
    if idx == 1:  # vertical stereo: disparity offset on y
        p2 = np.array([[f, 0, cx, 0],
                       [0, f, cy, f * t_new[1]], [0, 0, 1, 0]])

    baseline = -t_new[idx]
    q = np.array([
        [1, 0, 0, -cx],
        [0, 1, 0, -cy],
        [0, 0, 0, f],
        [0, 0, -1.0 / baseline if baseline != 0 else 0, 0],
    ])
    return r1, r2, p1, p2, q


def init_undistort_rectify_map(
    k: np.ndarray, dist: Optional[np.ndarray], r_rect: np.ndarray,
    p_new: np.ndarray, image_size: Tuple[int, int], device="cuda",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(map_x, map_y), each (h, w) f32: rectified pixel → source pixel
    (cv2.initUndistortRectifyMap's contract). The inverse rotation is
    applied as three explicit f32 dot products per pixel."""
    dev = resolve_device(device)
    h, w = image_size
    k = to_device(np.asarray(k, np.float32), dev)
    rr = to_device(np.linalg.inv(np.asarray(r_rect)).astype(np.float32),
                   dev)
    p = to_device(np.asarray(p_new, np.float32), dev)
    ys, xs = torch.meshgrid(torch.arange(h, dtype=_F32, device=dev),
                            torch.arange(w, dtype=_F32, device=dev),
                            indexing="ij")
    xn = (xs - p[0, 2]) / p[0, 0]
    yn = (ys - p[1, 2]) / p[1, 1]
    dirs = [xn * rr[i, 0] + yn * rr[i, 1] + rr[i, 2] for i in range(3)]
    xn2 = dirs[0] / dirs[2]
    yn2 = dirs[1] / dirs[2]
    if dist is not None:
        xy = _distort(torch.stack([xn2, yn2], dim=-1),
                      to_device(np.asarray(dist, np.float32), dev))
        xn2, yn2 = xy[..., 0], xy[..., 1]
    return xn2 * k[0, 0] + k[0, 2], yn2 * k[1, 1] + k[1, 2]


@dataclass
class StereoRectifier:
    """Precomputed rectification for a calibrated stereo pair (reference
    StereoRectifier::from_calib, rectify_left/right, baseline/bf). The
    fields are numpy float64 host state; ``rectify_*`` build the maps on
    the image's device and remap through them."""

    k1: np.ndarray
    d1: Optional[np.ndarray]
    k2: np.ndarray
    d2: Optional[np.ndarray]
    image_size: Tuple[int, int]
    r1: np.ndarray
    r2: np.ndarray
    p1: np.ndarray
    p2: np.ndarray
    q: np.ndarray

    @classmethod
    def from_calib(cls, k1, d1, k2, d2, image_size: Tuple[int, int], r, t
                   ) -> "StereoRectifier":
        r1, r2, p1, p2, q = stereo_rectify(k1, d1, k2, d2, image_size, r, t)
        return cls(k1=np.asarray(k1, np.float64), d1=d1,
                   k2=np.asarray(k2, np.float64), d2=d2,
                   image_size=tuple(image_size),
                   r1=r1, r2=r2, p1=p1, p2=p2, q=q)

    def map_left(self, device="cuda") -> Tuple[torch.Tensor, torch.Tensor]:
        return init_undistort_rectify_map(self.k1, self.d1, self.r1, self.p1,
                                          self.image_size, device=device)

    def map_right(self, device="cuda") -> Tuple[torch.Tensor, torch.Tensor]:
        return init_undistort_rectify_map(self.k2, self.d2, self.r2, self.p2,
                                          self.image_size, device=device)

    @property
    def baseline(self) -> float:
        """Metric baseline |B| of the rectified pair."""
        f = self.p2[0, 0]
        off = self.p2[0, 3] if abs(self.p2[0, 3]) > 0 else self.p2[1, 3]
        return float(abs(off) / f)

    @property
    def bf(self) -> float:
        """focal × baseline (the stereo-depth constant)."""
        return float(self.p2[0, 0] * self.baseline)

    def rectify_left(self, img, mode: str = "bilinear",
                     device="cuda") -> torch.Tensor:
        mx, my = self.map_left(device)
        return remap(img, mx, my, mode, device=device)

    def rectify_right(self, img, mode: str = "bilinear",
                      device="cuda") -> torch.Tensor:
        mx, my = self.map_right(device)
        return remap(img, mx, my, mode, device=device)
