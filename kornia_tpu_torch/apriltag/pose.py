"""6-DOF tag pose from a detection: homography, then orthogonal
iteration (port of kornia_tpu/apriltag/pose.py).

Host float64 on four points, as in the reference: the homography gives
K⁻¹H and a scaled [r1 r2 t] start, Lu-Hager-Mjolsness orthogonal
iteration refines it on the object-space error, and the second planar
solution reflects the plane normal about the line of sight before it is
refined too.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np


@dataclass
class TagPose:
    """One candidate pose: tag frame → camera frame."""

    rotation: np.ndarray      # (3, 3)
    translation: np.ndarray   # (3,)
    error: float              # mean object-space error


@dataclass
class TagPosePair:
    """Both planar-ambiguity candidates, best first
    (reference: pose.rs TagPosePair:24)."""

    best: TagPose
    alternate: TagPose

    @property
    def ambiguity(self) -> float:
        """error ratio best/alternate (≈1 ⇒ ambiguous)."""
        if self.alternate.error == 0:
            return 1.0
        return self.best.error / self.alternate.error


def _orthogonal_iteration(obj: np.ndarray, rays: np.ndarray,
                          r0: np.ndarray, iters: int = 30
                          ) -> Tuple[np.ndarray, np.ndarray, float]:
    """LHM orthogonal iteration: minimize Σ|(I − Vᵢ)(R pᵢ + t)|²."""
    n = len(obj)
    v = np.stack([np.outer(r, r) / (r @ r) for r in rays])  # (n, 3, 3)
    v_mean = v.mean(axis=0)
    t_factor = np.linalg.inv(np.eye(3) - v_mean) / n

    r = r0
    obj_c = obj - obj.mean(axis=0)
    for _ in range(iters):
        rp = obj @ r.T                             # (n, 3)
        t = t_factor @ np.einsum("nij,nj->i", v - np.eye(3), rp)
        q = np.einsum("nij,nj->ni", v, rp + t)
        qc = q - q.mean(axis=0)
        u, _, vt = np.linalg.svd(qc.T @ obj_c)
        d = np.sign(np.linalg.det(u @ vt))
        r = u @ np.diag([1.0, 1.0, d]) @ vt
    rp = obj @ r.T
    t = t_factor @ np.einsum("nij,nj->i", v - np.eye(3), rp)
    err = np.mean(np.linalg.norm(
        (rp + t) - np.einsum("nij,nj->ni", v, rp + t), axis=1))
    return r, t, float(err)


def _pose_from_homography(h: np.ndarray, k: np.ndarray) -> np.ndarray:
    """Initial rotation from H ≈ K [r1 r2 t] (tag z = 0 plane)."""
    a = np.linalg.inv(k) @ h
    s = 2.0 / (np.linalg.norm(a[:, 0]) + np.linalg.norm(a[:, 1]))
    if a[2, 2] < 0:  # tag must be in front of the camera
        s = -s
    r1 = s * a[:, 0]
    r2 = s * a[:, 1]
    r3 = np.cross(r1, r2)
    r = np.stack([r1, r2, r3], axis=1)
    u, _, vt = np.linalg.svd(r)
    return u @ np.diag([1.0, 1.0, np.sign(np.linalg.det(u @ vt))]) @ vt


def estimate_tag_pose(detection, k: np.ndarray,
                      tag_size: float) -> TagPosePair:
    """Estimate the tag→camera pose pair for a Detection.

    Args:
        detection: apriltag Detection (corners CCW from tag (-1,-1)).
        k: (3, 3) camera intrinsics.
        tag_size: black-border edge length in meters.
    """
    k = np.asarray(k, np.float64)
    half = tag_size / 2.0
    obj = np.array([[-half, -half, 0.0], [half, -half, 0.0],
                    [half, half, 0.0], [-half, half, 0.0]])
    px = np.asarray(detection.corners, np.float64)
    rays = np.concatenate(
        [(px - k[:2, 2]) / np.array([k[0, 0], k[1, 1]]),
         np.ones((4, 1))], axis=1)

    r0 = _pose_from_homography(np.asarray(detection.homography), k)
    r1, t1, e1 = _orthogonal_iteration(obj, rays, r0)

    # second planar solution: reflect the plane normal about the view ray
    view = t1 / np.linalg.norm(t1)
    normal = r1[:, 2]
    n_alt = 2.0 * (normal @ view) * view - normal
    axis = np.cross(normal, n_alt)
    s = np.linalg.norm(axis)
    c = float(np.clip(normal @ n_alt, -1, 1))
    if s < 1e-9:
        r_alt0 = r1
    else:
        axis = axis / s
        kx = np.array([[0, -axis[2], axis[1]],
                       [axis[2], 0, -axis[0]],
                       [-axis[1], axis[0], 0]])
        rot = np.eye(3) + np.sin(np.arctan2(s, c)) * kx \
            + (1 - c) * kx @ kx
        r_alt0 = rot @ r1
    r2_, t2, e2 = _orthogonal_iteration(obj, rays, r_alt0)

    p1 = TagPose(r1, t1, e1)
    p2 = TagPose(r2_, t2, e2)
    return TagPosePair(p1, p2) if e1 <= e2 else TagPosePair(p2, p1)
