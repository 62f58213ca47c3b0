"""Trajectory evaluation: Umeyama alignment, ATE, RPE (port of
kornia_tpu/slam/evaluate.py).

The TUM RGB-D benchmark's conventions: ATE = RMSE of translation after
(optionally scaled) rigid alignment; RPE = per-delta relative-pose error
statistics. numpy in float64, as in the reference; :func:`poses7_to_t44`
converts poses through the port's Lie group in float32 on a device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from kornia_tpu_torch import resolve_device, to_device
from kornia_tpu_torch.geometry import liegroup as lg


def umeyama_alignment(
    src: np.ndarray, dst: np.ndarray, with_scale: bool = True
) -> Tuple[float, np.ndarray, np.ndarray]:
    """Least-squares similarity s·R·src + t ≈ dst over (N, 3) points."""
    src = np.asarray(src, np.float64)
    dst = np.asarray(dst, np.float64)
    mu_s = src.mean(0)
    mu_d = dst.mean(0)
    xs = src - mu_s
    xd = dst - mu_d
    cov = xd.T @ xs / len(src)
    u, d, vt = np.linalg.svd(cov)
    s_fix = np.eye(3)
    if np.linalg.det(u) * np.linalg.det(vt) < 0:
        s_fix[2, 2] = -1
    r = u @ s_fix @ vt
    if with_scale:
        var_s = (xs ** 2).sum() / len(src)
        scale = float(np.trace(np.diag(d) @ s_fix) / var_s)
    else:
        scale = 1.0
    t = mu_d - scale * r @ mu_s
    return scale, r, t


@dataclass
class AteResult:
    rmse: float
    mean: float
    median: float
    max: float
    scale: float
    errors: np.ndarray


def absolute_trajectory_error(
    est_xyz: np.ndarray, gt_xyz: np.ndarray,
    align: bool = True, with_scale: bool = True,
) -> AteResult:
    """ATE over matched (N, 3) translation sequences."""
    est_xyz = np.asarray(est_xyz, np.float64)
    gt_xyz = np.asarray(gt_xyz, np.float64)
    if est_xyz.shape != gt_xyz.shape:
        raise ValueError(f"shape mismatch {est_xyz.shape} vs {gt_xyz.shape}")
    scale = 1.0
    aligned = est_xyz
    if align:
        scale, r, t = umeyama_alignment(est_xyz, gt_xyz, with_scale)
        aligned = (scale * (r @ est_xyz.T)).T + t
    err = np.linalg.norm(aligned - gt_xyz, axis=1)
    return AteResult(
        rmse=float(np.sqrt(np.mean(err ** 2))),
        mean=float(err.mean()),
        median=float(np.median(err)),
        max=float(err.max()),
        scale=scale,
        errors=err,
    )


@dataclass
class RpeResult:
    trans_rmse: float
    trans_mean: float
    rot_rmse_deg: float
    rot_mean_deg: float


def _rot_angle_deg(r: np.ndarray) -> float:
    return float(np.rad2deg(np.arccos(
        np.clip((np.trace(r) - 1.0) / 2.0, -1.0, 1.0))))


def relative_pose_error(
    est_t44: np.ndarray, gt_t44: np.ndarray, delta: int = 1
) -> RpeResult:
    """RPE over (N, 4, 4) camera-to-world pose sequences."""
    est_t44 = np.asarray(est_t44, np.float64)
    gt_t44 = np.asarray(gt_t44, np.float64)
    n = len(est_t44)
    te, re = [], []
    for i in range(n - delta):
        de = np.linalg.inv(est_t44[i]) @ est_t44[i + delta]
        dg = np.linalg.inv(gt_t44[i]) @ gt_t44[i + delta]
        e = np.linalg.inv(dg) @ de
        te.append(np.linalg.norm(e[:3, 3]))
        re.append(_rot_angle_deg(e[:3, :3]))
    te = np.asarray(te)
    re = np.asarray(re)
    return RpeResult(
        trans_rmse=float(np.sqrt(np.mean(te ** 2))),
        trans_mean=float(te.mean()),
        rot_rmse_deg=float(np.sqrt(np.mean(re ** 2))),
        rot_mean_deg=float(re.mean()),
    )


def poses7_to_t44(poses7, invert: bool = False,
                  device="cuda") -> np.ndarray:
    """(N, 7) [qw qx qy qz t] → (N, 4, 4) float64 matrices, computed in
    float32 on ``device`` (optionally inverted: world→camera states
    become camera→world trajectories)."""
    p = to_device(np.asarray(poses7), resolve_device(device), torch.float32)
    if invert:
        p = lg.se3_inverse(p)
    return lg.se3_to_matrix(p).cpu().numpy().astype(np.float64)
