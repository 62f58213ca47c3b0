"""Sampson-cost pose refinement of the two-view bootstrap (port of
kornia_tpu/geometry/refine.py::refine_pose_sampson).

LM on the essential manifold (SO3 × S², 5 DOF) over the RANSAC inliers,
with the robust threshold annealed (2τ, then τ) across two LM phases and a
Huber clip that keeps the residual vector fixed-shape.
"""

from __future__ import annotations

from typing import Tuple

import torch

from kornia_tpu_torch.geometry import epipolar as epi
from kornia_tpu_torch.geometry.liegroup import so3_exp_matrix
from kornia_tpu_torch.optim.lm import lm_manifold


def _huber_sqrt(sq_err: torch.Tensor, delta: float) -> torch.Tensor:
    """sqrt of the Huber cost of a SQUARED error, usable as an LM
    residual: linear near zero, sqrt growth past ``delta``."""
    e = torch.sqrt(torch.clamp(sq_err, min=1e-18))
    hub = torch.where(e <= delta, sq_err, delta * (2.0 * e - delta))
    return torch.sqrt(hub)


def _tangent_basis(t: torch.Tensor) -> torch.Tensor:
    """(3, 2) orthonormal basis of the plane perpendicular to t."""
    ex = torch.tensor([1.0, 0.0, 0.0], dtype=t.dtype, device=t.device)
    ey = torch.tensor([0.0, 1.0, 0.0], dtype=t.dtype, device=t.device)
    a = torch.where(torch.abs(t[0]) < 0.7, ex, ey)
    b1 = torch.linalg.cross(t, a, dim=-1)
    b1 = b1 / torch.clamp(torch.linalg.norm(b1), min=1e-12)
    b2 = torch.linalg.cross(t, b1, dim=-1)
    return torch.stack([b1, b2], dim=-1)


def skew(t: torch.Tensor) -> torch.Tensor:
    """[t]×, built with 0·t[0] for the zeros as the reference does (the
    zero is a tensor: under torch.func.jvp a Python scalar times a 0-dim
    tensor gets a float64 tangent)."""
    z = t[0] * t.new_zeros(())
    return torch.stack([
        torch.stack([z, -t[2], t[1]]),
        torch.stack([t[2], z, -t[0]]),
        torch.stack([-t[1], t[0], z]),
    ])


def refine_pose_sampson(r: torch.Tensor, t: torch.Tensor, x1: torch.Tensor,
                        x2: torch.Tensor, k1: torch.Tensor,
                        k2: torch.Tensor, inliers: torch.Tensor,
                        iters: int = 12, threshold_px: float = 1.5
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns the refined (R, t), t unit-norm."""
    kinv1 = torch.linalg.inv(k1.to(torch.float32))
    kinv2t = torch.linalg.inv(k2.to(torch.float32)).T
    w = inliers.to(torch.float32)

    def residual_at(state, delta_px):
        rr, tt = state
        f_px = kinv2t @ (skew(tt) @ rr) @ kinv1
        sq = epi.sampson_distance(f_px, x1, x2)
        return _huber_sqrt(sq, delta_px) * w

    def retract(state, delta):
        rr, tt = state
        r_new = rr @ so3_exp_matrix(delta[:3])
        t_new = tt + _tangent_basis(tt) @ delta[3:5]
        return r_new, t_new / torch.clamp(torch.linalg.norm(t_new),
                                          min=1e-12)

    state = (r.to(torch.float32),
             t.to(torch.float32) / torch.clamp(torch.linalg.norm(t),
                                               min=1e-12))
    for phase_tau in (2.0 * threshold_px, threshold_px):
        res = lm_manifold(
            lambda s, tau=phase_tau: residual_at(s, tau), retract, state,
            tangent_dim=5, max_iterations=max(iters // 2, 1))
        state = res.params
    return state[0], state[1]
