"""Pose refinement (port of kornia_tpu/geometry/refine.py).

``refine_pose_sampson``, the two-view bootstrap's polish: LM on the
essential manifold (SO3 × S², 5 DOF) over the RANSAC inliers, with the
robust threshold annealed (2τ, then τ) across two LM phases and a Huber
clip that keeps the residual vector fixed-shape.

``refine_pose_reprojection``, PnP's polish: LM on SE3 with analytic 2×6
Jacobians and Huber IRLS weights; accept/reject are selects, so the loop
never waits on the device.
"""

from __future__ import annotations

from typing import Tuple

import torch

from kornia_tpu_torch import resolve_device, to_device
from kornia_tpu_torch.geometry import epipolar as epi
from kornia_tpu_torch.geometry.linalg import solve_cholesky_damped
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


def refine_pose_reprojection(r, t, world, pixels, k, inliers,
                             iters: int = 10, threshold_px: float = 2.0,
                             device="cuda"
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Reprojection-cost LM on SE3 (6 DOF) after PnP RANSAC, on
    ``device``: ``iters`` damped Gauss-Newton steps with analytic 2×6
    Jacobians (R' = R exp(δω), t' = t + δt) and Huber IRLS weights over
    the inliers; a step is kept only if it lowers the Huber cost (λ ÷ 10,
    else λ × 10, in [1e-10, 1e6]). Returns the refined (R, t)."""
    f32 = torch.float32
    dev = resolve_device(device)
    wmask = to_device(inliers, dev, f32)
    kf = to_device(k, dev, f32)
    fx, fy = kf[0, 0], kf[1, 1]
    cx, cy = kf[0, 2], kf[1, 2]
    wpts = to_device(world, dev, f32)
    px = to_device(pixels, dev, f32)
    tau2 = threshold_px * threshold_px

    def cost_of(rr, tt):
        cam = wpts @ rr.T + tt
        z = torch.clamp(cam[:, 2], min=1e-6)
        u = fx * cam[:, 0] / z + cx
        v = fy * cam[:, 1] / z + cy
        sq = (u - px[:, 0]) ** 2 + (v - px[:, 1]) ** 2
        sq = torch.where(cam[:, 2] <= 1e-6, torch.full_like(sq, 1e6), sq)
        hub = torch.where(sq <= tau2, sq,
                          2.0 * torch.sqrt(sq * tau2) - tau2)
        return torch.sum(wmask * hub)

    zr = torch.zeros_like(wpts[:, 0])
    # [p]× of every point, (N, 3, 3)
    phat = torch.stack([
        torch.stack([zr, -wpts[:, 2], wpts[:, 1]], -1),
        torch.stack([wpts[:, 2], zr, -wpts[:, 0]], -1),
        torch.stack([-wpts[:, 1], wpts[:, 0], zr], -1),
    ], -2)
    rr = to_device(r, dev, f32)
    tt = to_device(t, dev, f32)
    lam = torch.full((), 1e-3, dtype=f32, device=dev)
    cost = cost_of(rr, tt)
    for _ in range(iters):
        cam = wpts @ rr.T + tt
        z = torch.clamp(cam[:, 2], min=1e-6)
        iz = 1.0 / z
        u = fx * cam[:, 0] * iz + cx
        v = fy * cam[:, 1] * iz + cy
        e = torch.stack([u - px[:, 0], v - px[:, 1]], -1)      # (N, 2)
        sq = torch.sum(e * e, -1)
        # IRLS Huber weight: 1 inside tau, tau/|e| outside
        wr = torch.where(sq <= tau2, torch.ones_like(sq),
                         torch.sqrt(tau2 / torch.clamp(sq, min=1e-12)))
        wr = wr * wmask * (cam[:, 2] > 1e-6)
        zi = torch.zeros_like(iz)
        # dπ/dcam (N, 2, 3)
        a = torch.stack([
            torch.stack([fx * iz, zi, -fx * cam[:, 0] * iz * iz], -1),
            torch.stack([zi, fy * iz, -fy * cam[:, 1] * iz * iz], -1),
        ], -2)
        dr = -torch.einsum("ij,njk->nik", rr, phat)            # (N, 3, 3)
        j = torch.cat([torch.einsum("nij,njk->nik", a, dr), a], -1)
        jw = j * wr[:, None, None]
        jtj = torch.einsum("nki,nkj->ij", jw, j)
        g = torch.einsum("nki,nk->i", jw, e)
        delta = solve_cholesky_damped(jtj, -g, lam)
        r_new = rr @ so3_exp_matrix(delta[:3])
        t_new = tt + delta[3:6]
        new_cost = cost_of(r_new, t_new)
        accept = new_cost < cost
        rr = torch.where(accept, r_new, rr)
        tt = torch.where(accept, t_new, tt)
        lam = torch.clamp(torch.where(accept, lam * 0.1, lam * 10.0),
                          1e-10, 1e6)
        cost = torch.where(accept, new_cost, cost)
    return rr, tt
