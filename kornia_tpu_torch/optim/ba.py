"""Bundle adjustment with Schur-complement reduction (port of
kornia_tpu/optim/ba.py).

Observations are flat tensors (camera, point, uv, weight). The block
normal equations are segmented sums over observations (``index_add_``),
the reduced camera system S = U − Σ_pt Yc·Bcᵀ is one (6P, 3N)·(3N, 6P)
product over the per-(point, camera) coupling sums, and the LM loop is a
Python loop of ``torch.where`` selects: no iteration reads anything back
to the host, so a solve on the card is queued in one go. Tangents are
[ρ; ω] left perturbations, Jacobians analytic, float32 with no TF32.

The reference's tiled one-hot segment engine (``seg_oh``/``seg_ids``/
``cam_oh``, ``KORNIA_TPU_BA_ENGINE``) is left out: it turns scatters into
matmuls because the TPU scatters at scalar rate, and a GPU scatters at
memory rate. The segmented sums here hold the values of its
``segment_sum`` path.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from kornia_tpu_torch import resolve_device
from kornia_tpu_torch.geometry import liegroup as lg
from kornia_tpu_torch.geometry.linalg import (inv3x3, solve_cholesky,
                                              solve_unrolled)
from kornia_tpu_torch.optim.losses import LOSSES

_MIN_Z = 1e-3   # camera-frame depth clamp
_PAD_M = 1024   # observations are padded to a multiple of this


@dataclasses.dataclass(frozen=True)
class BAParams:
    max_iterations: int = 20
    lambda_init: float = 1e-4
    lambda_factor: float = 10.0
    loss: str = "huber"
    loss_scale: float = 1.0  # pixels
    cost_tolerance: float = 1e-9
    # reduced-camera-system solver: "dense" builds S (6P, 6P) and
    # Cholesky-solves it; "pcg" runs matrix-free block-Jacobi-
    # preconditioned CG with O(M) work per CG step and never builds the
    # (N, P) coupling tensor. "auto" picks pcg when P > 400.
    solver: str = "auto"
    cg_iters: int = 60


class BAProblem(NamedTuple):
    """Static-topology BA problem. Build with :func:`build_problem`."""

    poses: torch.Tensor        # (P, 7) se3 world→camera
    points: torch.Tensor       # (N, 3)
    k: torch.Tensor            # (3, 3) shared intrinsics
    obs_cam: torch.Tensor      # (M,) int32
    obs_pt: torch.Tensor       # (M,) int32
    obs_uv: torch.Tensor       # (M, 2)
    obs_w: torch.Tensor        # (M,) confidence; 0 = padding
    fixed_poses: torch.Tensor  # (P,) bool
    fixed_points: torch.Tensor  # (N,) bool
    obs_by_point: torch.Tensor  # (N, K) int32 obs indices (padded w/ 0)
    obs_by_point_mask: torch.Tensor  # (N, K) bool
    # optional RGB-D channel: per-observation measured camera-frame depth
    # and its weight (0 = none)
    obs_depth: Optional[torch.Tensor] = None      # (M,)
    obs_depth_w: Optional[torch.Tensor] = None    # (M,)
    # per-pose translation priors: r = (C − center) / σ with C = −Rᵀt the
    # camera centre in the world frame; prior_invs[i] = 1/σᵢ, 0 = none
    prior_center: Optional[torch.Tensor] = None   # (P, 3)
    prior_invs: Optional[torch.Tensor] = None     # (P,)


class BAResult(NamedTuple):
    poses: torch.Tensor
    points: torch.Tensor
    initial_cost: torch.Tensor
    final_cost: torch.Tensor
    iterations: int


def build_problem(
    poses, points, k, obs_cam, obs_pt, obs_uv,
    obs_w=None, fixed_poses=None, fixed_points=None,
    max_obs_per_point: Optional[int] = None,
    obs_depth=None, obs_depth_w=None,
    pose_prior_center=None, pose_prior_sigma=None,
    device="cuda",
) -> BAProblem:
    """Host-side construction: sorts observations by point (stable),
    pads them to a multiple of 1024 with zero-weight rows on the last
    point, groups them by point (padded to K = max observations per
    point, or ``max_obs_per_point``), then moves everything to
    ``device``."""
    dev = resolve_device(device)
    obs_cam = np.asarray(obs_cam, np.int32)
    obs_pt = np.asarray(obs_pt, np.int32)
    obs_uv = np.asarray(obs_uv, np.float32)
    n_pts = np.asarray(points).shape[0]
    n_poses = np.asarray(poses).shape[0]
    m = obs_cam.shape[0]
    if obs_w is None:
        obs_w = np.ones(m, np.float32)
    obs_w = np.asarray(obs_w, np.float32)
    if obs_depth is not None:
        obs_depth = np.asarray(obs_depth, np.float32)
        obs_depth_w = np.asarray(
            np.ones(m, np.float32) if obs_depth_w is None else obs_depth_w,
            np.float32)

    prior_center = prior_invs = None
    if pose_prior_center is not None:
        prior_center = np.zeros((n_poses, 3), np.float32)
        prior_invs = np.zeros(n_poses, np.float32)
        prior_center[:] = np.nan_to_num(
            np.asarray(pose_prior_center, np.float32))
        sig = np.asarray(pose_prior_sigma, np.float32)
        # σ is clamped to ≥ 1e-6; σ ≤ 0 or NaN = no prior
        good = np.isfinite(sig) & (sig > 0.0)
        prior_invs[good] = 1.0 / np.maximum(sig[good], 1e-6)

    perm = np.argsort(obs_pt, kind="stable")
    obs_cam = obs_cam[perm]
    obs_pt = obs_pt[perm]
    obs_uv = obs_uv[perm]
    obs_w = obs_w[perm]
    if obs_depth is not None:
        obs_depth = obs_depth[perm]
        obs_depth_w = obs_depth_w[perm]

    # zero-weight padding rows contribute exactly zero everywhere: every
    # accumulated quantity is scaled by obs_w
    m_pad = -m % _PAD_M
    if m_pad:
        obs_cam = np.concatenate([obs_cam, np.zeros(m_pad, np.int32)])
        obs_pt = np.concatenate(
            [obs_pt, np.full(m_pad, n_pts - 1, np.int32)])
        obs_uv = np.concatenate([obs_uv, np.zeros((m_pad, 2), np.float32)])
        obs_w = np.concatenate([obs_w, np.zeros(m_pad, np.float32)])
        if obs_depth is not None:
            obs_depth = np.concatenate(
                [obs_depth, np.zeros(m_pad, np.float32)])
            obs_depth_w = np.concatenate(
                [obs_depth_w, np.zeros(m_pad, np.float32)])

    # each real observation's rank among its point's, in sorted order;
    # the first K of a point fill its row
    counts = np.bincount(obs_pt[:m], minlength=n_pts)
    K = int(counts.max()) if max_obs_per_point is None else max_obs_per_point
    K = max(K, 1)
    first = np.cumsum(counts) - counts
    rank = np.arange(m) - first[obs_pt[:m]]
    keep = rank < K
    by_pt = np.zeros((n_pts, K), np.int32)
    by_pt_mask = np.zeros((n_pts, K), bool)
    by_pt[obs_pt[:m][keep], rank[keep]] = np.nonzero(keep)[0]
    by_pt_mask[obs_pt[:m][keep], rank[keep]] = True

    def t(a, dtype=None):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

    f32 = torch.float32
    return BAProblem(
        poses=t(poses, f32), points=t(points, f32), k=t(k, f32),
        obs_cam=t(obs_cam), obs_pt=t(obs_pt), obs_uv=t(obs_uv, f32),
        obs_w=t(obs_w, f32),
        fixed_poses=(torch.zeros(n_poses, dtype=torch.bool, device=dev)
                     if fixed_poses is None else t(fixed_poses, torch.bool)),
        fixed_points=(torch.zeros(n_pts, dtype=torch.bool, device=dev)
                      if fixed_points is None
                      else t(fixed_points, torch.bool)),
        obs_by_point=t(by_pt), obs_by_point_mask=t(by_pt_mask),
        obs_depth=None if obs_depth is None else t(obs_depth, f32),
        obs_depth_w=None if obs_depth is None else t(obs_depth_w, f32),
        prior_center=None if prior_center is None else t(prior_center),
        prior_invs=None if prior_invs is None else t(prior_invs),
    )


# ---------------------------------------------------------------------------
# segmented sums (the reference's segment_sum path)
# ---------------------------------------------------------------------------


def _seg_sum(vals: torch.Tensor, idx: torch.Tensor, n: int) -> torch.Tensor:
    """out[j] = Σ_{i: idx[i] = j} vals[i]; (M, ...) → (n, ...)."""
    out = torch.zeros((n,) + vals.shape[1:], dtype=vals.dtype,
                      device=vals.device)
    return out.index_add_(0, idx, vals)


def _mv(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Per-block a·x, (..., i, j) · (..., j) → (..., i): a broadcast
    multiply and a sum (cuBLAS's batched gemv is several times slower on
    ~10⁵ blocks of 6×3)."""
    return torch.sum(a * x[..., None, :], dim=-1)


def _mtv(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Per-block aᵀ·x, (..., i, j) · (..., i) → (..., j)."""
    return torch.sum(a * x[..., :, None], dim=-2)


def _damp(blocks: torch.Tensor, lam, floor: float = 1e-9) -> torch.Tensor:
    """blocks + λ·diag(max(diag(blocks), floor)), per block."""
    d = torch.diagonal(blocks, dim1=-2, dim2=-1)
    return blocks + torch.diag_embed(lam * torch.clamp(d, min=floor))


# ---------------------------------------------------------------------------
# residuals + analytic Jacobians
# ---------------------------------------------------------------------------


def prior_terms(poses, prior_center, prior_invs, fixed_poses,
                loss: str, loss_scale: float):
    """Per-pose translation-prior contributions under the left
    perturbation exp(δ)·T, where ∂C/∂ρ = −Rᵀ and ∂C/∂ω = 0 for the camera
    centre C = −Rᵀt. Returns (dU (P, 6, 6), dg (P, 6), cost) to add to the
    pose blocks; priors on fixed poses are ignored."""
    rm = lg.quat_to_matrix(poses[:, 0:4])            # (P, 3, 3)
    t = poses[:, 4:7]
    c_pred = -torch.einsum("pji,pj->pi", rm, t)      # −Rᵀt
    invs = prior_invs * (~fixed_poses)
    r = (c_pred - prior_center) * invs[:, None]      # whitened (P, 3)
    sq = torch.sum(r * r, dim=-1)
    w = LOSSES[loss](sq, loss_scale) * (invs > 0.0)
    # J = [−Rᵀ·invσ | 0]  (P, 3, 6)
    j = torch.cat([-rm.transpose(-1, -2) * invs[:, None, None],
                   torch.zeros_like(rm)], dim=-1)
    du = torch.einsum("pki,pkj->pij", j * w[:, None, None], j)
    dg = -torch.einsum("pki,pk->pi", j * w[:, None, None], r)
    cost = 0.5 * torch.sum(w * sq)
    return du, dg, cost


def _project_with_jacobians(poses, points, k, obs_cam, obs_pt, obs_uv,
                            obs_depth=None, obs_depth_w=None):
    """Per-observation residual (M, R), J_pose (M, R, 6) wrt the [ρ; ω]
    left perturbation and J_pt (M, R, 3). R = 2; with ``obs_depth`` an
    RGB-D row ``w_d · (z_cam − depth)`` is appended (R = 3), its weight on
    the residual and the Jacobian row alike."""
    pose_i = poses.index_select(0, obs_cam)    # (M, 7)
    pt_i = points.index_select(0, obs_pt)      # (M, 3)
    p_cam = lg.se3_apply(pose_i, pt_i)
    x, y = p_cam[:, 0], p_cam[:, 1]
    z = torch.clamp(p_cam[:, 2], min=_MIN_Z)
    fx, fy = k[0, 0], k[1, 1]
    cx, cy = k[0, 2], k[1, 2]
    u = fx * x / z + cx
    v = fy * y / z + cy
    r = torch.stack([u, v], dim=-1) - obs_uv  # (M, 2)

    iz = 1.0 / z
    iz2 = iz * iz
    zero = torch.zeros_like(x)
    jproj = torch.stack([                    # ∂π/∂p_cam (M, 2, 3)
        torch.stack([fx * iz, zero, -fx * x * iz2], dim=-1),
        torch.stack([zero, fy * iz, -fy * y * iz2], dim=-1)], dim=-2)
    if obs_depth is not None:
        dw = (torch.ones_like(z) if obs_depth_w is None
              else obs_depth_w) * (obs_depth > 0.0)
        r = torch.cat([r, (dw * (p_cam[:, 2] - obs_depth))[:, None]], dim=-1)
        one = torch.ones_like(x)
        dz = dw[:, None] * torch.stack([zero, zero, one], -1)
        jproj = torch.cat([jproj, dz[:, None]],
                          dim=-2)  # (M, 3, 3): ∂(w_d z)/∂p_cam = w_d·[0,0,1]

    # ∂p_cam/∂δ = [I | −[p_cam]×] (left perturbation exp(δ)·T)
    jp_rot = -lg.so3_hat(p_cam)
    j_pose = torch.cat([jproj, torch.einsum("mij,mjk->mik", jproj, jp_rot)],
                       dim=-1)                               # (M, R, 6)
    r_mats = lg.quat_to_matrix(pose_i[:, 0:4])               # ∂p_cam/∂X = R
    j_pt = torch.einsum("mij,mjk->mik", jproj, r_mats)       # (M, R, 3)
    return r, j_pose, j_pt


def ba_cost(problem: BAProblem, poses=None, points=None,
            params: BAParams = BAParams()) -> torch.Tensor:
    """Total robust cost 0.5 Σ w·ρ(‖r‖²), priors included."""
    poses = problem.poses if poses is None else poses
    points = problem.points if points is None else points
    r, _, _ = _project_with_jacobians(
        poses, points, problem.k, problem.obs_cam, problem.obs_pt,
        problem.obs_uv, problem.obs_depth, problem.obs_depth_w)
    sq = torch.sum(r * r, dim=-1)
    w = LOSSES[params.loss](sq, params.loss_scale)
    cost = 0.5 * torch.sum(problem.obs_w * w * sq)
    if problem.prior_center is not None:
        _, _, pc = prior_terms(poses, problem.prior_center,
                               problem.prior_invs, problem.fixed_poses,
                               params.loss, params.loss_scale)
        cost = cost + pc
    return cost


# ---------------------------------------------------------------------------
# one damped Schur step
# ---------------------------------------------------------------------------


def schur_normal_equations(problem: BAProblem, poses, points,
                           params: BAParams):
    """The block normal equations: (U (P,6,6), g_p (P,6), V (N,3,3),
    g_x (N,3), B (M,6,3)), B the per-observation pose-point block."""
    p = poses.shape[0]
    n = points.shape[0]
    r, j_pose, j_pt = _project_with_jacobians(
        poses, points, problem.k, problem.obs_cam, problem.obs_pt,
        problem.obs_uv, problem.obs_depth, problem.obs_depth_w)
    sq = torch.sum(r * r, dim=-1)
    w = problem.obs_w * LOSSES[params.loss](sq, params.loss_scale)
    wj_pose = j_pose * w[:, None, None]
    wj_pt = j_pt * w[:, None, None]

    u_blocks = torch.einsum("mki,mkj->mij", wj_pose, j_pose)  # (M,6,6)
    v_blocks = torch.einsum("mki,mkj->mij", wj_pt, j_pt)      # (M,3,3)
    b_blocks = torch.einsum("mki,mkj->mij", wj_pose, j_pt)    # (M,6,3)
    gp_terms = -_mtv(wj_pose, r)                              # (M,6)
    gx_terms = -_mtv(wj_pt, r)                                # (M,3)

    U = _seg_sum(u_blocks, problem.obs_cam, p)
    g_p = _seg_sum(gp_terms, problem.obs_cam, p)
    V = _seg_sum(v_blocks, problem.obs_pt, n)
    g_x = _seg_sum(gx_terms, problem.obs_pt, n)
    if problem.prior_center is not None:
        du, dg, _ = prior_terms(poses, problem.prior_center,
                                problem.prior_invs, problem.fixed_poses,
                                params.loss, params.loss_scale)
        U = U + du
        g_p = g_p + dg
    return U, g_p, V, g_x, b_blocks


def _point_inverses(V, lam, active):
    """Per-point inverse of the damped V block; 0 where not ``active``."""
    eye3 = torch.eye(3, dtype=V.dtype, device=V.device)
    v_inv = inv3x3(_damp(V, lam) + (~active)[:, None, None] * eye3)
    return torch.where(active[:, None, None], v_inv,
                       torch.zeros_like(v_inv))


def _damped_point_inverses(problem: BAProblem, V, lam):
    """Per-point inverse of the damped V block; 0 for fixed points and
    points with no observation."""
    active = (~problem.fixed_points) & problem.obs_by_point_mask.any(dim=1)
    return _point_inverses(V, lam, active)


def _camera_coupling(b_blocks, v_inv, obs_pt, obs_cam, p: int):
    """Σ_pt Yc[pt, a]·Bc[pt, b]ᵀ as one (6P, 6P) matrix, with
    Bc[pt, cam] = Σ_{i: pt_i = pt, cam_i = cam} B_i and Yc = Bc·V⁻¹[pt]:
    one (6P, 3N)·(3N, 6P) product."""
    n = v_inv.shape[0]
    m = b_blocks.shape[0]
    pair_key = obs_pt.to(torch.int64) * p + obs_cam
    bc = _seg_sum(b_blocks.reshape(m, 18), pair_key, n * p).reshape(
        n, p, 6, 3)
    yc = torch.einsum("npis,nst->npit", bc, v_inv)
    # [(a, i), (b, j)] = Σ_{pt, s} yc[pt, a, i, s] · bc[pt, b, j, s]
    return (yc.permute(1, 2, 0, 3).reshape(6 * p, 3 * n)
            @ bc.permute(0, 3, 1, 2).reshape(3 * n, 6 * p))


def _gauge_fixed_system(s, u_damped, rhs_p, fixed_poses):
    """S = ``s`` (the negated coupling, (6P, 6P), changed in place) plus
    the damped U blocks on its diagonal, then gauge-fixed: fixed poses get
    identity rows and columns and a zero rhs. Returns (S, rhs (6P,))."""
    p = u_damped.shape[0]
    blocks = torch.diagonal(s.view(p, 6, p, 6), dim1=0, dim2=2)  # (6, 6, P)
    blocks.add_(u_damped.permute(1, 2, 0))
    free = (~fixed_poses).to(s.dtype)
    free6 = free[:, None].expand(p, 6).reshape(-1)
    s = s * free6[:, None] * free6[None, :]
    s.diagonal().add_(1.0 - free6)
    return s, (rhs_p * free[:, None]).reshape(-1)


def reduce_camera_system(problem: BAProblem, U, g_p, V, g_x, b_blocks, lam):
    """The dense reduced camera system S (6P, 6P) and rhs (6P,):
    S = blockdiag(U damped) − Σ_pt Yc[pt, a]·Bc[pt, b]ᵀ with
    Bc[pt, cam] = Σ_{i: pt_i = pt, cam_i = cam} B_i and Yc = Bc·V⁻¹[pt],
    one (6P, 3N)·(3N, 6P) product. Returns (S, rhs, V⁻¹, Y)."""
    p = U.shape[0]
    v_inv = _damped_point_inverses(problem, V, lam)
    y_blocks, rhs_terms = _schur_rhs_terms(b_blocks, v_inv, g_x,
                                           problem.obs_pt)
    # rhs_p = g_p − Σ_i Y_i g_x[pt_i]
    rhs_p = g_p - _seg_sum(rhs_terms, problem.obs_cam, p)
    s, rhs = _gauge_fixed_system(
        -_camera_coupling(b_blocks, v_inv, problem.obs_pt, problem.obs_cam,
                          p),
        _damp(U, lam), rhs_p, problem.fixed_poses)
    return s, rhs, v_inv, y_blocks


def _schur_rhs_terms(b_blocks, v_inv, g_x, obs_pt):
    """Per observation Y_i = B_i · V⁻¹[pt_i] (M, 6, 3) and its term
    Y_i · g_x[pt_i] (M, 6) of the reduced rhs."""
    y_blocks = torch.einsum("mij,mjk->mik", b_blocks,
                            v_inv.index_select(0, obs_pt))
    return y_blocks, _mv(y_blocks, g_x.index_select(0, obs_pt))


def back_substitute_points(problem: BAProblem, v_inv, b_blocks, g_x,
                           delta_pose):
    """δx_j = V⁻¹_j (g_x_j − Σ_{i ∈ obs(j)} Bᵢᵀ δp[camᵢ])."""
    dx = _back_substitute(v_inv, b_blocks, g_x, delta_pose, problem.obs_cam,
                          problem.obs_pt)
    return dx * (~problem.fixed_points)[:, None]


def _back_substitute(v_inv, b_blocks, g_x, delta_pose, obs_cam, obs_pt):
    """V⁻¹_j (g_x_j − Σ_{i ∈ obs(j)} Bᵢᵀ δp[camᵢ]) for every point j."""
    bt_dp = _mtv(b_blocks, delta_pose.index_select(0, obs_cam))  # (M, 3)
    acc = _seg_sum(bt_dp, obs_pt, v_inv.shape[0])
    return _mv(v_inv, g_x - acc)


def _pcg_reduced_solve(problem: BAProblem, U, g_p, V, g_x, b_blocks, lam,
                       cg_iters: int):
    """Matrix-free PCG on the reduced camera system:
    S v = U_d v − Σ_i B_i V⁻¹[pt_i] (Σ_{j: pt_j = pt_i} B_jᵀ v[cam_j]),
    O(M) products and segmented sums per CG step; the preconditioner is
    the per-pose inverse of the damped U block. A fixed number of steps;
    a step after convergence is a select of no change."""
    p = U.shape[0]
    free = (~problem.fixed_poses).to(U.dtype)[:, None]
    v_inv = _damped_point_inverses(problem, V, lam)
    u_damped = _damp(U, lam)

    # rhs = g_p − Σ_i B_i V⁻¹[pt_i] g_x[pt_i], gauge-masked
    yg = _mv(b_blocks, _mv(v_inv, g_x).index_select(0, problem.obs_pt))
    rhs = (g_p - _seg_sum(yg, problem.obs_cam, p)) * free

    def matvec(v):
        vf = v * free
        sv = _mv(u_damped, vf) - _coupling_matvec(
            b_blocks, v_inv, vf, problem.obs_cam, problem.obs_pt, p)
        return sv * free + v * (1.0 - free)

    return _pcg(matvec, rhs, _block_jacobi(u_damped, free), cg_iters), v_inv


def _coupling_matvec(b_blocks, v_inv, v, obs_cam, obs_pt, p: int):
    """Σ_i B_i V⁻¹[pt_i] Σ_{j: pt_j = pt_i} B_jᵀ v[cam_j], (P, 6): the
    coupling's product with ``v`` in O(M) work, never built."""
    t1 = _mtv(b_blocks, v.index_select(0, obs_cam))
    t3 = _mv(v_inv, _seg_sum(t1, obs_pt, v_inv.shape[0]))
    t4 = _mv(b_blocks, t3.index_select(0, obs_pt))
    return _seg_sum(t4, obs_cam, p)


def _block_jacobi(u_damped, free):
    """The preconditioner: each damped U block's inverse, the identity on
    fixed poses (``free`` (P, 1), 0 there)."""
    p = u_damped.shape[0]
    eye6 = torch.eye(6, dtype=u_damped.dtype,
                     device=u_damped.device).expand(p, 6, 6)
    return solve_unrolled(torch.where(free[:, :, None] > 0, u_damped, eye6),
                          eye6)


def _pcg(matvec, rhs, minv, cg_iters: int):
    """``cg_iters`` preconditioned CG steps on (P, 6) vectors from 0; a
    step after convergence is a select of no change."""
    x = torch.zeros_like(rhs)
    r = rhs
    z = _mv(minv, r)
    pk = z
    rz = torch.sum(r * z)
    for _ in range(cg_iters):
        ap = matvec(pk)
        denom = torch.sum(pk * ap)
        alive = (rz > 1e-20) & (denom > 1e-20)
        alpha = torch.where(alive, rz / torch.clamp(denom, min=1e-20), 0.0)
        x = x + alpha * pk
        r = r - alpha * ap
        z = _mv(minv, r)
        rz_new = torch.sum(r * z)
        beta = torch.where(alive, rz_new / torch.clamp(rz, min=1e-20), 0.0)
        pk = z + beta * pk
        rz = rz_new
    return x


def _uses_pcg(params: BAParams, p: int) -> bool:
    return params.solver == "pcg" or (params.solver == "auto" and p > 400)


def _schur_step(problem: BAProblem, poses, points, lam, params: BAParams):
    U, g_p, V, g_x, b_blocks = schur_normal_equations(problem, poses, points,
                                                      params)
    p = poses.shape[0]
    if _uses_pcg(params, p):
        delta_pose, v_inv = _pcg_reduced_solve(
            problem, U, g_p, V, g_x, b_blocks, lam, params.cg_iters)
    else:
        s_dense, rhs, v_inv, _ = reduce_camera_system(
            problem, U, g_p, V, g_x, b_blocks, lam)
        # a matrix that is not positive definite gives NaN (no wait for
        # the device), and the cost test then rejects the step
        delta_pose = solve_cholesky(s_dense, rhs).reshape(p, 6)
    delta_pose = delta_pose * (~problem.fixed_poses)[:, None]
    dx = back_substitute_points(problem, v_inv, b_blocks, g_x, delta_pose)
    return lg.se3_retract(poses, delta_pose), points + dx


def bundle_adjust_schur(problem: BAProblem,
                        params: BAParams = BAParams()) -> BAResult:
    """LM-damped Schur BA, ``params.max_iterations`` steps on the
    problem's device."""
    c0 = ba_cost(problem, params=params)
    poses, points, cost = problem.poses, problem.points, c0
    lam = torch.full((), params.lambda_init, dtype=torch.float32,
                     device=poses.device)
    for _ in range(params.max_iterations):
        new_poses, new_points = _schur_step(problem, poses, points, lam,
                                            params)
        new_cost = ba_cost(problem, new_poses, new_points, params)
        accept = new_cost < cost
        poses = torch.where(accept, new_poses, poses)
        points = torch.where(accept, new_points, points)
        lam = torch.clamp(torch.where(accept, lam / params.lambda_factor,
                                      lam * params.lambda_factor),
                          1e-10, 1e8)
        cost = torch.where(accept, new_cost, cost)
    return BAResult(poses=poses, points=points, initial_cost=c0,
                    final_cost=cost, iterations=params.max_iterations)
