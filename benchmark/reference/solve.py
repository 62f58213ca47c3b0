"""Plain least-squares solves the SLAM back end and tracking are judged by.

Written for the benchmark in PyTorch ops (float64 for the judgement, the
control's lower precision where asked); imports nothing of the port. Poses
are world→camera (R, t), read from and written to [qw qx qy qz tx ty tz]
rows; updates are left perturbations exp(δ)∘T with δ = [ρ; ω].

* Bundle adjustment: cost 0.5·Σ w·h(‖r‖²)·‖r‖² over pinhole reprojection
  residuals r (camera depth clamped at 1e-3), h the Huber IRLS weight
  (1 within the scale, scale/‖r‖ beyond), fixed poses and points held;
  LM with the points eliminated (Schur), Marquardt damping.
* Pose-graph optimisation: cost 0.5·Σ w·‖log(T_ab⁻¹·T_b·T_a⁻¹)‖², the
  se(3) logarithm with the inverse left Jacobian; LM on every free pose.
* Pose refinement: the robust reprojection cost of one pose over given
  correspondences, Σ sq within τ², 2·√(sq·τ²) − τ² beyond.

BA and PGO run the program's own schedule (the same iteration count, λ
start, factor and clamps) in float64, so a sound float32 solve lands on
the same cost; the pose refinement, whose start (the RANSAC winner) the
program does not hand out, runs to its optimum from the previous pose.
"""

from __future__ import annotations

import numpy as np
import torch

_MIN_Z = 1e-3


# ---------------------------------------------------------------- SO3/SE3

def quat_to_matrix(q: torch.Tensor) -> torch.Tensor:
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    w, x, y, z = q.unbind(-1)
    return torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ], -1).reshape(q.shape[:-1] + (3, 3))


def hat(w: torch.Tensor) -> torch.Tensor:
    z = torch.zeros_like(w[..., 0])
    return torch.stack([
        torch.stack([z, -w[..., 2], w[..., 1]], -1),
        torch.stack([w[..., 2], z, -w[..., 0]], -1),
        torch.stack([-w[..., 1], w[..., 0], z], -1)], -2)


def _ab(theta2: torch.Tensor):
    """sin θ/θ, (1 − cos θ)/θ², (θ − sin θ)/θ³ with series near 0, of
    θ² (..., 1): forward derivatives of a 0-dim tensor and a Python number
    come out float64, so every scalar keeps a trailing axis."""
    small = theta2 < 1e-8
    t2 = torch.where(small, torch.ones_like(theta2), theta2)
    t = torch.sqrt(t2)
    # tensor-first arithmetic: a Python number first gives forward
    # derivatives of the wrong type outside float64
    a = torch.where(small, -theta2 / 6 + 1, torch.sin(t) / t)
    b = torch.where(small, -theta2 / 24 + 0.5, (-torch.cos(t) + 1) / t2)
    c = torch.where(small, -theta2 / 120 + 1.0 / 6,
                    (t - torch.sin(t)) / (t2 * t))
    return a, b, c


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    a, b, _ = _ab((w * w).sum(-1, keepdim=True))
    k = hat(w)
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    return eye + a[..., None] * k + b[..., None] * (k @ k)


def se3_exp(xi: torch.Tensor):
    """[ρ; ω] → (R, t) with t = J_l(ω)·ρ."""
    rho, w = xi[..., :3], xi[..., 3:]
    _, b, c = _ab((w * w).sum(-1, keepdim=True))
    k = hat(w)
    eye = torch.eye(3, dtype=xi.dtype, device=xi.device)
    jl = eye + b[..., None] * k + c[..., None] * (k @ k)
    return so3_exp(w), (jl @ rho[..., None])[..., 0]


def so3_log(r: torch.Tensor) -> torch.Tensor:
    """Rotation angles below π: θ = atan2(sin θ, cos θ), with the series
    near 0 taken before any square root (finite forward derivatives)."""
    cos = (r.diagonal(dim1=-2, dim2=-1).sum(-1, keepdim=True) - 1) / 2
    v = torch.stack([r[..., 2, 1] - r[..., 1, 2], r[..., 0, 2] - r[..., 2, 0],
                     r[..., 1, 0] - r[..., 0, 1]], -1)      # 2·sin θ·axis
    s2 = (v * v).sum(-1, keepdim=True) / 4
    small = (s2 < 1e-10) & (cos > 0)
    s = torch.sqrt(torch.where(small, torch.ones_like(s2), s2))
    k = torch.where(small, s2 / 12 + 0.5, torch.atan2(s, cos) / (s * 2))
    return k * v


def se3_log(r: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    w = so3_log(r)
    th2 = (w * w).sum(-1, keepdim=True)
    small = th2 < 1e-8
    t2 = torch.where(small, torch.ones_like(th2), th2)
    th = torch.sqrt(t2)
    # J_l⁻¹ = I − ½[ω]× + (1/θ² − (1 + cos θ)/(2θ sin θ))·[ω]×²
    coef = torch.where(small, th2 / 720 + 1.0 / 12,
                       torch.reciprocal(t2) - (torch.cos(th) + 1)
                       / (th * torch.sin(th) * 2))
    k = hat(w)
    eye = torch.eye(3, dtype=r.dtype, device=r.device)
    jinv = eye - k * 0.5 + coef[..., None] * (k @ k)
    return torch.cat([(jinv @ t[..., None])[..., 0], w], -1)


def compose(ra, ta, rb, tb):
    """(a ∘ b): apply b first."""
    return ra @ rb, (ra @ tb[..., None])[..., 0] + ta


def inverse(r, t):
    rt = r.transpose(-1, -2)
    return rt, -(rt @ t[..., None])[..., 0]


def retract(r, t, delta):
    er, et = se3_exp(delta)
    return compose(er, et, r, t)


def poses_rt(poses7, dtype, device):
    p = torch.as_tensor(np.asarray(poses7), dtype=torch.float64).to(device)
    return quat_to_matrix(p[:, :4]).to(dtype), p[:, 4:].to(dtype)


def _wide(dtype):
    return torch.float64 if dtype == torch.float64 else torch.float32


def _solve(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Least-squares solve in at least float32 (linalg has no bfloat16)."""
    wide = _wide(a.dtype)
    return torch.linalg.lstsq(a.to(wide), b.to(wide)[..., None]).solution[
        ..., 0].to(a.dtype)


def _damped(h: torch.Tensor, lam: float) -> torch.Tensor:
    d = torch.diagonal(h, dim1=-2, dim2=-1)
    return h + torch.diag_embed(lam * torch.clamp(d, min=1e-9))


def _lm(cost_fn, step_fn, state, iters: int, lam: float,
        lam_range=(1e-12, 1e10), converge: bool = True):
    """Marquardt loop: ``step_fn(state, λ)`` proposes, a lower cost
    accepts (λ ÷ 10), a higher rejects (λ × 10), λ kept in ``lam_range``.
    ``converge``: stop once a step lowers the cost by no more than a
    relative 1e-12; else run exactly ``iters`` iterations, as the program's
    solvers do."""
    cost = float(cost_fn(state))
    lo, hi = lam_range
    for _ in range(iters):
        cand = step_fn(state, lam)
        new = float(cost_fn(cand))
        if np.isfinite(new) and new < cost:
            done = cost - new <= 1e-12 * cost
            state, cost, lam = cand, new, max(lam / 10, lo)
            if done and converge:
                break
        else:
            lam = min(lam * 10, hi)
    return state, cost


# ------------------------------------------------------------------ BA

class BAInput:
    """One bundle-adjustment problem in the reference's own tensors."""

    def __init__(self, poses7, points, k, obs_cam, obs_pt, obs_uv, obs_w,
                 fixed_poses, fixed_points, loss_scale, device,
                 dtype=torch.float64):
        self.r, self.t = poses_rt(poses7, dtype, device)
        self.x = torch.as_tensor(np.asarray(points), dtype=torch.float64).to(
            device, dtype)
        k = np.asarray(k, np.float64)
        self.f = (float(k[0, 0]), float(k[1, 1]), float(k[0, 2]),
                  float(k[1, 2]))
        keep = np.asarray(obs_w) > 0
        self.cam = torch.as_tensor(np.asarray(obs_cam)[keep], dtype=torch.int64,
                                   device=device)
        self.pt = torch.as_tensor(np.asarray(obs_pt)[keep], dtype=torch.int64,
                                  device=device)
        self.uv = torch.as_tensor(np.asarray(obs_uv)[keep],
                                  dtype=torch.float64).to(device, dtype)
        self.w = torch.as_tensor(np.asarray(obs_w)[keep],
                                 dtype=torch.float64).to(device, dtype)
        self.free_p = torch.as_tensor(~np.asarray(fixed_poses, bool),
                                      device=device)
        self.free_x = torch.as_tensor(~np.asarray(fixed_points, bool),
                                      device=device)
        self.scale = float(loss_scale)


def _ba_residuals(pb: BAInput, r, t, x, jac: bool = False):
    rc, tc, xp = r[pb.cam], t[pb.cam], x[pb.pt]
    pc = (rc @ xp[..., None])[..., 0] + tc
    z = torch.clamp(pc[:, 2], min=_MIN_Z)
    fx, fy, cx, cy = pb.f
    res = torch.stack([fx * pc[:, 0] / z + cx, fy * pc[:, 1] / z + cy],
                      -1) - pb.uv
    if not jac:
        return res
    zero = torch.zeros_like(z)
    jp = torch.stack([torch.stack([fx / z, zero, -fx * pc[:, 0] / z ** 2], -1),
                      torch.stack([zero, fy / z, -fy * pc[:, 1] / z ** 2], -1)],
                     -2)                                          # (M, 2, 3)
    j_pose = torch.cat([jp, jp @ -hat(pc)], -1)                   # (M, 2, 6)
    return res, j_pose, jp @ rc


def _ba_weights(pb: BAInput, res):
    n = torch.sqrt(torch.clamp((res * res).sum(-1), min=1e-18))
    return pb.w * torch.where(n <= pb.scale, torch.ones_like(n), pb.scale / n)


def ba_cost(pb: BAInput, r, t, x) -> float:
    res = _ba_residuals(pb, r, t, x)
    sq = (res * res).sum(-1)
    return float(0.5 * (_ba_weights(pb, res) * sq).to(torch.float64).sum())


def _ba_step(pb: BAInput, state, lam):
    r, t, x = state
    p, n = r.shape[0], x.shape[0]
    res, jpo, jpt = _ba_residuals(pb, r, t, x, jac=True)
    w = _ba_weights(pb, res)[:, None, None]
    u = torch.zeros(p, 6, 6, dtype=r.dtype, device=r.device).index_add_(
        0, pb.cam, (w * jpo).transpose(1, 2) @ jpo)
    gp = torch.zeros(p, 6, dtype=r.dtype, device=r.device).index_add_(
        0, pb.cam, -((w * jpo).transpose(1, 2) @ res[..., None])[..., 0])
    v = torch.zeros(n, 3, 3, dtype=r.dtype, device=r.device).index_add_(
        0, pb.pt, (w * jpt).transpose(1, 2) @ jpt)
    gx = torch.zeros(n, 3, dtype=r.dtype, device=r.device).index_add_(
        0, pb.pt, -((w * jpt).transpose(1, 2) @ res[..., None])[..., 0])
    b = (w * jpo).transpose(1, 2) @ jpt                           # (M, 6, 3)
    bc = torch.zeros(n * p, 6, 3, dtype=r.dtype, device=r.device).index_add_(
        0, pb.pt * p + pb.cam, b).reshape(n, p, 6, 3)
    active = pb.free_x & (torch.diagonal(v, dim1=1, dim2=2).sum(-1) > 0)
    eye3 = torch.eye(3, dtype=r.dtype, device=r.device)
    vd = _damped(v, lam) + (~active)[:, None, None] * eye3
    # a block singular in a low precision leaves its point where it is
    vinv, info = torch.linalg.inv_ex(vd.to(_wide(r.dtype)))
    active = active & (info == 0)
    vinv = vinv.to(r.dtype) * active[:, None, None]
    yc = torch.einsum("npis,nst->npit", bc, vinv)                 # (N,P,6,3)
    s = -torch.einsum("npis,nqjs->piqj", yc, bc).reshape(6 * p, 6 * p)
    s = s + torch.block_diag(*_damped(u, lam))
    rhs = gp - torch.einsum("npis,ns->pi", yc, gx)
    free6 = pb.free_p[:, None].expand(p, 6).reshape(-1)
    s = torch.where(free6[:, None] & free6[None, :], s,
                    torch.eye(6 * p, dtype=s.dtype, device=s.device))
    dp = _solve(s, (rhs.reshape(-1) * free6)).reshape(p, 6)
    dp = dp * pb.free_p[:, None]
    dx = torch.einsum("nst,nt->ns", vinv,
                      gx - torch.einsum("npis,pi->ns", bc, dp))
    r2, t2 = retract(r, t, dp)
    return r2, t2, x + dx * active[:, None]


def ba_solve(pb: BAInput, iters: int, lam: float = 1e-4):
    """(R, t, points) after exactly ``iters`` LM iterations from λ = ``lam``
    (λ in [1e-10, 1e8]), the schedule of the program's solver."""
    state, _ = _lm(lambda s: ba_cost(pb, *s), lambda s, lam_: _ba_step(
        pb, s, lam_), (pb.r, pb.t, pb.x), iters, lam, (1e-10, 1e8), False)
    return state


# ------------------------------------------------------------------ PGO

class PGOInput:
    def __init__(self, poses7, ei, ej, meas7, w, fixed, device,
                 dtype=torch.float64):
        self.r, self.t = poses_rt(poses7, dtype, device)
        self.ei = torch.as_tensor(np.asarray(ei), dtype=torch.int64,
                                  device=device)
        self.ej = torch.as_tensor(np.asarray(ej), dtype=torch.int64,
                                  device=device)
        self.mr, self.mt = poses_rt(meas7, dtype, device)
        self.w = torch.as_tensor(np.asarray(w), dtype=torch.float64).to(
            device, dtype)
        self.free = torch.as_tensor(~np.asarray(fixed, bool), device=device)


def _edge_res(ra, ta, rb, tb, mr, mt):
    rel = compose(rb, tb, *inverse(ra, ta))
    return se3_log(*compose(*inverse(mr, mt), *rel))


def pgo_cost(pg: PGOInput, r, t) -> float:
    res = _edge_res(r[pg.ei], t[pg.ei], r[pg.ej], t[pg.ej], pg.mr, pg.mt)
    return float(0.5 * (pg.w * (res * res).sum(-1)).to(torch.float64).sum())


def _pgo_step(pg: PGOInput, state, lam):
    r, t = state
    p = r.shape[0]

    def res_of(delta, ra, ta, rb, tb, mr, mt):
        a = retract(ra, ta, delta[:6])
        b = retract(rb, tb, delta[6:])
        return _edge_res(*a, *b, mr, mt)

    zero = torch.zeros(pg.ei.shape[0], 12, dtype=r.dtype, device=r.device)
    args = (r[pg.ei], t[pg.ei], r[pg.ej], t[pg.ej], pg.mr, pg.mt)
    res = torch.func.vmap(res_of)(zero, *args)
    # forward derivatives in at least float32 (bfloat16 has none here)
    wide = _wide(r.dtype)
    jac = torch.func.vmap(torch.func.jacfwd(res_of))(
        zero.to(wide), *(a.to(wide) for a in args)).to(r.dtype)  # (E,6,12)
    wj = jac * pg.w[:, None, None]
    hb = wj.transpose(1, 2) @ jac                                  # (E,12,12)
    gb = -(wj.transpose(1, 2) @ res[..., None])[..., 0]            # (E,12)
    idx = torch.stack([pg.ei, pg.ej], 1)                           # (E, 2)
    h = torch.zeros(p, p, 6, 6, dtype=r.dtype, device=r.device)
    g = torch.zeros(p, 6, dtype=r.dtype, device=r.device)
    for a in range(2):
        g.index_add_(0, idx[:, a], gb[:, 6 * a: 6 * a + 6])
        for b in range(2):
            h.view(p * p, 6, 6).index_add_(
                0, idx[:, a] * p + idx[:, b],
                hb[:, 6 * a: 6 * a + 6, 6 * b: 6 * b + 6])
    hd = _damped(h.permute(0, 2, 1, 3).reshape(6 * p, 6 * p)[None], lam)[0]
    free6 = pg.free[:, None].expand(p, 6).reshape(-1)
    hd = torch.where(free6[:, None] & free6[None, :], hd,
                     torch.eye(6 * p, dtype=hd.dtype, device=hd.device))
    d = _solve(hd, g.reshape(-1) * free6).reshape(p, 6) * pg.free[:, None]
    return retract(r, t, d)


def pgo_solve(pg: PGOInput, iters: int, lam: float = 1e-6):
    """Poses after exactly ``iters`` LM iterations from λ = ``lam`` (λ in
    [1e-12, 1e8]), the schedule of the program's solver."""
    state, _ = _lm(lambda s: pgo_cost(pg, *s),
                   lambda s, lam_: _pgo_step(pg, s, lam_), (pg.r, pg.t),
                   iters, lam, (1e-12, 1e8), False)
    return state


# --------------------------------------------------------- pose refinement

class PoseInput:
    def __init__(self, world, pixels, k, tau_px, device, dtype=torch.float64):
        self.xw = torch.as_tensor(np.asarray(world), dtype=torch.float64).to(
            device, dtype)
        self.px = torch.as_tensor(np.asarray(pixels), dtype=torch.float64).to(
            device, dtype)
        k = np.asarray(k, np.float64)
        self.f = (float(k[0, 0]), float(k[1, 1]), float(k[0, 2]),
                  float(k[1, 2]))
        self.tau2 = float(tau_px) ** 2


def project(f, r, t, xw):
    pc = xw @ r.T + t
    z = torch.clamp(pc[:, 2], min=1e-6)
    return torch.stack([f[0] * pc[:, 0] / z + f[2], f[1] * pc[:, 1] / z + f[3]],
                       -1)


def pose_cost(pi: PoseInput, r, t) -> float:
    sq = ((project(pi.f, r, t, pi.xw) - pi.px) ** 2).sum(-1)
    hub = torch.where(sq <= pi.tau2, sq,
                      2 * torch.sqrt(sq * pi.tau2) - pi.tau2)
    return float(hub.to(torch.float64).sum())


def _pose_step(pi: PoseInput, state, lam):
    r, t = state

    def res_at(delta, dtype):
        r2, t2 = retract(r.to(dtype), t.to(dtype), delta.to(dtype))
        e = project(pi.f, r2, t2, pi.xw.to(dtype)) - pi.px.to(dtype)
        sq = (e * e).sum(-1)
        wr = torch.where(sq <= pi.tau2, torch.ones_like(sq),
                         torch.sqrt(pi.tau2 / torch.clamp(sq, min=1e-12)))
        return (e * torch.sqrt(wr.detach())[:, None]).reshape(-1)

    def res(delta):
        return res_at(delta, r.dtype)

    zero = torch.zeros(6, dtype=r.dtype, device=r.device)
    e = res(zero)
    wide = _wide(r.dtype)
    j = torch.func.jacfwd(lambda d: res_at(d.to(r.dtype), wide))(
        zero.to(wide)).to(r.dtype)
    h = _damped((j.T @ j)[None], lam)[0]
    return retract(r, t, _solve(h, -(j.T @ e)))


def pose_solve(pi: PoseInput, r0, t0, iters: int = 50):
    """The optimum from (r0, t0): LM until a step gains no more than a
    relative 1e-12."""
    state, _ = _lm(lambda s: pose_cost(pi, *s),
                   lambda s, lam: _pose_step(pi, s, lam), (r0, t0), iters,
                   1e-3)
    return state


# ------------------------------------------------------------------ ATE

def ate_rmse(est_centres: np.ndarray, gt_centres: np.ndarray) -> float:
    """RMSE of camera centres after the least-squares similarity
    alignment (Umeyama 1991) of the estimate onto the truth."""
    src = np.asarray(est_centres, np.float64)
    dst = np.asarray(gt_centres, np.float64)
    mu_s, mu_d = src.mean(0), dst.mean(0)
    xs, xd = src - mu_s, dst - mu_d
    u, d, vt = np.linalg.svd(xd.T @ xs / len(src))
    fix = np.eye(3)
    if np.linalg.det(u) * np.linalg.det(vt) < 0:
        fix[2, 2] = -1
    rot = u @ fix @ vt
    scale = np.trace(np.diag(d) @ fix) / ((xs ** 2).sum() / len(src))
    aligned = scale * xs @ rot.T + mu_d
    return float(np.sqrt(np.mean(np.sum((aligned - dst) ** 2, 1))))
