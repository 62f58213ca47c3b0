"""Perspective-n-Point (port of kornia_tpu/geometry/pnp.py).

Batched solvers: (B, N, 3) world points × (B, N, 2) pixels → (B, pose).
EPnP follows Lepetit et al.: 4 control points from PCA, barycentric
coordinates, the 12×12 null vector by ridged inverse iteration on the
unrolled solve (the N = 1 case) and the β scale from control-point
distances, then a rigid fit. P3P (Grunert) and AP3P (Ke & Roumeliotis)
solve a quartic in closed form and take the root the 4th point agrees
with. ``solve_pnp_ransac`` runs one of them in the batched RANSAC, then
the reprojection LM; on the default ``method="epnp"`` nothing in it waits
on the device.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from kornia_tpu_torch import resolve_device, to_device
from kornia_tpu_torch.geometry.camera import _project, normalize_points
from kornia_tpu_torch.geometry.linalg import (_where_small, det3x3,
                                              eigh3x3, inv4x4,
                                              rigid_transform_3d,
                                              solve_quartic, solve_unrolled,
                                              svd3)
from kornia_tpu_torch.geometry.ransac import ransac
from kornia_tpu_torch.geometry.refine import refine_pose_reprojection


class PnPResult(NamedTuple):
    rotation: torch.Tensor     # (..., 3, 3) world → camera
    translation: torch.Tensor  # (..., 3)


def _ones(x: torch.Tensor) -> torch.Tensor:
    """Unit weights over the point dim of (..., N, D)."""
    return torch.ones(x.shape[:-1], dtype=x.dtype, device=x.device)


# ---------------------------------------------------------------------------
# EPnP
# ---------------------------------------------------------------------------


def _control_points(pts: torch.Tensor, weights: torch.Tensor
                    ) -> torch.Tensor:
    """(..., N, 3) → (..., 4, 3): centroid + principal axes scaled by the
    data spread."""
    wsum = torch.clamp(torch.sum(weights, dim=-1, keepdim=True), min=1e-12)
    c = torch.sum(pts * weights[..., None], dim=-2) / wsum
    centered = (pts - c[..., None, :]) * weights[..., None]
    cov = (torch.einsum("...ni,...nj->...ij", centered, centered)
           / wsum[..., None])
    evals, evecs = eigh3x3(cov)                     # ascending
    scale = torch.sqrt(torch.clamp(evals, min=1e-12))
    axes = evecs * scale[..., None, :]              # columns scaled
    c = c[..., None, :]
    return torch.cat([c, c + axes[..., None, :, 2], c + axes[..., None, :, 1],
                      c + axes[..., None, :, 0]], dim=-2)


def _barycentric(pts: torch.Tensor, ctrl: torch.Tensor) -> torch.Tensor:
    """alphas (..., N, 4) with pts = Σ αᵢ ctrlᵢ, Σ αᵢ = 1."""
    ch = torch.cat([ctrl, torch.ones_like(ctrl[..., :1])], dim=-1)
    ph = torch.cat([pts, torch.ones_like(pts[..., :1])], dim=-1)
    chinv = inv4x4(ch.transpose(-1, -2))           # alphas = ph @ ch⁻ᵀ
    return torch.einsum("...ij,...nj->...ni", chinv, ph)


def _pdists(c: torch.Tensor) -> torch.Tensor:
    pairs = ((0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3))
    return torch.stack([c[..., i, :] - c[..., j, :] for i, j in pairs],
                       dim=-2)


def pnp_epnp(world: torch.Tensor, pixels: torch.Tensor, k: torch.Tensor,
             weights: Optional[torch.Tensor] = None) -> PnPResult:
    """EPnP (batched). world (..., N, 3), pixels (..., N, 2), k (3, 3)."""
    if weights is None:
        weights = _ones(world)
    ctrl_w = _control_points(world, weights)
    alphas = _barycentric(world, ctrl_w)           # (..., N, 4)

    xn = normalize_points(pixels, k)
    u, v = xn[..., 0], xn[..., 1]
    # two equations a point over the 12 control-point coordinates
    # [x1 y1 z1 … x4 y4 z4]: Σⱼ αⱼ xⱼ − u Σⱼ αⱼ zⱼ = 0 and the v row
    zeros = torch.zeros_like(alphas)
    row_x = torch.stack([alphas, zeros, -u[..., :, None] * alphas],
                        dim=-1).reshape(alphas.shape[:-1] + (12,))
    row_y = torch.stack([zeros, alphas, -v[..., :, None] * alphas],
                        dim=-1).reshape(alphas.shape[:-1] + (12,))
    m = torch.cat([row_x, row_y], dim=-2)          # (..., 2N, 12)
    m = m * torch.cat([weights, weights], dim=-1)[..., None]
    mtm = torch.einsum("...ni,...nj->...ij", m, m)  # (..., 12, 12)

    # smallest eigenvector by ridged inverse iteration on the unrolled
    # 12×12 solve
    trace = torch.diagonal(mtm, dim1=-2, dim2=-1).sum(-1)
    ridge = (1e-9 * trace + 1e-20)[..., None, None]
    m_r = mtm + ridge * torch.eye(12, dtype=mtm.dtype, device=mtm.device)
    vb = torch.full(mtm.shape[:-1], 1.0 / math.sqrt(12.0), dtype=mtm.dtype,
                    device=mtm.device)
    for _ in range(4):
        vb = solve_unrolled(m_r, vb[..., None])[..., 0]
        vb = vb / torch.clamp(torch.linalg.norm(vb, dim=-1, keepdim=True),
                              min=1e-30)
    ctrl_c = vb.reshape(vb.shape[:-1] + (4, 3))

    # sign: the reconstructed points in front of the camera (mean z > 0)
    z_mean = torch.sum(
        torch.einsum("...nj,...jc->...nc", alphas, ctrl_c)[..., 2] * weights,
        dim=-1)
    zsign = torch.where(z_mean < 0, -1.0, 1.0).to(ctrl_c.dtype)
    ctrl_c = ctrl_c * zsign[..., None, None]

    # β from distance preservation between control points
    dw = torch.linalg.norm(_pdists(ctrl_w), dim=-1)
    dc = torch.linalg.norm(_pdists(ctrl_c), dim=-1)
    beta = (torch.sum(dw * dc, dim=-1)
            / torch.clamp(torch.sum(dc * dc, dim=-1), min=1e-12))
    ctrl_c = ctrl_c * beta[..., None, None]

    pts_c = torch.einsum("...nj,...jc->...nc", alphas, ctrl_c)
    r, t, _ = rigid_transform_3d(world, pts_c, weights)
    return PnPResult(rotation=r, translation=t)


def pnp_dlt(world: torch.Tensor, pixels: torch.Tensor, k: torch.Tensor,
            weights: Optional[torch.Tensor] = None) -> PnPResult:
    """Direct linear transform PnP (≥ 6 points), batched. The 12×12 null
    vector comes from ``torch.linalg.eigh`` as the reference's from
    ``jnp.linalg.eigh``; on CUDA that call reads its convergence info on
    the host, so DLT waits for the device (it is not on the default
    ``method="epnp"`` path)."""
    if weights is None:
        weights = _ones(world)
    xn = normalize_points(pixels, k)
    x, y, z = world[..., 0], world[..., 1], world[..., 2]
    u, v = xn[..., 0], xn[..., 1]
    ones = torch.ones_like(x)
    zeros = torch.zeros_like(x)
    rx = torch.stack([x, y, z, ones, zeros, zeros, zeros, zeros,
                      -u * x, -u * y, -u * z, -u], dim=-1)
    ry = torch.stack([zeros, zeros, zeros, zeros, x, y, z, ones,
                      -v * x, -v * y, -v * z, -v], dim=-1)
    a = torch.cat([rx, ry], dim=-2)
    a = a * torch.cat([weights, weights], dim=-1)[..., None]
    ata = torch.einsum("...ni,...nj->...ij", a, a)
    _, evecs = torch.linalg.eigh(ata)
    p = evecs[..., :, 0].reshape(world.shape[:-2] + (3, 4))
    # sign: points must have positive depth
    depth = (torch.einsum("...ij,...nj->...ni", p[..., :3], world)[..., 2]
             + p[..., None, 2, 3])
    sgn = torch.sign(torch.sum(torch.sign(depth) * weights, dim=-1))
    sgn = torch.where(sgn == 0, torch.ones_like(sgn), sgn)
    p = p * sgn[..., None, None]
    # orthogonalise R, recover the scale
    um, sm, vtm = svd3(p[..., :3])
    scale = torch.mean(sm, dim=-1)
    det = det3x3(um @ vtm)
    fixd = torch.stack([torch.ones_like(det), torch.ones_like(det), det],
                       dim=-1)
    r = um @ (fixd[..., :, None] * vtm)
    t = p[..., 3] / torch.clamp(scale, min=1e-12)[..., None]
    return PnPResult(rotation=r, translation=t)


def reprojection_residuals(pose: PnPResult, world: torch.Tensor,
                           pixels: torch.Tensor,
                           k: torch.Tensor) -> torch.Tensor:
    """(B-posed) squared pixel reprojection errors (B, N); a point at
    z ≤ 1e-6 scores 1e12."""
    pts_cam = (torch.einsum("...ij,nj->...ni", pose.rotation, world)
               + pose.translation[..., None, :])
    err = torch.sum((_project(pts_cam, k) - pixels) ** 2, dim=-1)
    return torch.where(pts_cam[..., 2] <= 1e-6, torch.full_like(err, 1e12),
                       err)


def solve_pnp_ransac(world, pixels, k, threshold_px: float = 2.0,
                     mask=None, n_hypotheses: int = 256,
                     sample_size: int = 6, lo_iters: int = 2,
                     method: str = "epnp", scoring: str = "msac",
                     refine_iters: int = 10,
                     generator: Optional[torch.Generator] = None,
                     sample_idx=None, device="cuda"
                     ) -> Tuple[PnPResult, torch.Tensor, torch.Tensor]:
    """RANSAC PnP on ``device``: (pose, inlier mask, n_inliers).

    world (N, 3), pixels (N, 2), k (3, 3), mask (N,) valid rows. method
    "epnp" (default), "p3p" or "ap3p" (4-point samples, EPnP-weighted
    refits); scoring "msac" or "magsac". The winner gets ``refine_iters``
    steps of the reprojection LM over its inliers (0 disables), and the
    inliers are taken again from the refined pose. ``generator`` drives
    the draw; ``sample_idx`` (n_hypotheses, sample_size) replaces it, so
    a test can hand in the reference's draw."""
    dev = resolve_device(device)
    world = to_device(world, dev, torch.float32)
    pixels = to_device(pixels, dev, torch.float32)
    k = to_device(k, dev, torch.float32)
    n = world.shape[0]
    mask = (torch.ones(n, dtype=torch.bool, device=dev) if mask is None
            else to_device(mask, dev, torch.bool))
    if sample_idx is not None:
        sample_idx = to_device(sample_idx, dev, torch.int64)

    if method in ("p3p", "ap3p"):
        sample_size = 4
        minimal = pnp_p3p if method == "p3p" else pnp_ap3p

        def solver(a, b, weights=None):
            if weights is not None:          # the refits: weighted EPnP
                return pnp_epnp(a, b, k, weights)
            return minimal(a, b, k)
    elif method == "epnp":
        def solver(a, b, weights=None):
            return pnp_epnp(a, b, k, weights)
    else:
        raise ValueError(f"unknown PnP method {method!r}")

    res = ransac(
        generator, world, pixels, solver_fn=solver,
        residual_fn=lambda m, _a, _b: reprojection_residuals(m, world,
                                                             pixels, k),
        sample_size=sample_size, threshold=threshold_px, mask=mask,
        n_hypotheses=n_hypotheses, lo_iters=lo_iters,
        sample_idx=sample_idx, scoring=scoring)
    pose, inliers, n_inliers = res.model, res.inliers, res.n_inliers
    if refine_iters > 0:
        r_ref, t_ref = refine_pose_reprojection(
            pose.rotation, pose.translation, world, pixels, k, inliers,
            iters=refine_iters, threshold_px=threshold_px, device=dev)
        pose = PnPResult(rotation=r_ref, translation=t_ref)
        sq = reprojection_residuals(pose, world, pixels, k)
        inliers = mask & (sq < threshold_px ** 2)
        n_inliers = torch.sum(inliers)
    return pose, inliers, n_inliers


# ---------------------------------------------------------------------------
# P3P (Grunert) and AP3P: minimal 3-point solvers + 4th-point choice
# ---------------------------------------------------------------------------


def _bearings(pixels: torch.Tensor, k: torch.Tensor):
    """Unit bearing vectors (..., n, 3), 1/(fx, fy) and (cx, cy)."""
    kinv_f = 1.0 / torch.stack([k[..., 0, 0], k[..., 1, 1]], -1)
    pp = torch.stack([k[..., 0, 2], k[..., 1, 2]], -1)
    b = torch.cat([(pixels - pp[..., None, :]) * kinv_f[..., None, :],
                   torch.ones_like(pixels[..., :1])], dim=-1)
    return b / torch.linalg.norm(b, dim=-1, keepdim=True), kinv_f, pp


def _fourth_point_error(r_all, t_all, world, pixels, kinv_f, pp):
    """Squared pixel error of the 4th correspondence under each root's
    pose (..., 4), and its depth."""
    cam4 = (torch.einsum("...rij,...j->...ri", r_all, world[..., 3, :])
            + t_all)
    z4 = _where_small(cam4[..., 2], 1e-9, 1e-9)
    uv4 = cam4[..., :2] / z4[..., None]
    uv4 = uv4 / kinv_f[..., None, :] + pp[..., None, :]
    err4 = torch.sum((uv4 - pixels[..., 3, None, :]) ** 2, dim=-1)
    return err4, z4


def _pick_root(r_all, t_all, err4, ok) -> PnPResult:
    err4 = torch.where(ok, err4, torch.full_like(err4, float("inf")))
    best = torch.argmin(err4, dim=-1)
    r_best = torch.take_along_dim(
        r_all, best[..., None, None, None], dim=-3)[..., 0, :, :]
    t_best = torch.take_along_dim(t_all, best[..., None, None],
                                  dim=-2)[..., 0, :]
    return PnPResult(rotation=r_best, translation=t_best)


def pnp_p3p(world: torch.Tensor, pixels: torch.Tensor, k: torch.Tensor,
            weights: Optional[torch.Tensor] = None) -> PnPResult:
    """Minimal perspective-3-point pose (Grunert's quartic, Haralick's
    formulation), disambiguated by the 4th correspondence. world
    (..., 4, 3), pixels (..., 4, 2): rows 0–2 the minimal set, row 3 picks
    among the ≤ 4 physical solutions. ``weights`` is ignored (the refits
    route through EPnP)."""
    del weights
    f, kinv_f, pp = _bearings(pixels, k)
    f1, f2, f3 = f[..., 0, :], f[..., 1, :], f[..., 2, :]
    p1, p2, p3 = world[..., 0, :], world[..., 1, :], world[..., 2, :]

    a2 = torch.sum((p2 - p3) ** 2, -1)
    b2 = torch.sum((p1 - p3) ** 2, -1)
    c2 = torch.sum((p1 - p2) ** 2, -1)
    b2s = torch.where(b2 < 1e-12, torch.full_like(b2, 1e-12), b2)
    ca = torch.sum(f2 * f3, -1)   # cos α (opposite side a)
    cb = torch.sum(f1 * f3, -1)
    cg = torch.sum(f1 * f2, -1)

    ac = (a2 - c2) / b2s
    ac1 = (a2 + c2) / b2s
    # Grunert/Haralick quartic in v = s3/s1
    a4 = (ac - 1.0) ** 2 - 4.0 * c2 / b2s * ca ** 2
    a3 = 4.0 * (ac * (1.0 - ac) * cb
                - (1.0 - ac1) * ca * cg + 2.0 * c2 / b2s * ca ** 2 * cb)
    a2_ = 2.0 * (ac ** 2 - 1.0 + 2.0 * ac ** 2 * cb ** 2
                 + 2.0 * (b2 - c2) / b2s * ca ** 2
                 - 4.0 * ac1 * ca * cb * cg
                 + 2.0 * (b2 - a2) / b2s * cg ** 2)
    a1 = 4.0 * (-ac * (1.0 + ac) * cb + 2.0 * a2 / b2s * cg ** 2 * cb
                - (1.0 - ac1) * ca * cg)
    a0 = (1.0 + ac) ** 2 - 4.0 * a2 / b2s * cg ** 2

    roots = solve_quartic(torch.stack([a4, a3, a2_, a1, a0], dim=-1))
    is_real = torch.abs(roots.imag) < 1e-4
    v = roots.real
    v_ok = is_real & (v > 1e-6)

    # u = s2/s1 from the linear relation, then the absolute depths
    denom = _where_small(2.0 * (cg[..., None] - v * ca[..., None]), 1e-9,
                         1e-9)
    u = ((-1.0 + ac[..., None]) * v ** 2
         - 2.0 * ac[..., None] * cb[..., None] * v
         + 1.0 + ac[..., None]) / denom
    s1_sq = b2s[..., None] / torch.clamp(
        1.0 + v ** 2 - 2.0 * v * cb[..., None], min=1e-12)
    s1 = torch.sqrt(torch.clamp(s1_sq, min=0.0))
    s2 = u * s1
    s3 = v * s1
    valid = v_ok & (s1 > 0) & (s2 > 0) & (s3 > 0)

    # camera-frame points per root (..., 4 roots, 3 points, 3) → rigid
    # alignment world → camera
    cam_pts = torch.stack([s1[..., :, None] * f1[..., None, :],
                           s2[..., :, None] * f2[..., None, :],
                           s3[..., :, None] * f3[..., None, :]], dim=-2)
    w3 = world[..., None, :3, :].expand(cam_pts.shape)
    r_all, t_all, _ = rigid_transform_3d(w3, cam_pts)
    err4, z4 = _fourth_point_error(r_all, t_all, world, pixels, kinv_f, pp)
    return _pick_root(r_all, t_all, err4, valid & (z4 > 0))


def pnp_ap3p(world: torch.Tensor, pixels: torch.Tensor, k: torch.Tensor,
             weights: Optional[torch.Tensor] = None) -> PnPResult:
    """Algebraic P3P (quartic in cos θ₁' over the intermediate frames the
    bearing and world baselines span), disambiguated by the 4th
    correspondence like :func:`pnp_p3p`, with cheirality of the three
    minimal points."""
    del weights
    f, kinv_f, pp = _bearings(pixels, k)
    b1, b2, b3 = f[..., 0, :], f[..., 1, :], f[..., 2, :]
    w1, w2, w3 = world[..., 0, :], world[..., 1, :], world[..., 2, :]

    def norm(x):
        return torch.clamp(torch.linalg.norm(x, dim=-1, keepdim=True),
                           min=1e-12)

    def dot(a, b):
        return torch.sum(a * b, dim=-1)

    def cross(a, b):
        return torch.linalg.cross(a, b, dim=-1)

    u0 = w1 - w2
    nu0 = norm(u0)[..., 0]
    k1 = u0 / norm(u0)
    k3r = cross(b1, b2)
    nk3 = norm(k3r)[..., 0]
    k3 = k3r / norm(k3r)
    tz = cross(b1, k3)
    v1 = cross(b1, b3)
    v2 = cross(b2, b3)
    u1 = w1 - w3

    u1k1 = dot(u1, k1)
    k3b3 = dot(k3, b3)
    f11 = k3b3
    f13 = dot(k3, v1)
    f15 = -u1k1 * f11
    nl_r = cross(u1, k1)
    delta = norm(nl_r)[..., 0]
    nl = nl_r / norm(nl_r)
    f11 = f11 * delta
    f13 = f13 * delta
    u2k1 = u1k1 - nu0
    f21 = dot(tz, v2)
    f22 = nk3 * k3b3
    f23 = dot(k3, v2)
    f24 = u2k1 * f22
    f25 = -u2k1 * f21
    f21 = f21 * delta
    f22 = f22 * delta
    f23 = f23 * delta

    g1 = f13 * f22
    g2 = f13 * f25 - f15 * f23
    g3 = f11 * f23 - f13 * f21
    g4 = -f13 * f24
    g5 = f11 * f22
    g6 = f11 * f25 - f15 * f21
    g7 = -f15 * f24

    coeffs = torch.stack([
        g5 * g5 + g1 * g1 + g3 * g3,
        2.0 * (g5 * g6 + g1 * g2 + g3 * g4),
        (g6 * g6 + 2.0 * g5 * g7 + g2 * g2 + g4 * g4
         - g1 * g1 - g3 * g3),
        2.0 * (g6 * g7 - g1 * g2 - g3 * g4),
        g7 * g7 - g2 * g2 - g4 * g4,
    ], dim=-1)
    roots = solve_quartic(coeffs)
    ct = roots.real
    scale = torch.clamp(torch.amax(torch.abs(roots), dim=-1, keepdim=True),
                        min=1.0)
    is_real = torch.abs(roots.imag) < 1e-4 * scale

    # 2 Newton polish steps on the real parts
    for _ in range(2):
        err = ((((coeffs[..., 0:1] * ct + coeffs[..., 1:2]) * ct
                 + coeffs[..., 2:3]) * ct + coeffs[..., 3:4]) * ct
               + coeffs[..., 4:5])
        der = (((4.0 * coeffs[..., 0:1] * ct + 3.0 * coeffs[..., 1:2])
                * ct + 2.0 * coeffs[..., 2:3]) * ct + coeffs[..., 3:4])
        ct = ct - err / _where_small(der, 1e-12, 1e-12)

    valid = is_real & (torch.abs(ct) <= 1.0)
    ctc = torch.clamp(ct, -1.0, 1.0)
    st = torch.sqrt(torch.clamp(1.0 - ctc * ctc, min=0.0))
    st = st * torch.where(k3b3 < 0.0, -1.0, 1.0).to(st.dtype)[..., None]

    ct3 = g1[..., None] * ctc + g2[..., None]
    st3 = g3[..., None] * ctc + g4[..., None]
    nt3_den = _where_small((g5[..., None] * ctc + g6[..., None]) * ctc
                           + g7[..., None], 1e-12, 1e-12)
    nt3 = st / nt3_den
    ct3 = ct3 * nt3
    st3 = st3 * nt3

    # C13 rotation per root (..., 4, 3, 3)
    zero = torch.zeros_like(ct3)
    c13 = torch.stack([
        torch.stack([ct3, zero, -st3], -1),
        torch.stack([st * st3, ctc, st * ct3], -1),
        torch.stack([ctc * st3, -st, ctc * ct3], -1),
    ], dim=-2)
    ck1nl = torch.stack([k1, nl, cross(k1, nl)], dim=-1)   # columns
    cb1k3tz = torch.stack([b1, k3, tz], dim=-2)            # rows
    r_cw = torch.einsum("...ij,...rjk,...kl->...ril", ck1nl, c13, cb1k3tz)
    # world → camera: R = r_cwᵀ, t = s(θ₁')·(δ/k3·b3)·b3 − r_cwᵀ w3
    b3p = (delta / _where_small(k3b3, 1e-12, 1e-12))[..., None] * b3
    rp3 = torch.einsum("...rij,...i->...rj", r_cw, w3)
    t_all = st[..., None] * b3p[..., None, :] - rp3
    r_all = r_cw.transpose(-1, -2)

    err4, z4 = _fourth_point_error(r_all, t_all, world, pixels, kinv_f, pp)
    cam123 = (torch.einsum("...rij,...pj->...rpi", r_all, world[..., :3, :])
              + t_all[..., None, :])
    che = torch.all(cam123[..., 2] > 0, dim=-1)
    return _pick_root(r_all, t_all, err4, valid & che & (z4 > 0))
