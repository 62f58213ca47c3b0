"""Epipolar geometry: fundamental / essential / homography estimation
(port of kornia_tpu/geometry/epipolar.py).

Every solver is batched over minimal samples: RANSAC calls them with
(B, 8, 2) point sets and gets (B, 3, 3) models back. Minimal systems take
the closed-form Cramer null vector; over-determined ones (the weighted
local-optimisation refits) ``torch.linalg.eigh`` of AᵀA, where the JAX
package calls ``jnp.linalg.eigh``.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from kornia_tpu_torch.geometry.linalg import det_unrolled, homogenize, inv3x3


def _nullvec_cramer(a: torch.Tensor) -> torch.Tensor:
    """Exact null vector of a minimal (..., n, n+1) system by Cramer:
    v_j = (−1)^j det(A with column j dropped)."""
    d = a.shape[-1]
    minors = torch.stack(
        [a[..., :, [c for c in range(d) if c != j]] for j in range(d)],
        dim=-3)                                    # (..., d, n, n)
    dets = det_unrolled(minors)                    # (..., d)
    signs = torch.tensor([(-1.0) ** j for j in range(d)], dtype=a.dtype,
                         device=a.device)
    v = dets * signs
    nrm = torch.linalg.norm(v, dim=-1, keepdim=True)
    return v / torch.clamp(nrm, min=1e-30)


def _eigvec_min_sym3(s: torch.Tensor) -> torch.Tensor:
    """Smallest-eigenvalue unit eigenvector of symmetric (..., 3, 3),
    closed form (Cardano roots + Cayley–Hamilton column extraction)."""
    q = torch.diagonal(s, dim1=-2, dim2=-1).sum(-1) / 3.0
    p1 = s[..., 0, 1] ** 2 + s[..., 0, 2] ** 2 + s[..., 1, 2] ** 2
    dif = torch.stack([s[..., 0, 0] - q, s[..., 1, 1] - q,
                       s[..., 2, 2] - q], dim=-1)
    p2 = torch.sum(dif * dif, dim=-1) + 2.0 * p1
    p = torch.sqrt(torch.clamp(p2 / 6.0, min=1e-30))
    eye = torch.eye(3, dtype=s.dtype, device=s.device)
    b = (s - q[..., None, None] * eye) / p[..., None, None]
    det_b = (b[..., 0, 0] * (b[..., 1, 1] * b[..., 2, 2]
                             - b[..., 1, 2] * b[..., 2, 1])
             - b[..., 0, 1] * (b[..., 1, 0] * b[..., 2, 2]
                               - b[..., 1, 2] * b[..., 2, 0])
             + b[..., 0, 2] * (b[..., 1, 0] * b[..., 2, 1]
                               - b[..., 1, 1] * b[..., 2, 0]))
    r = torch.clamp(det_b / 2.0, -1.0, 1.0)
    phi = torch.arccos(r) / 3.0
    lam1 = q + 2.0 * p * torch.cos(phi)                       # largest
    lam3 = q + 2.0 * p * torch.cos(phi + 2.0 * np.pi / 3.0)   # smallest
    lam2 = 3.0 * q - lam1 - lam3
    m = ((s - lam1[..., None, None] * eye)
         @ (s - lam2[..., None, None] * eye))   # columns ∝ v_min
    nrm2 = torch.sum(m * m, dim=-2)
    j = torch.argmax(nrm2, dim=-1)
    col = torch.take_along_dim(
        m, j[..., None, None].expand(m.shape[:-1] + (1,)), dim=-1)[..., 0]
    e0 = torch.tensor([1.0, 0.0, 0.0], dtype=s.dtype, device=s.device)
    col = torch.where((p2 > 1e-24)[..., None], col, e0)
    return col / torch.clamp(torch.linalg.norm(col, dim=-1, keepdim=True),
                             min=1e-30)


def _nullvec(a: torch.Tensor) -> torch.Tensor:
    """Smallest right-singular vector of (..., N, D): Cramer for minimal
    systems (N == D−1), eigh of AᵀA otherwise."""
    if a.shape[-2] == a.shape[-1] - 1:
        return _nullvec_cramer(a)
    ata = torch.einsum("...ni,...nj->...ij", a, a)
    _, evecs = torch.linalg.eigh(ata)   # ascending eigenvalues
    return evecs[..., :, 0]


def normalize_points2d(pts: torch.Tensor, mask: torch.Tensor | None = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Hartley normalization: zero mean, mean distance √2. Returns
    (pts_norm, T (..., 3, 3)) with pts_norm = T · pts."""
    if mask is None:
        w = torch.ones(pts.shape[:-1], dtype=pts.dtype, device=pts.device)
    else:
        w = mask.to(pts.dtype)
    wsum = torch.clamp(torch.sum(w, dim=-1, keepdim=True), min=1e-12)
    mean = torch.sum(pts * w[..., None], dim=-2, keepdim=True) / wsum[..., None]
    centered = (pts - mean) * w[..., None]
    d = torch.sqrt(torch.sum(centered * centered, dim=-1))
    mean_d = torch.sum(d, dim=-1, keepdim=True) / wsum
    scale = math.sqrt(2.0) / torch.clamp(mean_d, min=1e-12)
    s = scale[..., 0]
    mx = mean[..., 0, 0]
    my = mean[..., 0, 1]
    zero = torch.zeros_like(s)
    one = torch.ones_like(s)
    t = torch.stack([s, zero, -s * mx, zero, s, -s * my, zero, zero, one],
                    dim=-1).reshape(pts.shape[:-2] + (3, 3))
    pn = (pts - mean) * scale[..., None]
    return pn, t


def fundamental_8pt(x1: torch.Tensor, x2: torch.Tensor,
                    weights: torch.Tensor | None = None) -> torch.Tensor:
    """(..., N≥8, 2) correspondences → (..., 3, 3) F with x2ᵀ F x1 = 0,
    rank 2, unit Frobenius norm."""
    p1, t1 = normalize_points2d(x1, weights)
    p2, t2 = normalize_points2d(x2, weights)
    u1, v1 = p1[..., 0], p1[..., 1]
    u2, v2 = p2[..., 0], p2[..., 1]
    ones = torch.ones_like(u1)
    a = torch.stack([u2 * u1, u2 * v1, u2, v2 * u1, v2 * v1, v2, u1, v1,
                     ones], dim=-1)
    if weights is not None:
        a = a * weights[..., None]
    f = _nullvec(a).reshape(x1.shape[:-2] + (3, 3))
    # rank-2 projection F(I − v₃v₃ᵀ), v₃ the smallest eigenvector of FᵀF
    v3 = _eigvec_min_sym3(f.transpose(-1, -2) @ f)
    f = f - (f @ v3[..., :, None]) * v3[..., None, :]
    f = t2.transpose(-1, -2) @ f @ t1
    norm = torch.linalg.norm(f.reshape(f.shape[:-2] + (9,)), dim=-1)
    return f / torch.clamp(norm, min=1e-12)[..., None, None]


def essential_from_fundamental(f: torch.Tensor, k1: torch.Tensor,
                               k2: torch.Tensor) -> torch.Tensor:
    """E = K2ᵀ F K1 with singular values projected to (1, 1, 0)."""
    e = k2.transpose(-1, -2) @ f @ k1
    u, s, vt = torch.linalg.svd(e)
    s_proj = torch.stack([torch.ones_like(s[..., 0]), torch.ones_like(s[..., 0]),
                          torch.zeros_like(s[..., 0])], dim=-1)
    return u @ (s_proj[..., :, None] * vt)


def sampson_distance(f: torch.Tensor, x1: torch.Tensor,
                     x2: torch.Tensor) -> torch.Tensor:
    """First-order geometric (Sampson) distance², pixels²; a (near-)zero F
    is a rejection (1e12), not a perfect fit."""
    p1 = homogenize(x1)
    p2 = homogenize(x2)
    fx1 = torch.einsum("...ij,...nj->...ni", f, p1)
    ftx2 = torch.einsum("...ji,...nj->...ni", f, p2)
    num = torch.sum(p2 * fx1, dim=-1) ** 2
    den = (fx1[..., 0] ** 2 + fx1[..., 1] ** 2 + ftx2[..., 0] ** 2
           + ftx2[..., 1] ** 2)
    return torch.where(den > 1e-12, num / torch.clamp(den, min=1e-12),
                       torch.full_like(den, 1e12))


def epipolar_distance(f: torch.Tensor, x1: torch.Tensor,
                      x2: torch.Tensor) -> torch.Tensor:
    """Symmetric point-to-epiline distance², the mean of the squared
    distances of x2 to F·x1 and of x1 to Fᵀ·x2."""
    p1 = homogenize(x1)
    p2 = homogenize(x2)
    fx1 = torch.einsum("...ij,...nj->...ni", f, p1)
    ftx2 = torch.einsum("...ji,...nj->...ni", f, p2)
    dot = torch.sum(p2 * fx1, dim=-1) ** 2
    d1 = dot / torch.clamp(fx1[..., 0] ** 2 + fx1[..., 1] ** 2, min=1e-12)
    d2 = dot / torch.clamp(ftx2[..., 0] ** 2 + ftx2[..., 1] ** 2, min=1e-12)
    return 0.5 * (d1 + d2)


_W = torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]])


def decompose_essential(e: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """E → the four (R, t) candidates [R1|t], [R1|−t], [R2|t], [R2|−t]:
    (4, ..., 3, 3) rotations and (4, ..., 3) unit translations."""
    u, _, vt = torch.linalg.svd(e)
    du = torch.sign(torch.linalg.det(u))[..., None, None]
    dv = torch.sign(torch.linalg.det(vt))[..., None, None]
    u = u * du
    vt = vt * dv
    w = _W.to(dtype=e.dtype, device=e.device)
    r1 = u @ w @ vt
    r2 = u @ w.T @ vt
    t = u[..., :, 2]
    tn = t / torch.clamp(torch.linalg.norm(t, dim=-1, keepdim=True),
                         min=1e-12)
    return torch.stack([r1, r1, r2, r2]), torch.stack([tn, -tn, tn, -tn])


def homography_dlt(x1: torch.Tensor, x2: torch.Tensor,
                   weights: torch.Tensor | None = None) -> torch.Tensor:
    """(..., N≥4, 2) → (..., 3, 3) H with x2 ~ H x1, H[2, 2] = 1."""
    p1, t1 = normalize_points2d(x1, weights)
    p2, t2 = normalize_points2d(x2, weights)
    u1, v1 = p1[..., 0], p1[..., 1]
    u2, v2 = p2[..., 0], p2[..., 1]
    ones = torch.ones_like(u1)
    zeros = torch.zeros_like(u1)
    ax = torch.stack([-u1, -v1, -ones, zeros, zeros, zeros, u2 * u1,
                      u2 * v1, u2], dim=-1)
    ay = torch.stack([zeros, zeros, zeros, -u1, -v1, -ones, v2 * u1,
                      v2 * v1, v2], dim=-1)
    a = torch.cat([ax, ay], dim=-2)   # (..., 2N, 9)
    if weights is not None:
        w2 = torch.cat([weights, weights], dim=-1)
        a = a * w2[..., None]
    h = _nullvec(a).reshape(x1.shape[:-2] + (3, 3))
    h = inv3x3(t2) @ h @ t1
    h22 = h[..., 2:3, 2:3]
    return h / torch.where(torch.abs(h22) < 1e-12,
                           torch.full_like(h22, 1e-12), h22)


def _dehom(p: torch.Tensor) -> torch.Tensor:
    z = p[..., 2:]
    return p[..., :2] / torch.where(torch.abs(z) < 1e-12,
                                    torch.full_like(z, 1e-12), z)


def homography_transfer_error(h: torch.Tensor, x1: torch.Tensor,
                              x2: torch.Tensor) -> torch.Tensor:
    """Symmetric transfer error², pixels²."""
    hx1 = torch.einsum("...ij,...nj->...ni", h, homogenize(x1))
    e_fwd = torch.sum((_dehom(hx1) - x2) ** 2, dim=-1)
    hx2 = torch.einsum("...ij,...nj->...ni", inv3x3(h), homogenize(x2))
    e_bwd = torch.sum((_dehom(hx2) - x1) ** 2, dim=-1)
    return 0.5 * (e_fwd + e_bwd)


def decompose_homography(h: torch.Tensor, k1: torch.Tensor,
                         k2: torch.Tensor):
    """Calibrated H = R + t·nᵀ → its 4 (R, t, n) candidates (Ma/Soatto
    Algorithm 5.2): (4, ..., 3, 3), (4, ..., 3), (4, ..., 3)."""
    hn = torch.linalg.inv(k2) @ h @ k1
    det = torch.linalg.det(hn)
    hn = hn * torch.sign(det)[..., None, None]
    s = torch.linalg.svdvals(hn)
    hn = hn / s[..., 1:2, None]
    a_mat = hn.transpose(-1, -2) @ hn
    evals, evecs = torch.linalg.eigh(a_mat)   # ascending
    s3sq = torch.clamp(evals[..., 0], min=0.0)
    s1sq = torch.clamp(evals[..., 2], min=0.0)
    v3 = evecs[..., :, 0]
    v2 = evecs[..., :, 1]
    v1 = evecs[..., :, 2]
    denom = torch.sqrt(torch.clamp(s1sq - s3sq, min=1e-12))[..., None]
    a = torch.sqrt(torch.clamp(1.0 - s3sq, min=0.0))[..., None]
    b = torch.sqrt(torch.clamp(s1sq - 1.0, min=0.0))[..., None]
    u1 = (a * v1 + b * v3) / denom
    u2 = (a * v1 - b * v3) / denom

    def frame(u):
        c = torch.linalg.cross(v2, u, dim=-1)
        um = torch.stack([v2, u, c], dim=-1)
        hv2 = torch.einsum("...ij,...j->...i", hn, v2)
        hu = torch.einsum("...ij,...j->...i", hn, u)
        wm = torch.stack([hv2, hu, torch.linalg.cross(hv2, hu, dim=-1)],
                         dim=-1)
        r = wm @ um.transpose(-1, -2)
        t = torch.einsum("...ij,...j->...i", hn - r, c)
        return r, t, c

    r1, t1, n1 = frame(u1)
    r2, t2, n2 = frame(u2)
    return (torch.stack([r1, r1, r2, r2]), torch.stack([t1, -t1, t2, -t2]),
            torch.stack([n1, -n1, n2, -n2]))
