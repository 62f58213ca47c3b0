"""Small dense linear algebra (port of kornia_tpu/geometry/linalg.py).

Batched closed forms, as in the reference: no LAPACK call and nothing that
waits on the device, so the tracking step can run them on the card without
a host synchronisation. float32 throughout.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch


def _eye3(like: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=like.dtype, device=like.device)


def det3x3(m: torch.Tensor) -> torch.Tensor:
    """Closed-form determinant of (..., 3, 3), first-row expansion. The
    reference calls ``jnp.linalg.det`` (LU) where the port calls this; on
    the orthonormal matrices it is used for the two agree in sign and to
    a few ULPs in value, and ``torch.linalg.det`` is not needed on the
    card."""
    return (m[..., 0, 0] * (m[..., 1, 1] * m[..., 2, 2]
                            - m[..., 1, 2] * m[..., 2, 1])
            - m[..., 0, 1] * (m[..., 1, 0] * m[..., 2, 2]
                              - m[..., 1, 2] * m[..., 2, 0])
            + m[..., 0, 2] * (m[..., 1, 0] * m[..., 2, 1]
                              - m[..., 1, 1] * m[..., 2, 0]))


def _unit(v: torch.Tensor) -> torch.Tensor:
    return v / torch.clamp(torch.linalg.norm(v, dim=-1, keepdim=True),
                           min=1e-30)


def eigh3x3(s: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full closed-form eigendecomposition of symmetric (..., 3, 3):
    (evals ascending (..., 3), evecs (..., 3, 3) columns). Cardano roots
    and Cayley–Hamilton column extraction; the middle vector is the cross
    product, so one repeated pair is handled."""
    q = torch.diagonal(s, dim1=-2, dim2=-1).sum(-1) / 3.0
    p1 = s[..., 0, 1] ** 2 + s[..., 0, 2] ** 2 + s[..., 1, 2] ** 2
    dif = torch.stack([s[..., 0, 0] - q, s[..., 1, 1] - q,
                       s[..., 2, 2] - q], dim=-1)
    p2 = torch.sum(dif * dif, dim=-1) + 2.0 * p1
    p = torch.sqrt(torch.clamp(p2 / 6.0, min=1e-30))
    eye = _eye3(s)
    b = (s - q[..., None, None] * eye) / p[..., None, None]
    r = torch.clamp(det3x3(b) / 2.0, -1.0, 1.0)
    phi = torch.arccos(r) / 3.0
    lam1 = q + 2.0 * p * torch.cos(phi)                        # largest
    lam3 = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)  # smallest
    lam2 = 3.0 * q - lam1 - lam3
    e0 = eye[0]

    def extract(la, lb):
        # columns of (S − λa)(S − λb) ∝ the remaining eigenvector
        m = ((s - la[..., None, None] * eye)
             @ (s - lb[..., None, None] * eye))
        nrm2 = torch.sum(m * m, dim=-2)
        j = torch.argmax(nrm2, dim=-1)
        col = torch.take_along_dim(
            m, j[..., None, None].expand(m.shape[:-1] + (1,)),
            dim=-1)[..., 0]
        col = torch.where((p2 > 1e-24)[..., None], col, e0)
        return _unit(col)

    v3 = extract(lam1, lam2)         # smallest
    v1 = extract(lam2, lam3)         # largest (any vector ⊥ v3 when λ1≈λ2)
    v1 = v1 - torch.sum(v1 * v3, dim=-1, keepdim=True) * v3
    n1 = torch.linalg.norm(v1, dim=-1, keepdim=True)
    v1 = torch.where(n1 > 1e-6, v1 / torch.clamp(n1, min=1e-30), _perp(v3))
    v2 = _unit(torch.linalg.cross(v3, v1, dim=-1))
    evecs = torch.stack([v3, v2, v1], dim=-1)   # columns, ascending
    evals = torch.stack([lam3, lam2, lam1], dim=-1)
    return evals, evecs


def _perp(v: torch.Tensor) -> torch.Tensor:
    """A unit vector orthogonal to each (..., 3) unit vector."""
    eye = _eye3(v)
    alt = torch.where(torch.abs(v[..., 0:1]) < 0.9, eye[0], eye[1])
    return _unit(torch.linalg.cross(v, alt, dim=-1))


def svd3(m: torch.Tensor
         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Batched closed-form 3×3 SVD (descending σ): (u, s, vt). V from
    eigh3x3(MᵀM), σ = √λ, U = MVΣ⁻¹ with rank fallbacks (a column whose σ
    is below 1e-3 σ₀ is rebuilt orthogonally)."""
    mtm = m.transpose(-1, -2) @ m
    evals, v = eigh3x3(mtm)
    sig = torch.sqrt(torch.clamp(torch.flip(evals, dims=[-1]), min=0.0))
    v = torch.flip(v, dims=[-1])                          # columns desc
    u = m @ v
    s0 = torch.clamp(sig[..., 0], min=1e-20)
    u1 = _unit(u[..., 0] / torch.clamp(sig[..., 0:1], min=1e-20))
    u2 = u[..., 1] / torch.clamp(sig[..., 1:2], min=1e-20)
    u2 = u2 - torch.sum(u2 * u1, dim=-1, keepdim=True) * u1
    n2 = torch.linalg.norm(u2, dim=-1, keepdim=True)
    ok2 = (sig[..., 1] > 1e-3 * s0)[..., None] & (n2 > 1e-6)
    u2 = torch.where(ok2, u2 / torch.clamp(n2, min=1e-30), _perp(u1))
    u3_direct = u[..., 2] / torch.clamp(sig[..., 2:3], min=1e-20)
    u3_cross = torch.linalg.cross(u1, u2, dim=-1)
    healthy3 = (sig[..., 2] > 1e-3 * s0)[..., None]
    u3 = _unit(torch.where(healthy3, u3_direct, u3_cross))
    u = torch.stack([u1, u2, u3], dim=-1)
    return u, sig, v.transpose(-1, -2)


def _sign_tiny(det: torch.Tensor) -> torch.Tensor:
    """det with |det| < 1e-30 replaced by ±1e-30 (the sign kept)."""
    tiny = torch.where(det < 0, torch.full_like(det, -1e-30),
                       torch.full_like(det, 1e-30))
    return torch.where(torch.abs(det) < 1e-30, tiny, det)


def inv4x4(m: torch.Tensor) -> torch.Tensor:
    """Closed-form adjugate inverse of (..., 4, 4)."""

    def det3(r, c):
        r0, r1, r2 = r
        c0, c1, c2 = c
        return (m[..., r0, c0] * (m[..., r1, c1] * m[..., r2, c2]
                                  - m[..., r1, c2] * m[..., r2, c1])
                - m[..., r0, c1] * (m[..., r1, c0] * m[..., r2, c2]
                                    - m[..., r1, c2] * m[..., r2, c0])
                + m[..., r0, c2] * (m[..., r1, c0] * m[..., r2, c1]
                                    - m[..., r1, c1] * m[..., r2, c0]))

    idx = [0, 1, 2, 3]
    cols = []
    for j in range(4):
        col = []
        for i in range(4):
            rows3 = tuple(r for r in idx if r != j)
            cols3 = tuple(c for c in idx if c != i)
            col.append(((-1.0) ** (i + j)) * det3(rows3, cols3))
        cols.append(torch.stack(col, dim=-1))
    adj = torch.stack(cols, dim=-1)                        # (..., 4, 4)
    det = sum(m[..., 0, j] * adj[..., j, 0] for j in range(4))
    return adj / _sign_tiny(det)[..., None, None]


def rigid_transform_3d(src: torch.Tensor, dst: torch.Tensor,
                       weights: torch.Tensor | None = None,
                       with_scale: bool = False
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Umeyama/Kabsch: weighted least-squares (R, t, s) with
    dst ≈ s·R·src + t. src, dst (..., N, 3), weights (..., N) or None →
    R (..., 3, 3), t (..., 3), s (...). The reference takes one (N, 3) set
    and vmaps; here the leading dims are the batch. The reflection sign
    comes from closed-form determinants (:func:`det3x3`)."""
    if weights is None:
        weights = torch.ones(src.shape[:-1], dtype=src.dtype,
                             device=src.device)
    w = weights / torch.clamp(torch.sum(weights, dim=-1, keepdim=True),
                              min=1e-12)
    mu_s = torch.sum(src * w[..., None], dim=-2)
    mu_d = torch.sum(dst * w[..., None], dim=-2)
    sc = src - mu_s[..., None, :]
    dc = dst - mu_d[..., None, :]
    cov = torch.einsum("...ni,...nj->...ij", dc * w[..., None], sc)
    u, s, vt = svd3(cov)
    d = torch.sign(det3x3(u) * det3x3(vt))
    ones = torch.ones_like(d)
    diag = torch.stack([ones, ones, d], dim=-1)
    r = (u * diag[..., None, :]) @ vt
    if with_scale:
        var_s = torch.sum(w * torch.sum(sc * sc, dim=-1), dim=-1)
        scale = torch.sum(s * diag, dim=-1) / torch.clamp(var_s, min=1e-12)
    else:
        scale = torch.ones_like(d)
    t = mu_d - scale[..., None] * (r @ mu_s[..., None])[..., 0]
    return r, t, scale


def solve_cholesky(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """SPD solve via Cholesky; b is (..., n) or (..., n, k). A matrix that
    is not positive definite gives NaN, as jnp.linalg.cholesky does, and
    nothing waits on the device to find out."""
    l, info = torch.linalg.cholesky_ex(a)
    l = torch.where((info == 0)[..., None, None], l,
                    torch.full_like(l, float("nan")))
    vec = b.ndim == a.ndim - 1
    bb = b[..., None] if vec else b
    y = torch.linalg.solve_triangular(l, bb, upper=False)
    x = torch.linalg.solve_triangular(l.transpose(-1, -2), y, upper=True)
    return x[..., 0] if vec else x


def solve_cholesky_damped(a: torch.Tensor, b: torch.Tensor,
                          damping) -> torch.Tensor:
    """LM-style (A + λ·diag(diag(A))) x = b (batched over leading dims)."""
    d = torch.diagonal(a, dim1=-2, dim2=-1)
    eye = torch.eye(a.shape[-1], dtype=a.dtype, device=a.device)
    a_damped = a + eye * (damping * torch.clamp(d, min=1e-12))[..., None, :]
    return solve_cholesky(a_damped, b)


def inv3x3(m: torch.Tensor) -> torch.Tensor:
    """Closed-form adjugate inverse of (..., 3, 3)."""
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    co_a = e * i - f * h
    co_b = f * g - d * i
    co_c = d * h - e * g
    det = a * co_a + b * co_b + c * co_c
    adj = torch.stack([
        co_a, c * h - b * i, b * f - c * e,
        co_b, a * i - c * g, c * d - a * f,
        co_c, b * g - a * h, a * e - b * d,
    ], dim=-1).reshape(m.shape)
    return adj / _sign_tiny(det)[..., None, None]


def hnormalize(x: torch.Tensor) -> torch.Tensor:
    """Homogeneous → euclidean: divide by the last coordinate."""
    z = x[..., -1:]
    return x[..., :-1] / torch.where(torch.abs(z) < 1e-12,
                                     torch.full_like(z, 1e-12), z)


def homogenize(x: torch.Tensor) -> torch.Tensor:
    return torch.cat([x, torch.ones_like(x[..., :1])], dim=-1)


def transform_points(m: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply a (4, 4) (or batched) matrix to (..., 3) points."""
    return (torch.einsum("...ij,...nj->...ni", m[..., :3, :3], pts)
            + m[..., None, :3, 3])


def _where_small(x: torch.Tensor, lim: float, fill) -> torch.Tensor:
    return torch.where(torch.abs(x) < lim, torch.full_like(x, fill), x)


def solve_quartic(coeffs: torch.Tensor) -> torch.Tensor:
    """Closed-form (Ferrari) roots of a₄x⁴+a₃x³+a₂x²+a₁x+a₀: coeffs
    (..., 5) real, highest degree first → (..., 4) complex64 roots, with
    two Newton polish steps, all elementwise (no companion-matrix eig)."""
    c = coeffs.to(torch.complex64)
    a4 = _where_small(c[..., 0], 1e-12, 1e-12)
    p3 = c[..., 1] / a4
    q2 = c[..., 2] / a4
    r1 = c[..., 3] / a4
    s0 = c[..., 4] / a4

    # depressed quartic y⁴ + αy² + βy + γ, x = y − p3/4
    alpha = q2 - 3.0 * p3 * p3 / 8.0
    beta = r1 - p3 * q2 / 2.0 + p3 ** 3 / 8.0
    gamma = (s0 - 3.0 * p3 ** 4 / 256.0 + p3 * p3 * q2 / 16.0
             - p3 * r1 / 4.0)

    # resolvent cubic z³ + 2αz² + (α²−4γ)z − β² = 0; take one root
    b2 = 2.0 * alpha
    b1 = alpha * alpha - 4.0 * gamma
    b0 = -beta * beta
    pp = b1 - b2 * b2 / 3.0
    qq = 2.0 * b2 ** 3 / 27.0 - b2 * b1 / 3.0 + b0
    disc = (qq / 2.0) ** 2 + (pp / 3.0) ** 3
    sq = torch.sqrt(disc)
    u3 = -qq / 2.0 + sq
    zero = torch.zeros_like(u3)
    # principal cube root; 0^(1/3) would be NaN
    u = torch.where(torch.abs(u3) < 1e-30, zero, u3 ** (1.0 / 3.0))
    v = torch.where(torch.abs(u) < 1e-30, zero, -pp / (3.0 * u))
    z = u + v - b2 / 3.0

    # split into two quadratics: y² ∓ y√z + (α+z)/2 ± β/(2√z)
    w = torch.sqrt(z)
    w_safe = _where_small(w, 1e-12, 1e-12)
    t1 = (alpha + z) / 2.0
    t2 = beta / (2.0 * w_safe)

    def quad_roots(b, cc):
        d = torch.sqrt(b * b - 4.0 * cc)
        return (-b + d) / 2.0, (-b - d) / 2.0

    y1, y2 = quad_roots(w, t1 - t2)
    y3, y4 = quad_roots(-w, t1 + t2)
    roots = torch.stack([y1, y2, y3, y4], dim=-1) - (p3 / 4.0)[..., None]

    cc = c[..., None, :]
    for _ in range(2):
        x = roots
        p = (((cc[..., 0] * x + cc[..., 1]) * x + cc[..., 2]) * x
             + cc[..., 3]) * x + cc[..., 4]
        dp = ((4.0 * cc[..., 0] * x + 3.0 * cc[..., 1]) * x
              + 2.0 * cc[..., 2]) * x + cc[..., 3]
        roots = x - p / _where_small(dp, 1e-12, 1e-12)
    return roots


def _pivot(aug: torch.Tensor, c: int, rows: torch.Tensor,
           e_c: torch.Tensor):
    """Partial pivoting at column ``c``: (aug with rows c and p swapped,
    p == c)."""
    col = aug[..., :, c]
    cand = torch.where(rows >= c, torch.abs(col), torch.full_like(col, -1.0))
    p = torch.argmax(cand, dim=-1)
    e_p = (rows == p[..., None]).to(aug.dtype)
    row_c = aug[..., c, :]
    row_p = torch.einsum("...r,...rk->...k", e_p, aug)
    aug = (aug
           - e_c[:, None] * (row_c - row_p)[..., None, :]
           - e_p[..., None] * (row_p - row_c)[..., None, :])
    return aug, p == c


def solve_unrolled(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve a x = b for small static n by unrolled partial-pivot
    Gauss-Jordan, elementwise selects over the batch: a (..., n, n),
    b (..., n, k) → (..., n, k)."""
    n = a.shape[-1]
    aug = torch.cat([a, b], dim=-1)                       # (..., n, n+k)
    rows = torch.arange(n, device=a.device)
    eye = torch.eye(n, dtype=a.dtype, device=a.device)
    for c in range(n):
        e_c = eye[c]
        aug, _ = _pivot(aug, c, rows, e_c)
        piv = aug[..., c, c]
        safe = torch.where(torch.abs(piv) > 1e-30, piv,
                           torch.where(piv < 0, torch.full_like(piv, -1e-30),
                                       torch.full_like(piv, 1e-30)))
        pivot_row = aug[..., c, :] / safe[..., None]
        factor = aug[..., :, c] * (1.0 - e_c)             # eliminate all ≠ c
        aug = aug - factor[..., None] * pivot_row[..., None, :]
        aug = aug - e_c[:, None] * (aug[..., c, :] - pivot_row)[..., None, :]
    return aug[..., :, n:]


def det_unrolled(a: torch.Tensor) -> torch.Tensor:
    """Determinant of small static-n (..., n, n) matrices by unrolled
    partial-pivot Gaussian elimination, elementwise selects over the
    batch; the sign of the row swaps is tracked."""
    n = a.shape[-1]
    aug = a
    rows = torch.arange(n, device=a.device)
    eye = torch.eye(n, dtype=a.dtype, device=a.device)
    det = torch.ones(a.shape[:-2], dtype=a.dtype, device=a.device)
    for c in range(n):
        aug, same = _pivot(aug, c, rows, eye[c])
        det = det * torch.where(same, 1.0, -1.0).to(a.dtype)
        piv = aug[..., c, c]
        det = det * piv
        safe = torch.where(torch.abs(piv) > 1e-30, piv,
                           torch.where(piv < 0, torch.full_like(piv, -1e-30),
                                       torch.full_like(piv, 1e-30)))
        factor = aug[..., :, c] / safe[..., None]
        factor = factor * (rows > c).to(a.dtype)
        aug = aug - factor[..., None] * aug[..., c, :][..., None, :]
    return det
