"""Nistér's five-point essential matrix, batched (port of
kornia_tpu/geometry/essential5pt.py).

The same numerical recipe as the reference, step for step:

1. a basis of the null space of the 5×9 epipolar constraint, by projecting
   a fixed (9, 4) seed through I − Qᵀ(QQᵀ)⁻¹Q and Gram-Schmidt
   (E = x·E1 + y·E2 + z·E3 + E4);
2. the coefficients of the ten cubic constraints, from their values at 20
   fixed sample points times the inverse 20×20 monomial Vandermonde;
3. z hidden: det C(z) of the 10×10 C(z) sampled at 16 Chebyshev nodes and
   fitted to Nistér's degree-10 polynomial;
4. its roots by 80 fixed Durand-Kerner steps in complex64; real roots
   kept;
5. per root, the null vector of C(z) by three rounds of ridged inverse
   iteration → (x, y) → an E candidate, the best chosen on the sixth and
   later correspondences by Sampson error.

Every step is a fixed-shape batched tensor program: nothing is read back
to the host.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from kornia_tpu_torch.geometry.epipolar import sampson_distance
from kornia_tpu_torch.geometry.linalg import (det3x3, det_unrolled,
                                              homogenize, solve_unrolled)

# all (i, j, k) with i + j + k <= 3: x^i y^j z^k
_MONOS = [(i, j, k)
          for i in range(4) for j in range(4 - i) for k in range(4 - i - j)]
# xy-monomials (i, j), i + j <= 3: the 10-dim basis m(x, y)
_XY = [(3, 0), (2, 1), (1, 2), (0, 3), (2, 0),
       (1, 1), (0, 2), (1, 0), (0, 1), (0, 0)]
_X_IDX = _XY.index((1, 0))
_Y_IDX = _XY.index((0, 1))
_1_IDX = _XY.index((0, 0))

# fixed evaluation points for the coefficient extraction (float64 on the
# host, the reference's seed and order)
_SAMPLES = np.random.default_rng(12345).uniform(-1.0, 1.0, (20, 3))
_VAND = np.stack([
    [s[0] ** i * s[1] ** j * s[2] ** k for (i, j, k) in _MONOS]
    for s in _SAMPLES
])
_VAND_INV = np.linalg.inv(_VAND)

# 16 Chebyshev z-nodes (scaled by 2) and the least-squares fit of the 11
# coefficients (degree 0..10) from the samples
_ZNODES = np.cos(np.pi * (2 * np.arange(16) + 1) / 32.0) * 2.0
_ZFIT = np.linalg.pinv(np.stack([_ZNODES ** d for d in range(11)], axis=1))

# each of the 20 (i, j, k) monomials → its xy-basis index and z power
_M_TO_XY = np.array([_XY.index((i, j)) for (i, j, k) in _MONOS])
_M_TO_ZP = np.array([k for (i, j, k) in _MONOS])

# the fixed (9, 4) seed of the null-space projection
_R_FIXED = np.linalg.qr(np.random.default_rng(11).standard_normal((9, 4))
                        )[0].astype(np.float32)


_CONSTS = {"samples": _SAMPLES, "vand_inv": _VAND_INV, "znodes": _ZNODES,
           "zfit": _ZFIT, "zexp": _M_TO_ZP, "r_fixed": _R_FIXED,
           "sel": np.eye(10)[_M_TO_XY]}


@functools.lru_cache(maxsize=None)
def _const_on(name: str, device: torch.device) -> torch.Tensor:
    """A constant of the solver as float32 on ``device``, made once per
    device (an upload waits for the device)."""
    return torch.as_tensor(np.asarray(_CONSTS[name], np.float32)).to(device)


def _const(name: str, like: torch.Tensor) -> torch.Tensor:
    return _const_on(name, like.device)


def _constraints(e: torch.Tensor) -> torch.Tensor:
    """The 10 cubic constraints of (..., 3, 3) candidates:
    [det(E); vec(2EEᵀE − tr(EEᵀ)E)]."""
    det = det3x3(e)
    eet = e @ e.transpose(-1, -2)
    tr = torch.diagonal(eet, dim1=-2, dim2=-1).sum(-1)[..., None, None]
    m = 2.0 * (eet @ e) - tr * e
    return torch.cat([det[..., None], m.reshape(m.shape[:-2] + (9,))],
                     dim=-1)


def _nullspace4(x1n: torch.Tensor, x2n: torch.Tensor) -> torch.Tensor:
    """(..., 5, 2) normalized correspondences → (..., 4, 3, 3) basis of the
    epipolar null space."""
    p1 = homogenize(x1n)
    p2 = homogenize(x2n)
    q = (p2[..., :, None] * p1[..., None, :]).reshape(
        x1n.shape[:-2] + (5, 9))
    qqt = torch.einsum("...ni,...mi->...nm", q, q)
    ridge = 1e-8 * torch.diagonal(qqt, dim1=-2, dim2=-1).sum(-1)
    eye5 = torch.eye(5, dtype=q.dtype, device=q.device)
    x_sol = solve_unrolled(qqt + ridge[..., None, None] * eye5, q)
    r_fixed = _const("r_fixed", q)
    xr = torch.einsum("...ni,ij->...nj", x_sol, r_fixed)      # (..., 5, 4)
    pr = r_fixed - torch.einsum("...ni,...nj->...ij", q, xr)  # (..., 9, 4)
    cols = []
    for j in range(4):                                        # Gram-Schmidt
        v = pr[..., :, j]
        for u in cols:
            v = v - torch.sum(v * u, dim=-1, keepdim=True) * u
        v = v / torch.clamp(torch.linalg.vector_norm(v, dim=-1,
                                                     keepdim=True),
                            min=1e-20)
        cols.append(v)
    basis = torch.stack(cols, dim=-2)                         # (..., 4, 9)
    return basis.reshape(x1n.shape[:-2] + (4, 3, 3))


def _durand_kerner(coeffs: torch.Tensor, iters: int = 80) -> torch.Tensor:
    """Roots of (..., 11) real coefficient vectors (degree 0..10 order):
    (..., 10) complex64, ``iters`` fixed steps over the whole batch."""
    c = coeffs.to(torch.complex64)
    lead = c[..., 10]
    lead = torch.where(torch.abs(lead) < 1e-12,
                       torch.full_like(lead, 1e-12), lead)
    cn = c / lead[..., None]
    # initial guesses on a circle (Aberth's standard init)
    angles = 2.0 * math.pi * (torch.arange(10, dtype=torch.float32,
                                           device=c.device) + 0.5) / 10.0
    w0 = torch.polar(torch.ones_like(angles), angles) * (0.4 + 0.9j)
    w = w0.expand(coeffs.shape[:-1] + (10,)).to(torch.complex64)
    kill = torch.eye(10, dtype=torch.complex64, device=c.device)
    tiny = torch.full((), 1e-20, dtype=torch.complex64, device=c.device)
    for _ in range(iters):
        p = cn[..., 10:11] * torch.ones_like(w)            # Horner
        for d in range(9, -1, -1):
            p = p * w + cn[..., d: d + 1]
        diff = w[..., :, None] - w[..., None, :] + kill   # self-term 1
        denom = diff[..., 0]
        for j in range(1, 10):
            denom = denom * diff[..., j]
        denom = torch.where(torch.abs(denom) < 1e-20, tiny, denom)
        w = w - p / denom
    return w


def essential_5pt(x1n: torch.Tensor, x2n: torch.Tensor,
                  weights=None) -> torch.Tensor:
    """Batched 5-point essential solver with disambiguation.

    x1n, x2n: (..., S ≥ 6, 2) NORMALIZED image coordinates (K⁻¹ applied).
    The first five rows are the minimal set, rows 5+ vote among the ≤ 10
    real solutions by Sampson error. Returns (..., 3, 3), ‖E‖ = 1, or 0
    where no candidate is finite."""
    del weights   # minimal solver; LO refits go through the 8-point path
    basis = _nullspace4(x1n[..., :5, :], x2n[..., :5, :])
    e1, e2, e3, e4 = (basis[..., 0, :, :], basis[..., 1, :, :],
                      basis[..., 2, :, :], basis[..., 3, :, :])

    samples = _const("samples", x1n)                           # (20, 3)
    e_at = (samples[:, 0][:, None, None] * e1[..., None, :, :]
            + samples[:, 1][:, None, None] * e2[..., None, :, :]
            + samples[:, 2][:, None, None] * e3[..., None, :, :]
            + e4[..., None, :, :])                            # (..., 20, 3, 3)
    cvals = _constraints(e_at)                                # (..., 20, 10)
    coef = torch.einsum("ms,...sr->...rm", _const("vand_inv", x1n),
                        cvals)                                # (..., 10, 20)

    # C(z) at the 16 nodes → det → the degree-10 fit
    zexp = _const("zexp", x1n)
    zp = _const("znodes", x1n)[:, None] ** zexp[None, :]       # (16, 20)
    sel = _const("sel", x1n)                                  # (20, 10)
    cz = torch.einsum("...rm,zm,mx->...zrx", coef, zp, sel)   # (..., 16, 10, 10)
    dets = det_unrolled(cz)                                   # (..., 16)
    poly = torch.einsum("dz,...z->...d", _const("zfit", x1n), dets)

    roots = _durand_kerner(poly)                              # (..., 10)
    zr = roots.real
    scale = torch.clamp(torch.abs(roots.imag).amax(dim=-1, keepdim=True),
                        min=1.0)
    is_real = torch.abs(roots.imag) < 1e-3 * scale

    # per real root: the null vector of C(z) → (x, y) → an E candidate
    zpow = zr[..., None] ** zexp                              # (..., 10, 20)
    c_at = torch.einsum("...rm,...km,mx->...krx", coef, zpow, sel)
    ctc = torch.einsum("...rx,...ry->...xy", c_at, c_at)      # (..., 10, 10, 10)
    ridge = 1e-9 * torch.diagonal(ctc, dim1=-2, dim2=-1).sum(-1)
    m_r = ctc + ridge[..., None, None] * torch.eye(10, dtype=ctc.dtype,
                                                   device=ctc.device)
    v = torch.full(ctc.shape[:-1], 1.0 / math.sqrt(10.0), dtype=ctc.dtype,
                   device=ctc.device)
    for _ in range(3):
        v = solve_unrolled(m_r, v[..., None])[..., 0]
        v = v / torch.clamp(torch.linalg.vector_norm(v, dim=-1, keepdim=True),
                            min=1e-30)
    denom = v[..., _1_IDX]
    denom = torch.where(torch.abs(denom) < 1e-9,
                        torch.full_like(denom, 1e-9), denom)
    x = v[..., _X_IDX] / denom
    y = v[..., _Y_IDX] / denom

    e_cand = (x[..., None, None] * e1[..., None, :, :]
              + y[..., None, None] * e2[..., None, :, :]
              + zr[..., None, None] * e3[..., None, :, :]
              + e4[..., None, :, :])                          # (..., 10, 3, 3)
    flat = e_cand.reshape(e_cand.shape[:-2] + (9,))
    norm = torch.linalg.vector_norm(flat, dim=-1)
    e_cand = e_cand / torch.clamp(norm, min=1e-12)[..., None, None]

    # the extra correspondences (rows 5+) choose, by Sampson error; a
    # degenerate sample (coincident points, diverged roots) gives NaN
    # candidates, demoted rather than propagated
    err = sampson_distance(e_cand, x1n[..., None, 5:, :],
                           x2n[..., None, 5:, :]).sum(-1)     # (..., 10)
    finite = torch.isfinite(e_cand.reshape(e_cand.shape[:-2] + (9,))
                            ).all(dim=-1)
    err = torch.where(is_real & finite & torch.isfinite(err), err,
                      torch.full_like(err, float("inf")))
    best = torch.argmin(err, dim=-1)
    e_best = torch.take_along_dim(
        e_cand, best[..., None, None, None], dim=-3)[..., 0, :, :]
    ok = torch.take_along_dim(finite, best[..., None], dim=-1)[..., 0]
    return torch.where(ok[..., None, None], e_best, torch.zeros_like(e_best))
