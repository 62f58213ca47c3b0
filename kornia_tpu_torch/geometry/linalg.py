"""Small dense linear algebra (port of the parts of
kornia_tpu/geometry/linalg.py that the two-view bootstrap calls)."""

from __future__ import annotations

import torch


def homogenize(x: torch.Tensor) -> torch.Tensor:
    return torch.cat([x, torch.ones_like(x[..., :1])], dim=-1)


def inv3x3(m: torch.Tensor) -> torch.Tensor:
    """Closed-form adjugate inverse of (..., 3, 3)."""
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    co_a = e * i - f * h
    co_b = f * g - d * i
    co_c = d * h - e * g
    det = a * co_a + b * co_b + c * co_c
    tiny = torch.where(det < 0, torch.full_like(det, -1e-30),
                       torch.full_like(det, 1e-30))
    det = torch.where(torch.abs(det) < 1e-30, tiny, det)
    adj = torch.stack([
        co_a, c * h - b * i, b * f - c * e,
        co_b, a * i - c * g, c * d - a * f,
        co_c, b * g - a * h, a * e - b * d,
    ], dim=-1).reshape(m.shape)
    return adj / det[..., None, None]


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
