"""Triangulation (port of kornia_tpu/geometry/triangulation.py): batched DLT
through the adjugate of AᵀA, and the closed-form two-ray midpoint depths
of the cheirality vote."""

from __future__ import annotations

from typing import Tuple

import torch


def projection_matrix(r: torch.Tensor, t: torch.Tensor,
                      k: torch.Tensor) -> torch.Tensor:
    """P = K [R | t], (..., 3, 4)."""
    return k @ torch.cat([r, t[..., :, None]], dim=-1)


def triangulate_dlt(p1: torch.Tensor, p2: torch.Tensor, x1: torch.Tensor,
                    x2: torch.Tensor) -> torch.Tensor:
    """DLT triangulation. p1/p2: (..., 3, 4); x1/x2: (..., N, 2) pixels.
    Returns (..., N, 3). The null vector of the 4×4 design matrix is the
    largest column of adj(AᵀA), which is rank-1 along it."""
    rows = []
    for p, x in ((p1, x1), (p2, x2)):
        u = x[..., 0:1]
        v = x[..., 1:2]
        p0 = p[..., None, 0, :]
        p1r = p[..., None, 1, :]
        p2r = p[..., None, 2, :]
        rows.append(u * p2r - p0)
        rows.append(v * p2r - p1r)
    a = torch.stack(rows, dim=-2)   # (..., N, 4, 4)
    m = torch.einsum("...ki,...kj->...ij", a, a)

    def det3(r0, r1, r2, cols):
        c0, c1, c2 = cols
        return (m[..., r0, c0] * (m[..., r1, c1] * m[..., r2, c2]
                                  - m[..., r1, c2] * m[..., r2, c1])
                - m[..., r0, c1] * (m[..., r1, c0] * m[..., r2, c2]
                                    - m[..., r1, c2] * m[..., r2, c0])
                + m[..., r0, c2] * (m[..., r1, c0] * m[..., r2, c1]
                                    - m[..., r1, c1] * m[..., r2, c0]))

    idx = [0, 1, 2, 3]
    adj_cols = []
    for j in range(4):          # adj[i, j] = (−1)^{i+j} minor(j, i)
        col = []
        for i in range(4):
            rows3 = [r for r in idx if r != j]
            cols3 = [c for c in idx if c != i]
            col.append(((-1.0) ** (i + j)) * det3(*rows3, cols3))
        adj_cols.append(torch.stack(col, dim=-1))
    adj = torch.stack(adj_cols, dim=-1)             # (..., 4, 4)
    nrm2 = torch.sum(adj * adj, dim=-2)
    j = torch.argmax(nrm2, dim=-1)
    xh = torch.take_along_dim(
        adj, j[..., None, None].expand(adj.shape[:-1] + (1,)), dim=-1)[..., 0]
    w = xh[..., 3:4]
    return xh[..., :3] / torch.where(torch.abs(w) < 1e-12,
                                     torch.full_like(w, 1e-12), w)


def triangulate_midpoint_depths(r: torch.Tensor, t: torch.Tensor,
                                xn1: torch.Tensor, xn2: torch.Tensor
                                ) -> Tuple[torch.Tensor, torch.Tensor,
                                           torch.Tensor]:
    """Closed-form two-ray depths on normalized coords: (z1, z2,
    cos_parallax)."""
    b1 = torch.cat([xn1, torch.ones_like(xn1[..., :1])], dim=-1)
    b2_cam2 = torch.cat([xn2, torch.ones_like(xn2[..., :1])], dim=-1)
    b2 = torch.einsum("...ji,...nj->...ni", r, b2_cam2)   # Rᵀ b2
    c2 = -torch.einsum("...ji,...j->...i", r, t)          # cam-2 centre
    a11 = torch.sum(b1 * b1, dim=-1)
    a12 = -torch.sum(b1 * b2, dim=-1)
    a22 = torch.sum(b2 * b2, dim=-1)
    rhs1 = torch.sum(b1 * c2[..., None, :], dim=-1)
    rhs2 = -torch.sum(b2 * c2[..., None, :], dim=-1)
    det = a11 * a22 - a12 * a12
    det = torch.where(torch.abs(det) < 1e-12, torch.full_like(det, 1e-12),
                      det)
    z1 = (a22 * rhs1 - a12 * rhs2) / det
    z2 = (a11 * rhs2 - a12 * rhs1) / det
    cosp = torch.sum(b1 * b2, dim=-1) / torch.clamp(
        torch.linalg.norm(b1, dim=-1) * torch.linalg.norm(b2, dim=-1),
        min=1e-12)
    return z1, z2, cosp


def count_cheirality(r: torch.Tensor, t: torch.Tensor, xn1: torch.Tensor,
                     xn2: torch.Tensor, mask: torch.Tensor | None = None,
                     min_parallax_cos: float = 0.99998) -> torch.Tensor:
    """Points in front of both cameras with enough parallax."""
    z1, z2, cosp = triangulate_midpoint_depths(r, t, xn1, xn2)
    good = (z1 > 0) & (z2 > 0) & (cosp < min_parallax_cos)
    if mask is not None:
        good = good & mask
    return torch.sum(good, dim=-1)
