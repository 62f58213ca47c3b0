"""SO(3) exponential (port of kornia_tpu/geometry/liegroup.py:126-157, the
part the Sampson refinement calls)."""

from __future__ import annotations

import torch

_EPS = 1e-8


def quat_to_matrix(q: torch.Tensor) -> torch.Tensor:
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    r = torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ], dim=-1)
    return r.reshape(q.shape[:-1] + (3, 3))


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Tangent (..., 3) → quaternion (..., 4), wxyz, with the Taylor guard
    at ω = 0 applied before the sqrt (NaN-free derivatives)."""
    theta2 = torch.sum(w * w, dim=-1, keepdim=True)
    small = theta2 < _EPS
    safe_theta = torch.sqrt(torch.where(small, torch.ones_like(theta2),
                                        theta2))
    half = 0.5 * safe_theta
    k = torch.where(small, 0.5 - theta2 / 48.0,
                    torch.sin(half) / safe_theta)
    cw = torch.where(small, 1.0 - theta2 / 8.0, torch.cos(half))
    return torch.cat([cw, k * w], dim=-1)


def so3_exp_matrix(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues (..., 3) → (..., 3, 3)."""
    return quat_to_matrix(so3_exp(w))
