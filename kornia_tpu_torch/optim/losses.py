"""Robust loss functions as IRLS weights (port of
kornia_tpu/optim/losses.py).

Each loss returns the weight w(r²) such that the weighted residual √w·r
implements the robustified cost (the Triggs convention). A Python number
divided by a tensor is written as a tensor division: ATen computes
``c / t`` as ``reciprocal(t) * c``, one rounding more than the
reference's division.
"""

from __future__ import annotations

import torch


def identity_weight(sq_norm: torch.Tensor, scale: float = 1.0
                    ) -> torch.Tensor:
    return torch.ones_like(sq_norm)


def huber_weight(sq_norm: torch.Tensor, scale: float = 1.0) -> torch.Tensor:
    """w = 1 for |r| ≤ k, k/|r| beyond."""
    r = torch.sqrt(torch.clamp(sq_norm, min=1e-18))
    return torch.where(r <= scale, torch.ones_like(r),
                       torch.full_like(r, scale) / r)


def cauchy_weight(sq_norm: torch.Tensor, scale: float = 1.0) -> torch.Tensor:
    """w = 1 / (1 + (r/k)²)."""
    return torch.ones_like(sq_norm) / (1.0 + sq_norm / (scale * scale))


def tukey_weight(sq_norm: torch.Tensor, scale: float = 1.0) -> torch.Tensor:
    r2 = sq_norm / (scale * scale)
    return torch.where(r2 <= 1.0, (1.0 - r2) ** 2, torch.zeros_like(r2))


LOSSES = {
    "identity": identity_weight,
    "huber": huber_weight,
    "cauchy": cauchy_weight,
    "tukey": tukey_weight,
}
