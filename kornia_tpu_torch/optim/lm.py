"""Levenberg–Marquardt on flat or manifold parameters (port of
kornia_tpu/optim/lm.py).

A fixed number of iterations; accept/reject and the λ update are
``torch.where`` selects on the device, so no iteration waits on the host.
Jacobians come from ``torch.func.jacfwd`` (of the residual over the flat
vector, or of residual(retract(x, δ)) at δ = 0), where the reference
calls ``jax.jacfwd``.
"""

from __future__ import annotations

import enum
from typing import Callable, NamedTuple

import torch

from kornia_tpu_torch.geometry.linalg import solve_cholesky_damped


class TerminationReason(enum.Enum):
    MAX_ITERATIONS = "max_iterations"
    COST_TOLERANCE = "cost_tolerance"


class LMResult(NamedTuple):
    params: object
    cost: torch.Tensor           # final 0.5·‖r‖²
    initial_cost: torch.Tensor
    iterations: int
    converged: torch.Tensor      # cost-decrease tolerance hit


def _cost(r: torch.Tensor) -> torch.Tensor:
    return 0.5 * torch.sum(r * r)


def lm_optimize(residual_fn: Callable[[torch.Tensor], torch.Tensor],
                x0: torch.Tensor, max_iterations: int = 20,
                lambda_init: float = 1e-3, lambda_factor: float = 10.0,
                cost_tolerance: float = 1e-9) -> LMResult:
    """Dense LM on a flat parameter vector. residual_fn: (P,) → (R,)."""
    x = x0
    lam = torch.full((), lambda_init, dtype=x0.dtype, device=x0.device)
    c0 = _cost(residual_fn(x0))
    cost = c0
    conv = torch.zeros((), dtype=torch.bool, device=x0.device)
    for _ in range(max_iterations):
        r = residual_fn(x)
        j = torch.func.jacfwd(residual_fn)(x)       # (R, P)
        delta = solve_cholesky_damped(j.T @ j, -(j.T @ r), lam)
        new_cost = _cost(residual_fn(x + delta))
        accept = new_cost < cost
        x = torch.where(accept, x + delta, x)
        lam = torch.clamp(torch.where(accept, lam / lambda_factor,
                                      lam * lambda_factor), 1e-12, 1e6)
        conv = conv | (accept & (cost - new_cost < cost_tolerance * cost))
        cost = torch.where(accept, new_cost, cost)
    return LMResult(params=x, cost=cost, initial_cost=c0,
                    iterations=max_iterations, converged=conv)


def lm_manifold(residual_fn: Callable, retract_fn: Callable, x0,
                tangent_dim: int, max_iterations: int = 20,
                lambda_init: float = 1e-3, lambda_factor: float = 10.0,
                cost_tolerance: float = 1e-9) -> LMResult:
    """x0 is a tuple of tensors; retract_fn(x, δ (tangent_dim,)) → x."""
    dev = x0[0].device
    zero = torch.zeros(tangent_dim, dtype=torch.float32, device=dev)
    x = x0
    lam = torch.tensor(lambda_init, dtype=torch.float32, device=dev)
    c0 = _cost(residual_fn(x0))
    cost = c0
    conv = torch.zeros((), dtype=torch.bool, device=dev)
    for _ in range(max_iterations):
        def res_at(d, x=x):
            return residual_fn(retract_fn(x, d))

        r = res_at(zero)
        j = torch.func.jacfwd(res_at)(zero)         # (R, P)
        jtj = j.T @ j
        g = j.T @ r
        delta = solve_cholesky_damped(jtj, -g, lam)
        x_new = retract_fn(x, delta)
        new_cost = _cost(residual_fn(x_new))
        accept = new_cost < cost
        x = tuple(torch.where(accept, a, b) for a, b in zip(x_new, x))
        lam = torch.clamp(torch.where(accept, lam / lambda_factor,
                                      lam * lambda_factor), 1e-12, 1e6)
        conv = conv | (accept & (cost - new_cost < cost_tolerance * cost))
        cost = torch.where(accept, new_cost, cost)
    return LMResult(params=x, cost=cost, initial_cost=c0,
                    iterations=max_iterations, converged=conv)
