"""Pose-graph optimisation (port of kornia_tpu/optim/pgo.py).

Edge residual r = log(T_ab_meas⁻¹ · T_b · T_a⁻¹); Jacobians are exact
forward-mode derivatives through the Lie-group ops
(``torch.func.vmap(torch.func.jacfwd(...))`` per edge, where the reference
calls ``jax.vmap(jax.jacfwd(...))``); the 6P×6P Gauss-Newton system is
assembled with ``index_add_`` and solved by a damped dense Cholesky inside
an LM loop of ``torch.where`` selects, with no wait for the device.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from kornia_tpu_torch import to_device
from kornia_tpu_torch.geometry import liegroup as lg
from kornia_tpu_torch.geometry.linalg import solve_cholesky
from kornia_tpu_torch.optim.losses import LOSSES


@dataclasses.dataclass(frozen=True)
class PGOParams:
    max_iterations: int = 20
    lambda_init: float = 1e-6
    lambda_factor: float = 10.0
    loss: str = "identity"
    loss_scale: float = 1.0


class PGOResult(NamedTuple):
    poses: torch.Tensor        # (P, 7)
    initial_cost: torch.Tensor
    final_cost: torch.Tensor
    iterations: int


def edge_residual(t_a: torch.Tensor, t_b: torch.Tensor,
                  t_ab_meas: torch.Tensor) -> torch.Tensor:
    """r = log(T_ab_meas⁻¹ ∘ T_b ∘ T_a⁻¹) ∈ ℝ⁶."""
    rel = lg.se3_compose(t_b, lg.se3_inverse(t_a))
    return lg.se3_log(lg.se3_compose(lg.se3_inverse(t_ab_meas), rel))


def _edge_res_and_jac(t_a, t_b, t_meas):
    """Residual (6,) and Jacobians (6, 6) wrt left perturbations of a and
    b."""

    def res(delta):
        return edge_residual(lg.se3_retract(t_a, delta[:6]),
                             lg.se3_retract(t_b, delta[6:]), t_meas)

    zero = torch.zeros(12, dtype=t_a.dtype, device=t_a.device)
    j = torch.func.jacfwd(res)(zero)  # (6, 12)
    return res(zero), j[:, :6], j[:, 6:]


def pgo_normal_equations(poses, edge_i, edge_j, edge_meas, edge_weight,
                         params: PGOParams):
    """H (P, P, 6, 6) and g (P, 6) by segmented sums over the edges, and
    the cost."""
    p = poses.shape[0]
    r, ja, jb = torch.func.vmap(_edge_res_and_jac)(
        poses.index_select(0, edge_i), poses.index_select(0, edge_j),
        edge_meas)                                  # (E,6), (E,6,6) × 2
    sq = torch.sum(r * r, dim=-1)
    w = edge_weight * LOSSES[params.loss](sq, params.loss_scale)
    wja = ja * w[:, None, None]
    wjb = jb * w[:, None, None]

    haa = torch.einsum("eki,ekj->eij", wja, ja)
    hbb = torch.einsum("eki,ekj->eij", wjb, jb)
    hab = torch.einsum("eki,ekj->eij", wja, jb)
    ga = -torch.einsum("eki,ek->ei", wja, r)
    gb = -torch.einsum("eki,ek->ei", wjb, r)

    # the four blocks of each edge into the dense pair grid
    flat = torch.cat([haa, hbb, hab, hab.transpose(-1, -2)]).reshape(-1, 36)
    idx = torch.cat([edge_i * p + edge_i, edge_j * p + edge_j,
                     edge_i * p + edge_j, edge_j * p + edge_i])
    h = torch.zeros(p * p, 36, dtype=flat.dtype, device=flat.device)
    h = h.index_add_(0, idx, flat).reshape(p, p, 6, 6)
    g = torch.zeros(p, 6, dtype=ga.dtype, device=ga.device).index_add_(
        0, torch.cat([edge_i, edge_j]), torch.cat([ga, gb]))
    return h, g, 0.5 * torch.sum(w * sq)


def edge_cost(poses, edge_i, edge_j, edge_meas, edge_weight,
              params: PGOParams) -> torch.Tensor:
    """0.5 Σ w·ρ(‖r‖²) over the edges."""
    r = edge_residual(poses.index_select(0, edge_i),
                      poses.index_select(0, edge_j), edge_meas)
    sq = torch.sum(r * r, dim=-1)
    w = edge_weight * LOSSES[params.loss](sq, params.loss_scale)
    return 0.5 * torch.sum(w * sq)


def damped_step(h: torch.Tensor, g: torch.Tensor, free: torch.Tensor,
                lam) -> torch.Tensor:
    """The LM step δ (P, 6) of the gauge-fixed, damped system: fixed
    poses (``free`` 0) get identity rows and columns and a zero step."""
    p = h.shape[0]
    free6 = free[:, None].expand(p, 6).reshape(-1)
    hd = h.transpose(1, 2).reshape(p * 6, p * 6)
    hd = hd * free6[:, None] * free6[None, :]
    hd.diagonal().add_(1.0 - free6)
    g = g * free[:, None]
    hd.diagonal().add_(lam * torch.clamp(hd.diagonal(), min=1e-9))
    return solve_cholesky(hd, g.reshape(-1)).reshape(p, 6) * free[:, None]


def pose_graph_optimize(poses: torch.Tensor, edge_i, edge_j, edge_meas,
                        edge_weight=None, fixed: Optional[torch.Tensor] = None,
                        params: PGOParams = PGOParams()) -> PGOResult:
    """LM pose-graph optimisation on the device of ``poses``.

    poses: (P, 7); edges (E,) index pairs with (E, 7) relative
    measurements T_ab (T_b ≈ T_ab ∘ T_a); ``fixed`` marks gauge poses
    (default: pose 0)."""
    dev = poses.device
    p = poses.shape[0]
    edge_i = to_device(edge_i, dev, torch.int64)
    edge_j = to_device(edge_j, dev, torch.int64)
    edge_meas = to_device(edge_meas, dev, torch.float32)
    edge_weight = (torch.ones(edge_i.shape[0], dtype=torch.float32,
                              device=dev) if edge_weight is None
                   else to_device(edge_weight, dev, torch.float32))
    fixed = (torch.arange(p, device=dev) == 0 if fixed is None
             else to_device(fixed, dev, torch.bool))
    free = (~fixed).to(torch.float32)
    edges = (edge_i, edge_j, edge_meas, edge_weight)

    c0 = edge_cost(poses, *edges, params)
    ps, cost = poses, c0
    lam = torch.full((), params.lambda_init, dtype=torch.float32, device=dev)
    for _ in range(params.max_iterations):
        h, g, _ = pgo_normal_equations(ps, *edges, params)
        ps_new = lg.se3_retract(ps, damped_step(h, g, free, lam))
        new_cost = edge_cost(ps_new, *edges, params)
        accept = new_cost < cost
        ps = torch.where(accept, ps_new, ps)
        lam = torch.clamp(torch.where(accept, lam / params.lambda_factor,
                                      lam * params.lambda_factor),
                          1e-12, 1e8)
        cost = torch.where(accept, new_cost, cost)
    return PGOResult(poses=ps, initial_cost=c0, final_cost=cost,
                     iterations=params.max_iterations)
