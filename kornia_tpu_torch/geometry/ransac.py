"""Batched RANSAC (port of kornia_tpu/geometry/ransac.py).

All hypotheses are drawn, solved and scored as one fixed-shape batch:
Gumbel-top-k samples over the validity mask, a batched minimal solver, one
(B, N) residual matrix with MSAC scoring, argmin, then weighted local
optimisation refits. Nothing waits on the device inside.

The random draw uses a ``torch.Generator``; it cannot reproduce the JAX
package's ``jax.random`` stream, so ``ransac`` takes ``sample_idx`` to be
handed a draw (the tests pass the reference's).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch


class RansacResult(NamedTuple):
    model: torch.Tensor      # (3, 3) best model
    inliers: torch.Tensor    # (N,) bool
    n_inliers: torch.Tensor  # () int64
    score: torch.Tensor      # () float32 MSAC score (lower = better)


def sample_minimal_sets(generator: Optional[torch.Generator], n_points: int,
                        mask: torch.Tensor, batch: int,
                        sample_size: int) -> torch.Tensor:
    """(B, S) index sets, uniform over valid points, no repeats within a
    set (Gumbel-top-k over the mask)."""
    u = torch.rand((batch, n_points), generator=generator,
                   device=mask.device)
    tiny = torch.finfo(u.dtype).tiny
    g = -torch.log(-torch.log(torch.clamp(u, min=tiny)))
    g = torch.where(mask[None, :], g, torch.full_like(g, float("-inf")))
    return torch.topk(g, sample_size, dim=-1).indices


def ransac(generator: Optional[torch.Generator], x1: torch.Tensor,
           x2: torch.Tensor, solver_fn: Callable, residual_fn: Callable,
           sample_size: int, threshold: float,
           mask: Optional[torch.Tensor] = None, n_hypotheses: int = 512,
           lo_iters: int = 2, sample_idx: Optional[torch.Tensor] = None
           ) -> RansacResult:
    """Generic batched RANSAC with MSAC scoring and ``lo_iters`` weighted
    refits of the winner; ``sample_idx`` (B, S), when given, replaces the
    random draw."""
    n = x1.shape[0]
    if mask is None:
        mask = torch.ones(n, dtype=torch.bool, device=x1.device)
    t2 = threshold * threshold
    if sample_idx is None:
        sample_idx = sample_minimal_sets(generator, n, mask, n_hypotheses,
                                         sample_size)
    idx = sample_idx.to(device=x1.device, dtype=torch.int64)
    models = solver_fn(x1[idx], x2[idx])                 # (B, 3, 3)

    cap = torch.full((), t2, dtype=x1.dtype, device=x1.device)
    res = residual_fn(models, x1, x2)                    # (B, N)
    res = torch.where(torch.isfinite(res), res, cap)
    res = torch.where(mask[None, :], res, cap)
    msac = torch.sum(torch.clamp(res, max=t2), dim=-1)
    best = torch.argmin(msac)
    model = models[best]
    score = msac[best]

    def score_of(r):
        return torch.sum(torch.clamp(torch.where(mask, r, cap), max=t2))

    for _ in range(lo_iters):
        r = residual_fn(model[None], x1, x2)[0]
        w = ((r < t2) & mask).to(x1.dtype)
        refit = solver_fn(x1[None], x2[None], weights=w[None])[0]
        r2 = residual_fn(refit[None], x1, x2)[0]
        new_score = score_of(r2)
        old_score = score_of(r)
        model = torch.where(new_score < old_score, refit, model)
        score = torch.minimum(new_score, old_score)
    r = residual_fn(model[None], x1, x2)[0]
    inliers = (r < t2) & mask
    return RansacResult(model=model, inliers=inliers,
                        n_inliers=torch.sum(inliers), score=score)
