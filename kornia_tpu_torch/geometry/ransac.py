"""Batched RANSAC (port of kornia_tpu/geometry/ransac.py).

All hypotheses are drawn, solved and scored as one fixed-shape batch:
Gumbel-top-k samples over the validity mask, a batched minimal solver, one
(B, N) residual matrix with MSAC (or MAGSAC) scoring, argmin, then
weighted local-optimisation refits. Nothing waits on the device inside.

A model is a tensor or a NamedTuple of tensors (a PnP pose), batched on
the leading dim; selections and selects map over its fields, as the
reference's ``jax.tree_util.tree_map`` does.

The random draw uses a ``torch.Generator``; it cannot reproduce the JAX
package's ``jax.random`` stream, so ``ransac`` takes ``sample_idx`` to be
handed a draw (the tests pass the reference's).
"""

from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple, Optional

import torch


class RansacResult(NamedTuple):
    model: Any               # (3, 3) or the solver's model, unbatched
    inliers: torch.Tensor    # (N,) bool
    n_inliers: torch.Tensor  # () int64
    score: torch.Tensor      # () float32 score of the winner (lower = better)


def num_hypotheses(sample_size: int, inlier_ratio: float = 0.3,
                   confidence: float = 0.999) -> int:
    """Static hypothesis budget from the classic formula, at least 32."""
    denom = math.log(max(1.0 - inlier_ratio ** sample_size, 1e-12))
    return max(32, int(math.ceil(math.log(1.0 - confidence) / denom)))


def _map(fn: Callable, model, *others):
    """``fn`` over a tensor model, or field by field over a NamedTuple."""
    if isinstance(model, torch.Tensor):
        return fn(model, *others)
    return type(model)(*(fn(*fields) for fields in zip(model, *others)))


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
           lo_iters: int = 2, sample_idx: Optional[torch.Tensor] = None,
           scoring: str = "msac") -> RansacResult:
    """Generic batched RANSAC with ``lo_iters`` weighted refits of the
    winner.

    x1 (N, D1), x2 (N, D2): correspondences (padded; ``mask`` marks valid
    rows). solver_fn: (B, S, D1) × (B, S, D2) → (B, ...) models.
    residual_fn: (B, ...) models × x1 × x2 → (B, N) squared residuals.
    The refits call ``solver_fn`` on the full set with ``weights=``.
    scoring: "msac" (truncated residual
    sum) or "magsac" (σ-marginalised Gaussian quality over 8 σ in
    [t/8, t]); it picks the hypothesis, the refits compare MSAC scores and
    the inliers use the hard threshold, as in the reference.
    ``sample_idx`` (B, S), when given, replaces the random draw."""
    n = x1.shape[0]
    if mask is None:
        mask = torch.ones(n, dtype=torch.bool, device=x1.device)
    t2 = threshold * threshold
    if sample_idx is None:
        sample_idx = sample_minimal_sets(generator, n, mask, n_hypotheses,
                                         sample_size)
    idx = sample_idx.to(device=x1.device, dtype=torch.int64)
    models = solver_fn(x1[idx], x2[idx])                 # (B, ...)

    cap = torch.full((), t2, dtype=x1.dtype, device=x1.device)
    res = residual_fn(models, x1, x2)                    # (B, N)
    res = torch.where(torch.isfinite(res), res, cap)
    res = torch.where(mask[None, :], res, cap)
    if scoring == "magsac":
        sigmas = torch.linspace(threshold / 8.0, threshold, 8,
                                dtype=x1.dtype, device=x1.device)
        lik = torch.mean(torch.exp(-res[..., None] / (2.0 * sigmas ** 2)),
                         dim=-1)
        score_all = -torch.sum(torch.where(mask[None, :], lik,
                                           torch.zeros_like(lik)), dim=-1)
    elif scoring == "msac":
        score_all = torch.sum(torch.clamp(res, max=t2), dim=-1)
    else:
        raise ValueError(f"unknown scoring {scoring!r}")
    best = torch.argmin(score_all).reshape(1)
    # index_select with a (1,) tensor: a 0-dim index would be read on the
    # host
    model = _map(lambda m: m.index_select(0, best)[0], models)
    score = score_all.index_select(0, best)[0]

    def expand(m):
        return _map(lambda f: f[None], m)

    def score_of(r):
        return torch.sum(torch.clamp(torch.where(mask, r, cap), max=t2))

    for _ in range(lo_iters):
        r = residual_fn(expand(model), x1, x2)[0]
        w = ((r < t2) & mask).to(x1.dtype)
        refit = _map(lambda f: f[0],
                     solver_fn(x1[None], x2[None], weights=w[None]))
        r2 = residual_fn(expand(refit), x1, x2)[0]
        new_score = score_of(r2)
        old_score = score_of(r)
        better = new_score < old_score
        model = _map(lambda a, b: torch.where(better, a, b), refit, model)
        score = torch.minimum(new_score, old_score)
    r = residual_fn(expand(model), x1, x2)[0]
    inliers = (r < t2) & mask
    return RansacResult(model=model, inliers=inliers,
                        n_inliers=torch.sum(inliers), score=score)
