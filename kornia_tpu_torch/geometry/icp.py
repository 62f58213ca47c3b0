"""Iterative closest point (port of kornia_tpu/geometry/icp.py).

Nearest neighbours are brute force: one (N, M) distance matrix from a
float32 matmul (‖a−b‖² = |a|² + |b|² − 2ab) and an argmin, as the reference
computes them outside any Pallas kernel. The product must run at full
float32 precision: a bf16 or TF32 product loses ~1e-2 relative, more than
an odometry step, and corrupts the assignment (kornia_tpu/__init__.py:28-33,
icp.py:44-46); the package turns TF32 off at import. The reference's
fixed-iteration ``lax.scan`` is a Python loop of the same length here, with
nothing read back to the host inside; convergence is reported, not
branched on.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional, Tuple

import torch

from kornia_tpu_torch import entry
from kornia_tpu_torch.geometry.linalg import rigid_transform_3d


@dataclasses.dataclass(frozen=True)
class ICPParams:
    """Fixed-iteration convergence criteria, as kornia_tpu's ICPParams."""

    max_iterations: int = 30
    distance_threshold: float = math.inf  # reject pairs farther than this
    tolerance: float = 1e-6               # reported, not branched on


class ICPResult(NamedTuple):
    rotation: torch.Tensor        # (3, 3)
    translation: torch.Tensor     # (3,)
    rmse: torch.Tensor            # () final inlier RMSE
    converged: torch.Tensor       # () bool: last-step improvement < tolerance
    num_iterations: torch.Tensor  # () int32


def nearest_neighbors(src: torch.Tensor, dst: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Brute-force NN: (N, 3) × (M, 3) → (idx (N,) int64, dist² (N,)); ties
    go to the lower index."""
    cross = src @ dst.T
    d = ((src * src).sum(dim=1, keepdim=True)
         + (dst * dst).sum(dim=1)[None, :] - 2.0 * cross)
    idx = torch.argmin(d, dim=1)
    return idx, torch.clamp(d.gather(1, idx[:, None])[:, 0], min=0.0)


@entry
def icp_vanilla(source: torch.Tensor, target: torch.Tensor,
                params: ICPParams = ICPParams(),
                init_rotation: Optional[torch.Tensor] = None,
                init_translation: Optional[torch.Tensor] = None
                ) -> ICPResult:
    """Point-to-point ICP aligning ``source`` (N, 3) onto ``target`` (M, 3):
    target ≈ R·source + t, float32, ``params.max_iterations`` steps."""
    source = source.to(torch.float32)
    target = target.to(torch.float32)
    dev = source.device
    r = (torch.eye(3, device=dev) if init_rotation is None
         else init_rotation.to(torch.float32))
    t = (torch.zeros(3, device=dev) if init_translation is None
         else init_translation.to(torch.float32))
    thr2 = params.distance_threshold ** 2
    history = []
    for _ in range(params.max_iterations):
        moved = source @ r.T + t
        idx, d2 = nearest_neighbors(moved, target)
        matched = target[idx]
        w = (d2 < thr2).to(torch.float32)
        w = torch.where(w.sum() < 3, torch.ones_like(w), w)  # degenerate
        r, t, _ = rigid_transform_3d(source, matched, w)
        _, d2_new = nearest_neighbors(source @ r.T + t, target)
        history.append(torch.sqrt((d2_new * w).sum()
                                  / torch.clamp(w.sum(), min=1.0)))
    rmse = history[-1]
    improvement = (torch.abs(history[-2] - history[-1])
                   if params.max_iterations > 1 else rmse)
    return ICPResult(rotation=r, translation=t, rmse=rmse,
                     converged=improvement < params.tolerance,
                     num_iterations=torch.full((), params.max_iterations,
                                               dtype=torch.int32, device=dev))
