"""Exact Euclidean distance transform (port of
kornia_tpu/ops/distance_transform.py), an entry point with ``device=``.

The reference's separable formulation: a vertical nearest-zero pass as two
running extrema (``cummax``), then a horizontal min-plus reduction
``D²(y, x) = min_j ((x − j)² + g(y, j)²)`` over row chunks, which bounds
the (chunk, W, W) intermediate (32 rows at 1080p: 472 MB). Every value
summed is an integer below 2²⁴, and the square root is taken in float64
and rounded once to float32, which is the correctly rounded float32 root
that XLA computes (ATen's float32 ``sqrt`` on the CPU is not always), so
the result is bit-equal to the reference's.
"""

from __future__ import annotations

import torch

from kornia_tpu_torch import entry

_INF = 1e12      # the reference's sentinel (distance_transform.py:27)


def _vertical_nearest_zero_sq(zero: torch.Tensor) -> torch.Tensor:
    """Per column, the squared distance to the nearest zero pixel above or
    below (the sentinel where the column has none)."""
    h, w = zero.shape
    rows = torch.arange(h, dtype=torch.int32, device=zero.device)[:, None]
    far = torch.full((), -(2 ** 30), dtype=torch.int32, device=zero.device)
    above = torch.cummax(torch.where(zero, rows, far), dim=0).values
    below = -torch.cummax(torch.where(zero, -rows, far).flip(0),
                          dim=0).values.flip(0)
    d_up = (rows - above).to(torch.float32)
    d_dn = (below - rows).to(torch.float32)
    d = torch.minimum(torch.abs(d_up), torch.abs(d_dn))
    return torch.where(d >= 2 ** 29, _INF, d * d)


@entry
def distance_transform(mask: torch.Tensor, row_chunk: int = 32
                       ) -> torch.Tensor:
    """(H, W) float32 L2 distance from each pixel where ``mask != 0`` to the
    nearest pixel where ``mask == 0`` (0 on those; the finite sentinel
    √1e12 where the image has no zero pixel)."""
    if mask.ndim != 2:
        raise ValueError(f"mask must be (H, W), got {tuple(mask.shape)}")
    h, w = mask.shape
    g2 = _vertical_nearest_zero_sq(mask == 0)
    cols = torch.arange(w, dtype=torch.float32, device=mask.device)
    dx2 = (cols[:, None] - cols[None, :]) ** 2           # (W, W)
    out = [torch.amin(g2[y0: y0 + row_chunk, None, :] + dx2[None], dim=-1)
           for y0 in range(0, h, row_chunk)]
    d2 = torch.clamp(torch.cat(out), max=_INF)
    return torch.sqrt(d2.to(torch.float64)).to(torch.float32)
