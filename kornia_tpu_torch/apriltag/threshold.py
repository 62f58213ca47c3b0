"""Adaptive tile threshold for AprilTag detection, on the card (port of
kornia_tpu/apriltag/threshold.py).

Per-tile min/max, a 3×3 tile-neighbourhood min/max and a split between
them; pixels of low-contrast tiles become UNKNOWN. Reshapes and
reductions only, as the reference's one XLA program is: no hand kernel.
"""

from __future__ import annotations

import torch

from kornia_tpu_torch import entry

UNKNOWN = 127  # low-contrast marker (skipped by segmentation)


def _edge_pad(x: torch.Tensor, dim: int) -> torch.Tensor:
    """One element of edge padding on each side of ``dim`` (integer
    tensors: ``F.pad(mode="replicate")`` takes floats only)."""
    n = x.shape[dim]
    return torch.cat([x.narrow(dim, 0, 1), x, x.narrow(dim, n - 1, 1)], dim)


def _nbr(x: torch.Tensor, reduce) -> torch.Tensor:
    """Separable 3×3 neighbourhood min or max with edge padding."""
    p = _edge_pad(x, 0)
    v = reduce(reduce(p[:-2], p[1:-1]), p[2:])
    p = _edge_pad(v, 1)
    return reduce(reduce(p[:, :-2], p[:, 1:-1]), p[:, 2:])


@entry
def adaptive_threshold(gray: torch.Tensor, tile: int = 4,
                       min_white_black_diff: int = 5,
                       split: float = 0.5) -> torch.Tensor:
    """Threshold an (H, W) u8 image into {0, UNKNOWN, 255}.

    Tiles of ``tile`` px compute min/max, the extrema are dilated over the
    3×3 tile neighbourhood, and each pixel splits at
    min + (max − min)·split (float32, truncated to int16). Tiles whose
    neighbourhood contrast is below ``min_white_black_diff`` give
    UNKNOWN. H and W are cropped to tile multiples and the edge is padded
    back with UNKNOWN. An (H, W, C) input takes channel 0.
    """
    if gray.ndim == 3:
        gray = gray[..., 0]
    h, w = gray.shape
    th, tw = h // tile, w // tile
    g = gray[: th * tile, : tw * tile].to(torch.uint8)
    tiles = g.reshape(th, tile, tw, tile)
    tmin = tiles.amin(dim=(1, 3))
    tmax = tiles.amax(dim=(1, 3))
    nmin = _nbr(tmin, torch.minimum)
    nmax = _nbr(tmax, torch.maximum)
    contrast_ok = (nmax.to(torch.int16) - nmin.to(torch.int16)
                   >= min_white_black_diff)
    s = float(min(max(split, 0.0), 1.0))
    nmin_f = nmin.to(torch.float32)
    diff = nmax.to(torch.float32) - nmin_f
    thresh = (nmin_f + diff * s).to(torch.int16)
    # compare in the tile layout: the per-tile values broadcast over their
    # pixels without a repeat
    binary = tiles.to(torch.int16) > thresh[:, None, :, None]
    cut = torch.where(contrast_ok[:, None, :, None],
                      binary.to(torch.uint8) * 255, UNKNOWN)
    out = torch.full((h, w), UNKNOWN, dtype=torch.uint8, device=g.device)
    out[: th * tile, : tw * tile] = cut.reshape(th * tile, tw * tile)
    return out
