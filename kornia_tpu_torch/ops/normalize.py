"""Normalisation (port of kornia_tpu/ops/normalize.py): per-channel mean/std
and min/max rescaling, entry points with ``device=``."""

from __future__ import annotations

from typing import Sequence

import torch

from kornia_tpu_torch import entry
from kornia_tpu_torch.ops.filters import const_on


@entry
def normalize_mean_std(img: torch.Tensor, mean: Sequence[float],
                       std: Sequence[float]) -> torch.Tensor:
    """(x − mean) / std per channel; u8 input is scaled to [0, 1] first."""
    x = img.to(torch.float32)
    if img.dtype == torch.uint8:
        x = x * (1.0 / 255.0)
    return ((x - const_on(tuple(mean), x.device))
            / const_on(tuple(std), x.device))


@entry
def denormalize_mean_std(img: torch.Tensor, mean: Sequence[float],
                         std: Sequence[float]) -> torch.Tensor:
    return (img * const_on(tuple(std), img.device)
            + const_on(tuple(mean), img.device))


@entry
def normalize_min_max(img: torch.Tensor, lo: float = 0.0, hi: float = 1.0
                      ) -> torch.Tensor:
    """Affine rescale of the whole image to [lo, hi]; the extrema stay on
    the device."""
    x = img.to(torch.float32)
    xmin = x.amin()
    span = torch.clamp(x.amax() - xmin, min=1e-12)
    scale = torch.full_like(span, hi - lo) / span
    return (x - xmin) * scale + lo
