"""Pinhole camera helpers (port of kornia_tpu/geometry/camera.py, only what
the two-view bootstrap calls)."""

from __future__ import annotations

import torch


def normalize_points(px: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Pixels → normalized image coordinates (K⁻¹ applied)."""
    fx, fy = k[..., 0, 0], k[..., 1, 1]
    cx, cy = k[..., 0, 2], k[..., 1, 2]
    return torch.stack([(px[..., 0] - cx) / fx, (px[..., 1] - cy) / fy],
                       dim=-1)
