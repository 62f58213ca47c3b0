"""Bayer mosaics (port of kornia_tpu/ops/bayer.py): bilinear demosaic of
RGGB / BGGR / GRBG / GBRG raw frames and the inverse subsampling, entry
points with ``device=``.

Bilinear demosaic is one normalised 3×3 convolution per channel: the
[[1, 2, 1], [2, 4, 2], [1, 2, 1]] kernel over the mask-gated raw frame,
divided by the same kernel over the mask. The nine taps are summed in the
reference's order (bayer.py:35-52), so float32 results are exact.
"""

from __future__ import annotations

import torch

from kornia_tpu_torch import entry

# (row, col) of R and of B in the 2×2 CFA tile; green fills the other two
_PATTERNS = {
    "rggb": ((0, 0), (1, 1)),
    "bggr": ((1, 1), (0, 0)),
    "grbg": ((0, 1), (1, 0)),
    "gbrg": ((1, 0), (0, 1)),
}

_K = ((1.0, 2.0, 1.0), (2.0, 4.0, 2.0), (1.0, 2.0, 1.0))


def _conv(x: torch.Tensor) -> torch.Tensor:
    h, w = x.shape
    p = torch.nn.functional.pad(x, (1, 1, 1, 1))
    out = None
    for dy in range(3):
        for dx in range(3):
            term = p[dy: dy + h, dx: dx + w] * _K[dy][dx]
            out = term if out is None else out + term
    return out


def _interp(masked: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    return _conv(masked) / torch.clamp(_conv(mask), min=1e-12)


def _masks(h: int, w: int, pattern: str, device):
    if pattern not in _PATTERNS:
        raise ValueError(f"unknown bayer pattern {pattern!r}")
    yy = (torch.arange(h, device=device) % 2)[:, None]
    xx = (torch.arange(w, device=device) % 2)[None, :]
    (ry, rx), (by, bx) = _PATTERNS[pattern]
    return (yy == ry) & (xx == rx), (yy == by) & (xx == bx)


@entry
def demosaic_bilinear(raw: torch.Tensor, pattern: str = "rggb"
                      ) -> torch.Tensor:
    """Bilinear demosaic of an (H, W) raw frame to (H, W, 3) RGB; u8 in,
    u8 out (rounded), float stays float."""
    if raw.ndim == 3 and raw.shape[2] == 1:
        raw = raw[:, :, 0]
    if raw.ndim != 2:
        raise ValueError(f"raw must be (H, W), got {tuple(raw.shape)}")
    h, w = raw.shape
    r_m, b_m = _masks(h, w, pattern, raw.device)
    r_mask = r_m.to(torch.float32)
    b_mask = b_m.to(torch.float32)
    g_mask = 1.0 - r_mask - b_mask
    x = raw.to(torch.float32)
    rgb = torch.stack([_interp(x * m, m) for m in (r_mask, g_mask, b_mask)],
                      dim=-1)
    if raw.dtype == torch.uint8:
        return torch.clamp(torch.round(rgb), 0, 255).to(torch.uint8)
    return rgb.to(raw.dtype)


@entry
def mosaic(rgb: torch.Tensor, pattern: str = "rggb") -> torch.Tensor:
    """Subsample (H, W, 3) RGB onto a Bayer CFA (the inverse, for tests)."""
    h, w = rgb.shape[:2]
    r_mask, b_mask = _masks(h, w, pattern, rgb.device)
    return torch.where(r_mask, rgb[:, :, 0],
                       torch.where(b_mask, rgb[:, :, 2], rgb[:, :, 1]))
