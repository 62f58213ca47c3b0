"""Image pyramids (port of kornia_tpu/ops/pyramid.py: the cv2 5-tap
binomial ``pyrdown`` / ``pyrup`` and ``gaussian_pyramid``).

Images are (H, W) or (..., H, W, C); ``scale_pyramid``, ORB's geometric
pyramid, is an entry point with ``device=``.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from kornia_tpu_torch import entry
from kornia_tpu_torch.ops.filters import (_conv_sep, _finalize,
                                          _with_channels)
from kornia_tpu_torch.ops.resize import resize

_PYR_K = np.array([1.0, 4.0, 6.0, 4.0, 1.0], np.float32) / 16.0


def pyrdown(img: torch.Tensor) -> torch.Tensor:
    """Gaussian blur (5-tap binomial) + drop every other pixel
    (cv2.pyrDown)."""
    x, squeeze = _with_channels(img)
    blurred = _conv_sep(x, _PYR_K, _PYR_K, "reflect")
    out = _finalize(blurred[..., ::2, ::2, :], img.dtype)
    return out[..., 0] if squeeze else out


def pyrup(img: torch.Tensor) -> torch.Tensor:
    """Zero-upsample 2× + blur with 4·kernel (cv2.pyrUp)."""
    x, squeeze = _with_channels(img)
    h, w, c = x.shape[-3:]
    up = torch.zeros(x.shape[:-3] + (h * 2, w * 2, c), dtype=torch.float32,
                     device=x.device)
    up[..., ::2, ::2, :] = x.to(torch.float32)
    out = _finalize(_conv_sep(up, _PYR_K * 2.0, _PYR_K * 2.0, "reflect"),
                    img.dtype)
    return out[..., 0] if squeeze else out


def gaussian_pyramid(img: torch.Tensor, levels: int) -> List[torch.Tensor]:
    out = [img]
    for _ in range(levels - 1):
        out.append(pyrdown(out[-1]))
    return out


@entry
def scale_pyramid(img: torch.Tensor, n_levels: int,
                  scale_factor: float = 1.2) -> List[torch.Tensor]:
    """ORB-style geometric pyramid: level i is round(dim / scale_factor^i),
    bilinear, each level resized from the one before it (ORB-SLAM3's
    chain), not from level 0."""
    ay = -3 if img.ndim >= 3 else -2
    h, w = img.shape[ay], img.shape[ay + 1]
    levels = [img]
    for i in range(1, n_levels):
        s = scale_factor ** i
        levels.append(resize(levels[-1], (int(round(h / s)),
                                          int(round(w / s)))))
    return levels
