"""Bilinear resize as two band-matrix products
(port of kornia_tpu/ops/resize.py, the part ORB's pyramid uses).

``out = Wy @ img @ Wxᵀ`` with (out, in) weight matrices built on the host
with numpy. The JAX package leaves these products to XLA (resize.py:177-178,
no Pallas kernel), so here they are ``torch.matmul`` in float32 (TF32 is off,
see kornia_tpu_torch/__init__.py).
"""

from __future__ import annotations

import functools
import math
from typing import Tuple

import numpy as np
import torch


def _triangle(x):
    x = np.abs(x)
    return np.maximum(0.0, 1.0 - x)


@functools.lru_cache(maxsize=256)
def _resize_matrix(in_size: int, out_size: int) -> np.ndarray:
    """(out_size, in_size) float32 row-stochastic bilinear weight matrix,
    cv2 semantics (border replicate: out-of-range taps clamp to the
    edge). The other modes of the reference are not ported yet."""
    scale = in_size / out_size
    sup = 1.0
    w = np.zeros((out_size, in_size), dtype=np.float64)
    for i in range(out_size):
        fx = (i + 0.5) * scale - 0.5
        lo = int(math.floor(fx - sup))
        hi = int(math.ceil(fx + sup)) + 1
        taps = np.arange(lo, hi)
        wt = _triangle(taps - fx)
        s = wt.sum()
        if s != 0:
            wt = wt / s
        idx = np.clip(taps, 0, in_size - 1)
        for j, ww in zip(idx, wt):
            w[i, j] += ww
    return w.astype(np.float32)


def resize(img: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """Bilinear resize of a (H, W) image to ``size``; u8 rounds half to
    even and clamps, like the reference."""
    new_h, new_w = size
    h, w = img.shape[-2:]
    wy = torch.from_numpy(_resize_matrix(h, new_h)).to(img.device)
    wx = torch.from_numpy(_resize_matrix(w, new_w)).to(img.device)
    out = torch.matmul(torch.matmul(wy, img.to(torch.float32)), wx.T)
    if img.dtype == torch.uint8:
        return torch.clamp(torch.round(out), 0, 255).to(torch.uint8)
    return out.to(img.dtype)
