"""Resize as two band-matrix products (port of kornia_tpu/ops/resize.py).

``out = Wy @ img @ Wxᵀ`` with (out, in) weight matrices built on the host
with numpy (bilinear, bicubic, lanczos4, area; antialiased PIL-style on
downscale) and cached per device; nearest is a gather along each axis with
cv2's ``floor(dst · in/out)``. The JAX package leaves these products to XLA
(resize.py:177-178, no Pallas kernel), so here they are ``torch.matmul`` in
float32 (TF32 is off, see kornia_tpu_torch/__init__.py). The reference runs
u8 through one bf16 pass on the TPU (resize.py:170-175); on the CPU it and
the port run float32, and the two summation orders can differ by one u8
LSB after rounding.

``resize`` takes tensors and runs where they lie (ORB's pyramid calls it);
``resize_fast`` is the entry point with ``device=``.
"""

from __future__ import annotations

import functools
import math
from typing import Tuple

import numpy as np
import torch

from kornia_tpu_torch import entry


def _triangle(x):
    x = np.abs(x)
    return np.maximum(0.0, 1.0 - x)


def _cubic(x, a=-0.75):
    x = np.abs(x)
    x2 = x * x
    x3 = x2 * x
    return np.where(
        x <= 1.0,
        (a + 2.0) * x3 - (a + 3.0) * x2 + 1.0,
        np.where(x < 2.0, a * (x3 - 5.0 * x2 + 8.0 * x - 4.0), 0.0),
    )


def _lanczos4(x, a=4):
    # cv2's INTER_LANCZOS4 window (a = 4)
    x = np.asarray(x, dtype=np.float64)
    out = np.sinc(x) * np.sinc(x / a)
    return np.where(np.abs(x) < a, out, 0.0)


def _lanczos3(x):
    # PIL's LANCZOS window (a = 3), for antialiased downscales
    return _lanczos4(x, a=3)


_FILTERS = {
    "bilinear": (_triangle, 1.0),
    "bicubic": (_cubic, 2.0),
    "lanczos": (_lanczos4, 4.0),
}
_FILTERS_AA = {**_FILTERS, "lanczos": (_lanczos3, 3.0)}


@functools.lru_cache(maxsize=256)
def _resize_matrix(in_size: int, out_size: int, mode: str = "bilinear",
                   antialias: bool = False) -> np.ndarray:
    """(out_size, in_size) float32 row-stochastic weight matrix
    (resize.py:76-116): cv2 semantics (out-of-range taps clamp to the
    edge), or PIL's with ``antialias`` (taps clipped to the image and
    renormalised, the kernel widened by the downscale factor)."""
    if mode == "area":
        return _area_matrix(in_size, out_size)
    kernel, support = (_FILTERS_AA if antialias else _FILTERS)[mode]
    scale = in_size / out_size
    ksc = scale if antialias and scale > 1.0 else 1.0
    sup = support * ksc
    w = np.zeros((out_size, in_size), dtype=np.float64)
    for i in range(out_size):
        fx = (i + 0.5) * scale - 0.5
        lo = int(math.floor(fx - sup))
        hi = int(math.ceil(fx + sup)) + 1
        taps = np.arange(lo, hi)
        wt = kernel((taps - fx) / ksc)
        if antialias:
            keep = (taps >= 0) & (taps < in_size)
            taps, wt = taps[keep], wt[keep]
            s = wt.sum()
            if s != 0:
                wt = wt / s
            for j, ww in zip(taps, wt):
                w[i, j] += ww
        else:
            s = wt.sum()
            if s != 0:
                wt = wt / s
            idx = np.clip(taps, 0, in_size - 1)
            for j, ww in zip(idx, wt):
                w[i, j] += ww
    return w.astype(np.float32)


def _area_matrix(in_size: int, out_size: int) -> np.ndarray:
    """cv2 INTER_AREA weights: pixel-overlap averaging on downscale,
    bilinear on upscale (resize.py:118-139)."""
    scale = in_size / out_size
    if scale < 1.0:
        return _resize_matrix(in_size, out_size, "bilinear", False)
    w = np.zeros((out_size, in_size), dtype=np.float64)
    for i in range(out_size):
        a, b = i * scale, (i + 1) * scale
        lo, hi = int(math.floor(a)), int(math.ceil(b))
        for j in range(lo, min(hi, in_size)):
            overlap = min(b, j + 1) - max(a, j)
            if overlap > 0:
                w[i, j] = overlap / scale
    s = w.sum(axis=1, keepdims=True)
    return (w / np.where(s == 0, 1.0, s)).astype(np.float32)


@functools.lru_cache(maxsize=256)
def matrix_on(in_size: int, out_size: int, mode: str, antialias: bool,
              device: torch.device) -> torch.Tensor:
    """:func:`_resize_matrix` on ``device``, uploaded once."""
    return torch.from_numpy(_resize_matrix(in_size, out_size, mode,
                                           antialias)).to(device)


@functools.lru_cache(maxsize=256)
def _nearest_on(in_size: int, out_size: int, device: torch.device):
    idx = np.minimum(np.floor(np.arange(out_size) * (in_size / out_size))
                     .astype(np.int64), in_size - 1)
    return torch.from_numpy(idx).to(device)


def resize(img: torch.Tensor, size: Tuple[int, int], mode: str = "bilinear",
           antialias: bool = False) -> torch.Tensor:
    """Resize (H, W) or (..., H, W, C) to ``size`` = (new_h, new_w); mode ∈
    {nearest, bilinear, bicubic, lanczos, area}. Preserves the dtype: u8
    and u16 round half to even and clamp."""
    new_h, new_w = size
    chan = img.ndim >= 3
    x = img if chan else img[..., None]
    h, w = x.shape[-3], x.shape[-2]
    dev = img.device
    if mode == "nearest":
        out = x.index_select(-3, _nearest_on(h, new_h, dev)).index_select(
            -2, _nearest_on(w, new_w, dev))
        return out if chan else out[..., 0]
    wy = matrix_on(h, new_h, mode, antialias, dev)
    wx = matrix_on(w, new_w, mode, antialias, dev)
    # rows, then columns, on (H, W) or (..., C, H, W)
    t = img.to(torch.float32) if not chan else x.to(
        torch.float32).movedim(-1, -3)
    out = torch.matmul(torch.matmul(wy, t), wx.T)
    out = out.movedim(-3, -1) if chan else out[..., None]
    if img.dtype == torch.uint8:
        out = torch.clamp(torch.round(out), 0, 255).to(torch.uint8)
    elif img.dtype == torch.uint16:
        out = torch.clamp(torch.round(out), 0, 65535).to(torch.uint16)
    else:
        out = out.to(img.dtype)
    return out if chan else out[..., 0]


@entry
def resize_fast(img: torch.Tensor, size: Tuple[int, int],
                mode: str = "bilinear") -> torch.Tensor:
    """:func:`resize` without antialiasing (the reference's fast-path
    alias)."""
    return resize(img, size, mode=mode, antialias=False)
