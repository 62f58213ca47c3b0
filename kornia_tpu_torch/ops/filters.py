"""Spatial filtering (port of kornia_tpu/ops/filters.py).

The separable convolution keeps the reference's shift-add form and order
(filters.py:72-79): vertical taps ascending, then horizontal, the first term
assigned and the rest added, each product rounded to float32 before its add.
``conv2d`` would go through cuDNN and change both the order and the precision.
Images are (..., H, W, C), the reference's layout, or (H, W).

``gaussian_blur`` and ``sobel`` take tensors and run where they lie (ORB,
Harris and the pyramids call them); the functions added with the rest of
the module are entry points with ``device=``. Pad indices are cached per
device: an upload from the host waits for the device.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from kornia_tpu_torch import entry

# cv2's small_gaussian_tab: fixed kernels used when sigma <= 0
_CV2_FIXED_GAUSS = {
    1: np.array([1.0], np.float32),
    3: np.array([0.25, 0.5, 0.25], np.float32),
    5: np.array([0.0625, 0.25, 0.375, 0.25, 0.0625], np.float32),
    7: np.array([0.03125, 0.109375, 0.21875, 0.28125, 0.21875, 0.109375,
                 0.03125], np.float32),
}


def gaussian_kernel1d(ksize: int, sigma: float) -> np.ndarray:
    """cv2.getGaussianKernel-compatible 1-D kernel (float64→float32)."""
    if sigma <= 0 and ksize in _CV2_FIXED_GAUSS:
        return _CV2_FIXED_GAUSS[ksize]
    if sigma <= 0:
        sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
    x = np.arange(ksize, dtype=np.float64) - (ksize - 1) * 0.5
    k = np.exp(-(x * x) / (2.0 * sigma * sigma))
    return (k / k.sum()).astype(np.float32)


def _reflect101_index(n: int, p: int) -> np.ndarray:
    """Indices of an axis of n padded by p on each side, reflected about
    the end pixels as often as p needs (numpy's "reflect", the reference's
    jnp.pad): n = 1 repeats its pixel, n = 2 alternates."""
    i = np.arange(-p, n + p)
    if n == 1:
        return np.zeros_like(i)
    i = np.mod(i, 2 * (n - 1))
    return np.where(i > n - 1, 2 * (n - 1) - i, i)


def _replicate_index(n: int, p: int) -> np.ndarray:
    return np.clip(np.arange(-p, n + p), 0, n - 1)


_INDEX = {"reflect": _reflect101_index, "replicate": _replicate_index}


@functools.lru_cache(maxsize=512)
def index_on(kind: str, n: int, p: int, device: torch.device
             ) -> torch.Tensor:
    """The padded-axis indices of ``kind`` ("reflect" or "replicate") as
    an int64 tensor on ``device``, made once per (kind, n, p, device)."""
    return torch.from_numpy(_INDEX[kind](n, p)).to(device)


@functools.lru_cache(maxsize=256)
def const_on(values, device: torch.device,
             dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """A small constant (a number, or filter taps, colour rows or a LUT as
    nested tuples) as a tensor on ``device``, made once per device."""
    return torch.tensor(values, dtype=dtype).to(device)


def div_scalar(t: torch.Tensor, c: float) -> torch.Tensor:
    """``t / c`` as a true division on every device: ATen computes a
    tensor over a Python number on the card as ``t · (1/c)``, one rounding
    more; a 0-dim tensor on the device is divided by."""
    return t / const_on(float(c), t.device)


def _pad_index(x: torch.Tensor, kind: str, ph: int, pw: int):
    h, w = x.shape[-3], x.shape[-2]
    x = x.index_select(-3, index_on(kind, h, ph, x.device))
    return x.index_select(-2, index_on(kind, w, pw, x.device))


def _pad_reflect101(x: torch.Tensor, ph: int, pw: int) -> torch.Tensor:
    """Pad (..., H, W, C) spatially with cv2 BORDER_REFLECT_101."""
    if ph == 0 and pw == 0:
        return x
    return _pad_index(x, "reflect", ph, pw)


def _pad_replicate(x: torch.Tensor, ph: int, pw: int) -> torch.Tensor:
    return _pad_index(x, "replicate", ph, pw)


_PAD = {"reflect": _pad_reflect101, "replicate": _pad_replicate}


def _conv_sep(x: torch.Tensor, ky: np.ndarray, kx: np.ndarray,
              border: str = "reflect") -> torch.Tensor:
    """Depthwise separable 2-D convolution of (..., H, W, C), float32 out."""
    h, w = x.shape[-3], x.shape[-2]
    xf = _PAD[border](x.to(torch.float32), len(ky) // 2, len(kx) // 2)
    out = None
    for i, kv in enumerate(np.asarray(ky, np.float32)):
        term = xf[..., i: i + h, :, :] * float(kv)
        out = term if out is None else out + term
    out2 = None
    for j, kv in enumerate(np.asarray(kx, np.float32)):
        term = out[..., :, j: j + w, :] * float(kv)
        out2 = term if out2 is None else out2 + term
    return out2


def _finalize(out: torch.Tensor, dtype) -> torch.Tensor:
    if dtype == torch.uint8:
        return torch.clamp(torch.round(out), 0, 255).to(torch.uint8)
    if dtype == torch.uint16:
        return torch.clamp(torch.round(out), 0, 65535).to(torch.uint16)
    return out.to(dtype)


def _with_channels(img: torch.Tensor):
    if img.ndim == 2:
        return img[..., None], True
    return img, False


def gaussian_blur(img: torch.Tensor, ksize: Tuple[int, int],
                  sigma: Tuple[float, float] | float = 0.0,
                  border: str = "reflect") -> torch.Tensor:
    """cv2.GaussianBlur semantics on (H, W) or (..., H, W, C); preserves
    dtype (u8 rounds)."""
    squeeze = img.ndim == 2
    x = img[..., None] if squeeze else img
    if isinstance(sigma, (int, float)):
        sigma = (float(sigma), float(sigma))
    ky = gaussian_kernel1d(ksize[1], sigma[1])  # vertical uses ksize_y
    kx = gaussian_kernel1d(ksize[0], sigma[0])
    out = _finalize(_conv_sep(x, ky, kx, border), img.dtype)
    return out[..., 0] if squeeze else out


# cv2.getDerivKernels first-order pairs (deriv, smooth) per aperture
_SOBEL = {
    1: (np.array([-1.0, 0.0, 1.0], np.float32),
        np.array([1.0], np.float32)),
    3: (np.array([-1.0, 0.0, 1.0], np.float32),
        np.array([1.0, 2.0, 1.0], np.float32)),
    5: (np.array([-1.0, -2.0, 0.0, 2.0, 1.0], np.float32),
        np.array([1.0, 4.0, 6.0, 4.0, 1.0], np.float32)),
    7: (np.array([-1.0, -4.0, -5.0, 0.0, 5.0, 4.0, 1.0], np.float32),
        np.array([1.0, 6.0, 15.0, 20.0, 15.0, 6.0, 1.0], np.float32)),
}


def sobel(img: torch.Tensor, dx: int, dy: int, ksize: int = 3
          ) -> torch.Tensor:
    """First-order Sobel derivative of (H, W) or (..., H, W, C), float32
    (cv2.Sobel CV_32F), apertures 1/3/5/7."""
    if ksize not in _SOBEL:
        raise ValueError(f"sobel ksize must be one of {sorted(_SOBEL)}, "
                         f"got {ksize}")
    squeeze = img.ndim == 2
    x = img[..., None] if squeeze else img
    deriv, smooth = _SOBEL[ksize]
    out = _conv_sep(x, deriv if dy else smooth, deriv if dx else smooth,
                    "reflect")
    return out[..., 0] if squeeze else out


@entry
def box_blur(img: torch.Tensor, ksize: Tuple[int, int],
             border: str = "reflect") -> torch.Tensor:
    """Normalised box filter (cv2.blur); preserves dtype (u8 rounds)."""
    x, squeeze = _with_channels(img)
    ky = np.full(ksize[1], 1.0 / ksize[1], np.float32)
    kx = np.full(ksize[0], 1.0 / ksize[0], np.float32)
    out = _finalize(_conv_sep(x, ky, kx, border), img.dtype)
    return out[..., 0] if squeeze else out


@entry
def spatial_gradient(img: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(gx, gy) float32 3×3 Sobel gradients."""
    return sobel(img, 1, 0), sobel(img, 0, 1)


@entry
def laplacian(img: torch.Tensor, ksize: int = 3) -> torch.Tensor:
    """The 4-neighbour Laplacian, float32, reflect-101 borders."""
    x, squeeze = _with_channels(img)
    p = _pad_reflect101(x.to(torch.float32), 1, 1)
    out = (p[..., :-2, 1:-1, :] + p[..., 2:, 1:-1, :] + p[..., 1:-1, :-2, :]
           + p[..., 1:-1, 2:, :] - 4.0 * p[..., 1:-1, 1:-1, :])
    return out[..., 0] if squeeze else out


@entry
def filter2d(img: torch.Tensor, kernel, border: str = "reflect"
             ) -> torch.Tensor:
    """General 2-D correlation with a (kh, kw) kernel (cv2.filter2D), as
    shifted adds in row-major tap order; preserves dtype."""
    x, squeeze = _with_channels(img)
    kf = torch.as_tensor(kernel, dtype=torch.float32).to(x.device)
    kh, kw = kf.shape
    h, w = x.shape[-3], x.shape[-2]
    xf = _PAD[border](x.to(torch.float32), kh // 2, kw // 2)
    out = None
    for dy in range(kh):
        for dx in range(kw):
            term = xf[..., dy: dy + h, dx: dx + w, :] * kf[dy, dx]
            out = term if out is None else out + term
    out = _finalize(out, img.dtype)
    return out[..., 0] if squeeze else out


def _extract_patches(x: torch.Tensor, k: int, border: str = "reflect"
                     ) -> torch.Tensor:
    """(..., H, W, C) → (..., H, W, C, k·k) static-offset patch stack."""
    p = _PAD[border](x, k // 2, k // 2)
    h, w = x.shape[-3], x.shape[-2]
    return torch.stack([p[..., dy: dy + h, dx: dx + w, :]
                        for dy in range(k) for dx in range(k)], dim=-1)


def _median9_network(p):
    """Paeth's 19-exchange median-of-9 network over 9 same-shape tensors
    (filters.py:193-214)."""
    p = list(p)

    def s(i, j):
        p[i], p[j] = torch.minimum(p[i], p[j]), torch.maximum(p[i], p[j])

    for i, j in ((1, 2), (4, 5), (7, 8), (0, 1), (3, 4), (6, 7), (1, 2),
                 (4, 5), (7, 8), (0, 3), (5, 8), (4, 7), (3, 6), (1, 4),
                 (2, 5), (4, 7), (4, 2), (6, 4), (4, 2)):
        s(i, j)
    return p[4]


# a (rows, W, C, k²) patch chunk of a large median / bilateral stays under
# this many elements
_PATCH_ELEMS = 1 << 26


def _row_chunks(x: torch.Tensor, k: int, fn):
    """``fn(padded rows, first row, rows)`` over row chunks of a
    (N, H, W, C) image whose patch stacks stay under _PATCH_ELEMS
    elements, concatenated along H: a 1080p RGB bilateral at d = 9 is 2 GB
    of float32 patches in one piece."""
    n, h, w, c = x.shape
    rows = max(1, _PATCH_ELEMS // max(1, n * w * c * k * k))
    return torch.cat([fn(y0, min(rows, h - y0)) for y0 in range(0, h, rows)],
                     dim=1)


@entry
def median_blur(img: torch.Tensor, ksize: int) -> torch.Tensor:
    """Median filter with replicated borders: the 19-exchange network for
    ksize 3, the median over the patch axis otherwise (ksize odd, so the
    lower middle value ``torch.median`` returns is the median)."""
    x, squeeze = _with_channels(img)
    lead = x.shape[:-3]
    xr = x.reshape((-1,) + x.shape[-3:])
    h, w = xr.shape[1], xr.shape[2]
    if ksize == 3:
        p = _pad_replicate(xr, 1, 1)
        med = _median9_network([p[..., dy: dy + h, dx: dx + w, :]
                                for dy in range(3) for dx in range(3)])
    else:
        r = ksize // 2
        p = _pad_replicate(xr, r, r)

        def part(y0, n):
            rows = p[:, y0: y0 + n + 2 * r]
            patches = torch.stack(
                [rows[:, dy: dy + n, dx: dx + w, :]
                 for dy in range(ksize) for dx in range(ksize)], dim=-1)
            return torch.median(patches, dim=-1).values

        med = _row_chunks(xr, ksize, part)
    out = med.to(img.dtype).reshape(lead + x.shape[-3:])
    return out[..., 0] if squeeze else out


@entry
def bilateral_blur(img: torch.Tensor, d: int, sigma_color: float,
                   sigma_space: float) -> torch.Tensor:
    """cv2.bilateralFilter semantics: a circular window of diameter ``d``
    (from ``sigma_space`` when d ≤ 0), replicated borders, the patch sums
    in the reference's tap order; run in row chunks."""
    x, squeeze = _with_channels(img)
    lead = x.shape[:-3]
    xr = x.to(torch.float32).reshape((-1,) + x.shape[-3:])
    if d <= 0:
        d = int(round(sigma_space * 1.5)) * 2 + 1
    r = d // 2
    yy, xx = np.mgrid[-r: r + 1, -r: r + 1]
    space_w = np.exp(-(xx * xx + yy * yy)
                     / (2.0 * sigma_space * sigma_space)).astype(np.float32)
    space_w = space_w * ((xx * xx + yy * yy) <= r * r)
    sw = const_on(tuple(float(v) for v in space_w.reshape(-1)), xr.device)
    h, w = xr.shape[1], xr.shape[2]
    p = _pad_replicate(xr, r, r)
    two_sc2 = 2.0 * sigma_color * sigma_color

    def part(y0, n):
        rows = p[:, y0: y0 + n + 2 * r]
        patches = torch.stack([rows[:, dy: dy + n, dx: dx + w, :]
                               for dy in range(d) for dx in range(d)],
                              dim=-1)
        diff = patches - xr[:, y0: y0 + n, :, :, None]
        wgt = torch.exp(-(diff * diff) / two_sc2) * sw
        return torch.sum(patches * wgt, dim=-1) / torch.sum(wgt, dim=-1)

    out = _row_chunks(xr, d, part).reshape(lead + x.shape[-3:])
    out = _finalize(out, img.dtype)
    return out[..., 0] if squeeze else out
