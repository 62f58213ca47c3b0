"""Separable filtering (port of kornia_tpu/ops/filters.py, the part ORB,
Harris and the pyramids use: Gaussian blur and Sobel derivatives).

The separable convolution keeps the reference's shift-add form and order
(filters.py:72-79): vertical taps ascending, then horizontal, the first term
assigned and the rest added, each product rounded to float32 before its add.
``conv2d`` would go through cuDNN and change both the order and the precision.
Images are (..., H, W, C), the reference's layout.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

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


def _pad_index(x: torch.Tensor, iy: np.ndarray, ix: np.ndarray):
    dev = x.device
    x = x.index_select(-3, torch.from_numpy(iy).to(dev))
    return x.index_select(-2, torch.from_numpy(ix).to(dev))


def _pad_reflect101(x: torch.Tensor, ph: int, pw: int) -> torch.Tensor:
    """Pad (..., H, W, C) spatially with cv2 BORDER_REFLECT_101."""
    if ph == 0 and pw == 0:
        return x
    h, w = x.shape[-3], x.shape[-2]
    return _pad_index(x, _reflect101_index(h, ph), _reflect101_index(w, pw))


def _pad_replicate(x: torch.Tensor, ph: int, pw: int) -> torch.Tensor:
    h, w = x.shape[-3], x.shape[-2]
    return _pad_index(x, _replicate_index(h, ph), _replicate_index(w, pw))


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
    return out.to(dtype)


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
