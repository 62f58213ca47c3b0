"""Thresholding (port of kornia_tpu/ops/threshold.py): the five fixed
thresholds, Otsu's threshold and adaptive thresholds, entry points with
``device=``."""

from __future__ import annotations

import torch

from kornia_tpu_torch import entry
from kornia_tpu_torch.ops.filters import box_blur, gaussian_blur
from kornia_tpu_torch.ops.histogram import histogram_u8


@entry
def threshold_binary(img: torch.Tensor, thresh: float, maxval: float
                     ) -> torch.Tensor:
    return torch.where(img.to(torch.float32) > thresh, maxval, 0.0).to(
        img.dtype)


@entry
def threshold_binary_inverse(img: torch.Tensor, thresh: float,
                             maxval: float) -> torch.Tensor:
    return torch.where(img.to(torch.float32) > thresh, 0.0, maxval).to(
        img.dtype)


@entry
def threshold_truncate(img: torch.Tensor, thresh: float) -> torch.Tensor:
    # the reference casts the threshold to the image's type first
    return torch.clamp(img, max=torch.tensor(thresh).to(img.dtype).item())


@entry
def threshold_to_zero(img: torch.Tensor, thresh: float) -> torch.Tensor:
    return torch.where(img.to(torch.float32) > thresh, img, 0)


@entry
def threshold_to_zero_inverse(img: torch.Tensor, thresh: float
                              ) -> torch.Tensor:
    return torch.where(img.to(torch.float32) > thresh, 0, img)


@entry
def otsu_threshold(gray: torch.Tensor) -> torch.Tensor:
    """Otsu's threshold of u8 grayscale: a 0-dim float32 tensor on the
    image's device (the first bin of the largest between-class variance;
    nothing is read back)."""
    hist = histogram_u8(gray, device=gray.device).to(torch.float32)
    p = hist / torch.sum(hist)
    bins = torch.arange(256, dtype=torch.float32, device=gray.device)
    w0 = torch.cumsum(p, 0)
    mu = torch.cumsum(p * bins, 0)
    w1 = 1.0 - w0
    both = (w0 > 0) & (w1 > 0)
    denom = torch.where(both, w0 * w1, torch.ones_like(w0))
    sigma_b = torch.where(both, (mu[-1] * w0 - mu) ** 2 / denom,
                          torch.zeros_like(w0))
    return torch.argmax(sigma_b).to(torch.float32)


@entry
def adaptive_threshold(gray: torch.Tensor, maxval: float = 255.0,
                       method: str = "mean", block_size: int = 11,
                       c: float = 2.0, inverse: bool = False
                       ) -> torch.Tensor:
    """cv2.adaptiveThreshold: compare with the mean or Gaussian-weighted
    neighbourhood (replicated borders) minus ``c``."""
    x = gray.to(torch.float32)[..., None]
    if method == "mean":
        m = box_blur(x, (block_size, block_size), border="replicate",
                     device=x.device)[..., 0]
    elif method == "gaussian":
        m = gaussian_blur(x, (block_size, block_size), 0.0,
                          border="replicate")[..., 0]
    else:
        raise ValueError(method)
    cond = gray.to(torch.float32) > (m - c)
    if inverse:
        cond = ~cond
    return torch.where(cond, maxval, 0.0).to(gray.dtype)
