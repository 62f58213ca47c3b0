"""Image-pair error metrics (port of kornia_tpu/ops/metrics.py): each
returns a 0-dim float32 tensor on the images' device (nothing is read
back); entry points with ``device=``."""

from __future__ import annotations

import torch

from kornia_tpu_torch import entry
from kornia_tpu_torch.ops.filters import _conv_sep, gaussian_kernel1d


def _diff(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a.to(torch.float32) - b.to(torch.float32)


@entry
def mse(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    d = _diff(a, b)
    return torch.mean(d * d)


@entry
def l1(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(_diff(a, b)))


@entry
def huber(a: torch.Tensor, b: torch.Tensor, delta: float = 1.0
          ) -> torch.Tensor:
    d = torch.abs(_diff(a, b))
    quad = 0.5 * d * d
    lin = delta * (d - 0.5 * delta)
    return torch.mean(torch.where(d <= delta, quad, lin))


@entry
def psnr(a: torch.Tensor, b: torch.Tensor, max_val: float = 255.0
         ) -> torch.Tensor:
    m = torch.clamp(mse(a, b, device=a.device), min=1e-12)
    return 10.0 * torch.log10(torch.full_like(m, max_val * max_val) / m)


@entry
def ssim(a: torch.Tensor, b: torch.Tensor, max_val: float = 255.0,
         ksize: int = 11, sigma: float = 1.5) -> torch.Tensor:
    """Mean SSIM with a Gaussian window (Wang et al. 2004)."""

    def prep(x):
        x = x.to(torch.float32)
        return x[..., None] if x.ndim == 2 else x

    x, y = prep(a), prep(b)
    k = gaussian_kernel1d(ksize, sigma)
    c1 = (0.01 * max_val) ** 2
    c2 = (0.03 * max_val) ** 2
    mu_x = _conv_sep(x, k, k)
    mu_y = _conv_sep(y, k, k)
    sxx = _conv_sep(x * x, k, k) - mu_x * mu_x
    syy = _conv_sep(y * y, k, k) - mu_y * mu_y
    sxy = _conv_sep(x * y, k, k) - mu_x * mu_y
    num = (2 * mu_x * mu_y + c1) * (2 * sxy + c2)
    den = (mu_x * mu_x + mu_y * mu_y + c1) * (sxx + syy + c2)
    return torch.mean(num / den)
