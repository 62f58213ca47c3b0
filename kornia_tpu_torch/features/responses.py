"""Corner and blob responses (port of kornia_tpu/features/responses.py:
Harris dense and at keypoints, Shi-Tomasi, det(Hessian), DoG).

``harris_at_windows`` evaluates the structure tensor on keypoint windows cut
by ``cuda_kernels.windows``; the imports of ``cuda_kernels`` are inside the
functions because that module imports this one for its plain versions."""

from __future__ import annotations

import numpy as np
import torch

from kornia_tpu_torch import entry
from kornia_tpu_torch.ops.filters import (_conv_sep, gaussian_kernel1d,
                                          index_on, sobel)


def _grads(gray_f: torch.Tensor, kind: str = "sobel"):
    """(gx, gy) of an (H, W) image: 3×3 Sobel, or central differences on the
    edge-replicated image for ``kind="central"``."""
    if kind != "central":
        return sobel(gray_f, 1, 0), sobel(gray_f, 0, 1)
    h, w = gray_f.shape
    dev = gray_f.device
    p = gray_f.index_select(0, index_on("replicate", h, 1, dev)).index_select(
        1, index_on("replicate", w, 1, dev))
    gx = 0.5 * (p[1:-1, 2:] - p[1:-1, :-2])
    gy = 0.5 * (p[2:, 1:-1] - p[:-2, 1:-1])
    return gx, gy


def _window_kernel(block_size: int, sigma: float, window: str) -> np.ndarray:
    if window == "box":
        # cv2.cornerHarris semantics: box sum over blockSize
        return np.ones(block_size, np.float32)
    return gaussian_kernel1d(block_size, sigma)


def harris_response(gray: torch.Tensor, k: float = 0.04, block_size: int = 5,
                    sigma: float = 1.0, window: str = "gaussian",
                    grad: str = "sobel") -> torch.Tensor:
    """Harris cornerness det(M) − k·tr(M)² on (H, W), float32, with a
    Gaussian window or, for ``window="box"``, cv2.cornerHarris's box sum."""
    x = gray.to(torch.float32)
    gx, gy = _grads(x, grad)
    kern = _window_kernel(block_size, sigma, window)
    sxx = _conv_sep((gx * gx)[..., None], kern, kern)[..., 0]
    syy = _conv_sep((gy * gy)[..., None], kern, kern)[..., 0]
    sxy = _conv_sep((gx * gy)[..., None], kern, kern)[..., 0]
    det = sxx * syy - sxy * sxy
    tr = sxx + syy
    return det - k * tr * tr


@entry
def shi_tomasi_response(gray: torch.Tensor, block_size: int = 5,
                        sigma: float = 1.0) -> torch.Tensor:
    """GFTT / minimum-eigenvalue response of the Gaussian-windowed
    structure tensor of the Sobel gradients."""
    x = gray.to(torch.float32)
    gx, gy = _grads(x)
    kern = gaussian_kernel1d(block_size, sigma)
    sxx = _conv_sep((gx * gx)[..., None], kern, kern)[..., 0]
    syy = _conv_sep((gy * gy)[..., None], kern, kern)[..., 0]
    sxy = _conv_sep((gx * gy)[..., None], kern, kern)[..., 0]
    half_tr = 0.5 * (sxx + syy)
    disc = torch.sqrt(torch.clamp(half_tr * half_tr - (sxx * syy - sxy * sxy),
                                  min=0.0))
    return half_tr - disc


@entry
def hessian_response(gray: torch.Tensor) -> torch.Tensor:
    """det(Hessian) blob response, central second differences on the
    edge-replicated image."""
    x = gray.to(torch.float32)
    h, w = x.shape
    dev = x.device
    p = x.index_select(0, index_on("replicate", h, 1, dev)).index_select(
        1, index_on("replicate", w, 1, dev))

    def c(dy, dx):
        return p[1 + dy: 1 + dy + h, 1 + dx: 1 + dx + w]

    dxx = c(0, 1) - 2.0 * x + c(0, -1)
    dyy = c(1, 0) - 2.0 * x + c(-1, 0)
    dxy = 0.25 * (c(1, 1) - c(1, -1) - c(-1, 1) + c(-1, -1))
    return dxx * dyy - dxy * dxy


@entry
def dog_response(gray: torch.Tensor, sigma1: float = 1.0, sigma2: float = 1.6,
                 ksize: int = 9) -> torch.Tensor:
    """Difference of Gaussians, the wider blur minus the narrower."""
    x = gray.to(torch.float32)[..., None]
    k1 = gaussian_kernel1d(ksize, sigma1)
    k2 = gaussian_kernel1d(ksize, sigma2)
    return (_conv_sep(x, k2, k2) - _conv_sep(x, k1, k1))[..., 0]


def harris_at(gray: torch.Tensor, xy: torch.Tensor, k: float = 0.04,
              block_size: int = 7) -> torch.Tensor:
    """The dense Sobel-gradient Harris response sampled at (N, 2) keypoints
    (truncated to integers, clipped to the image)."""
    resp = harris_response(gray, k=k, block_size=block_size)
    ix = torch.clamp(xy[:, 0].to(torch.int64), 0, gray.shape[1] - 1)
    iy = torch.clamp(xy[:, 1].to(torch.int64), 0, gray.shape[0] - 1)
    return resp[iy, ix]


def harris_at_windows(gray_f: torch.Tensor, xy_int: torch.Tensor,
                      k: float = 0.04, block_size: int = 5,
                      sigma: float = 1.0) -> torch.Tensor:
    """Harris response at (N, 2) int32 keypoints from per-keypoint windows
    instead of a dense map: the structure tensor of
    ``harris_response(grad="central")`` restricted to a (block + 2)² patch,
    ranking-consistent with the dense map away from the borders."""
    from kornia_tpu_torch.ops import cuda_kernels as ck

    r = block_size // 2 + 1                  # + gradient halo
    win = ck.windows(gray_f.to(torch.float32).contiguous(),
                     xy_int.contiguous())    # (N, 48, 128)
    patch = win[:, 24 - r: 24 + r + 1, 64 - r: 64 + r + 1]
    gx = 0.5 * (patch[:, 1:-1, 2:] - patch[:, 1:-1, :-2])
    gy = 0.5 * (patch[:, 2:, 1:-1] - patch[:, :-2, 1:-1])
    w1 = gaussian_kernel1d(block_size, sigma)
    w2 = torch.from_numpy(np.outer(w1, w1).astype(np.float32)).to(win.device)
    sxx = torch.sum(gx * gx * w2, dim=(1, 2))
    syy = torch.sum(gy * gy * w2, dim=(1, 2))
    sxy = torch.sum(gx * gy * w2, dim=(1, 2))
    det = sxx * syy - sxy * sxy
    tr = sxx + syy
    return det - k * tr * tr
