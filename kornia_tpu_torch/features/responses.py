"""Corner responses (port of kornia_tpu/features/responses.py: the Harris
map, dense and at keypoints).

``harris_at_windows`` evaluates the structure tensor on keypoint windows cut
by ``cuda_kernels.windows``; the imports of ``cuda_kernels`` are inside the
functions because that module imports this one for its plain versions."""

from __future__ import annotations

import numpy as np
import torch

from kornia_tpu_torch.ops.filters import (_conv_sep, _replicate_index,
                                          gaussian_kernel1d, sobel)


def _grads(gray_f: torch.Tensor, kind: str = "sobel"):
    """(gx, gy) of an (H, W) image: 3×3 Sobel, or central differences on the
    edge-replicated image for ``kind="central"``."""
    if kind != "central":
        return sobel(gray_f, 1, 0), sobel(gray_f, 0, 1)
    h, w = gray_f.shape
    dev = gray_f.device
    iy = torch.from_numpy(_replicate_index(h, 1)).to(dev)
    ix = torch.from_numpy(_replicate_index(w, 1)).to(dev)
    p = gray_f.index_select(0, iy).index_select(1, ix)
    gx = 0.5 * (p[1:-1, 2:] - p[1:-1, :-2])
    gy = 0.5 * (p[2:, 1:-1] - p[:-2, 1:-1])
    return gx, gy


def harris_response(gray: torch.Tensor, k: float = 0.04, block_size: int = 5,
                    sigma: float = 1.0, grad: str = "sobel"
                    ) -> torch.Tensor:
    """Harris cornerness det(M) − k·tr(M)² on (H, W), float32, with a
    Gaussian window (the reference's ``window="box"`` is not ported)."""
    x = gray.to(torch.float32)
    gx, gy = _grads(x, grad)
    kern = gaussian_kernel1d(block_size, sigma)
    sxx = _conv_sep((gx * gx)[..., None], kern, kern)[..., 0]
    syy = _conv_sep((gy * gy)[..., None], kern, kern)[..., 0]
    sxy = _conv_sep((gx * gy)[..., None], kern, kern)[..., 0]
    det = sxx * syy - sxy * sxy
    tr = sxx + syy
    return det - k * tr * tr


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
