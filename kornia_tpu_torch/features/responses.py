"""Corner responses (port of kornia_tpu/features/responses.py:17-59, the
central-gradient Harris map ORB ranks its FAST corners with)."""

from __future__ import annotations

import torch

from kornia_tpu_torch.ops.filters import (_conv_sep, _replicate_index,
                                          gaussian_kernel1d)


def _grads(gray_f: torch.Tensor, kind: str = "central"):
    """Central differences on an edge-replicated (H, W) image."""
    if kind != "central":
        raise NotImplementedError("only grad='central' is ported so far")
    h, w = gray_f.shape
    dev = gray_f.device
    iy = torch.from_numpy(_replicate_index(h, 1)).to(dev)
    ix = torch.from_numpy(_replicate_index(w, 1)).to(dev)
    p = gray_f.index_select(0, iy).index_select(1, ix)
    gx = 0.5 * (p[1:-1, 2:] - p[1:-1, :-2])
    gy = 0.5 * (p[2:, 1:-1] - p[:-2, 1:-1])
    return gx, gy


def harris_response(gray: torch.Tensor, k: float = 0.04, block_size: int = 5,
                    sigma: float = 1.0, grad: str = "central"
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
