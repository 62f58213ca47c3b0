"""Interpolation samplers and remap (port of kornia_tpu/ops/interpolation.py).

``grid_sample`` gathers pixels at arbitrary (x, y) pixel coordinates (cv2
convention: pixel centres at integers). It is the gather route, which no
Pallas kernel carries in the JAX package either, so it stays plain PyTorch
on every device. ``remap`` with bilinear or nearest sampling and zeros or
border padding goes to the K7 kernel (ops/warp_exact.remap_exact), as the
TPU route does; other modes go through ``grid_sample``.
"""

from __future__ import annotations

from typing import Tuple

import torch

from kornia_tpu_torch import resolve_device, to_device
from kornia_tpu_torch.ops.warp_exact import _finalize, remap_exact


def _gather_hw(img: torch.Tensor, iy: torch.Tensor,
               ix: torch.Tensor) -> torch.Tensor:
    """img[iy, ix, :] for (H, W, C) img and (Ho, Wo) integer maps →
    (Ho, Wo, C)."""
    h, w, c = img.shape
    idx = iy.to(torch.int64) * w + ix.to(torch.int64)
    return img.reshape(h * w, c)[idx.reshape(-1)].reshape(idx.shape + (c,))


def _clamp_coords(iy, ix, h: int, w: int):
    return torch.clamp(iy, 0, h - 1), torch.clamp(ix, 0, w - 1)


def _cubic_kernel(x: torch.Tensor, a: float = -0.75) -> torch.Tensor:
    """Keys cubic convolution kernel (cv2 uses a = -0.75)."""
    ax = torch.abs(x)
    ax2 = ax * ax
    ax3 = ax2 * ax
    w1 = (a + 2.0) * ax3 - (a + 3.0) * ax2 + 1.0
    w2 = a * ax3 - 5.0 * a * ax2 + 8.0 * a * ax - 4.0 * a
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    return torch.where(ax <= 1.0, w1, torch.where(ax < 2.0, w2, zero))


def grid_sample(img, x, y, mode: str = "bilinear",
                padding_mode: str = "zeros", fill_value: float = 0.0,
                device="cuda") -> torch.Tensor:
    """Sample (H, W, C) ``img`` at pixel coordinates (x, y), each (Ho, Wo).

    padding_mode "zeros" fills out-of-bounds taps with ``fill_value`` (cv2
    BORDER_CONSTANT); "border" clamps each tap (BORDER_REPLICATE). Returns
    (Ho, Wo, C) float32."""
    dev = resolve_device(device)
    img = to_device(img, dev)
    h, w, _ = img.shape
    imgf = img.to(torch.float32)
    x = to_device(x, dev, torch.float32)
    y = to_device(y, dev, torch.float32)
    fill = torch.tensor(fill_value, dtype=torch.float32, device=dev)

    if mode == "nearest":
        ix = torch.round(x).to(torch.int64)
        iy = torch.round(y).to(torch.int64)
        inb = (ix >= 0) & (ix <= w - 1) & (iy >= 0) & (iy <= h - 1)
        cy, cx = _clamp_coords(iy, ix, h, w)
        out = _gather_hw(imgf, cy, cx)
        if padding_mode == "zeros":
            out = torch.where(inb[..., None], out, fill)
        return out

    if mode == "bilinear":
        taps = [(dy, dx) for dy in (0, 1) for dx in (0, 1)]
        x0 = torch.floor(x)
        y0 = torch.floor(y)
        fx = x - x0
        fy = y - y0
        x0i = x0.to(torch.int64)
        y0i = y0.to(torch.int64)
        wx = (1.0 - fx, fx)
        wy = (1.0 - fy, fy)
    elif mode == "bicubic":
        taps = [(dy, dx) for dy in range(-1, 3) for dx in range(-1, 3)]
        x0i = torch.floor(x).to(torch.int64)
        y0i = torch.floor(y).to(torch.int64)
        fx = x - torch.floor(x)
        fy = y - torch.floor(y)
        wx = {d: _cubic_kernel(fx - d) for d in range(-1, 3)}
        wy = {d: _cubic_kernel(fy - d) for d in range(-1, 3)}
    else:
        raise ValueError(f"unknown interpolation mode: {mode}")

    acc = None
    for dy, dx in taps:
        wgt = wx[dx] * wy[dy]
        iy, ix = y0i + dy, x0i + dx
        cy, cx = _clamp_coords(iy, ix, h, w)
        v = _gather_hw(imgf, cy, cx)
        if padding_mode == "zeros":
            inb = (ix >= 0) & (ix <= w - 1) & (iy >= 0) & (iy <= h - 1)
            v = torch.where(inb[..., None], v, fill)
        term = v * wgt[..., None]
        acc = term if acc is None else acc + term
    return acc


def remap(img, map_x, map_y, mode: str = "bilinear",
          padding_mode: str = "zeros", fill_value: float = 0.0,
          nsel: int = 8, device="cuda") -> torch.Tensor:
    """cv2.remap: dst(i, j) = src(map_y(i, j), map_x(i, j)) for (H, W) or
    (H, W, C) ``img``; preserves the dtype (u8 rounds half to even and
    clamps).

    Bilinear or nearest with zeros or border padding runs the K7 kernel
    (:func:`kornia_tpu_torch.ops.warp_exact.remap_exact`); other modes go
    through :func:`grid_sample`. ``nsel`` sized the TPU kernel's per-chunk
    row-candidate budget; the port's per-pixel kernel takes every map
    directly, so it is accepted and ignored."""
    del nsel
    dev = resolve_device(device)
    if (mode in ("bilinear", "nearest")
            and padding_mode in ("zeros", "border")):
        return remap_exact(img, map_x, map_y, mode=mode,
                           padding_mode=padding_mode, fill_value=fill_value,
                           device=dev)
    img = to_device(img, dev)
    squeeze = img.ndim == 2
    x = img[..., None] if squeeze else img
    out = grid_sample(x, map_x, map_y, mode=mode, padding_mode=padding_mode,
                      fill_value=fill_value, device=dev)
    out = _finalize(out, img.dtype)
    return out[..., 0] if squeeze else out


def meshgrid_pixel(h: int, w: int, device="cuda"
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(x, y) pixel-centre coordinate maps of shape (h, w), float32."""
    dev = resolve_device(device)
    yy, xx = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=dev),
                            torch.arange(w, dtype=torch.float32, device=dev),
                            indexing="ij")
    return xx, yy
