"""Intensity enhancement (port of kornia_tpu/ops/enhance.py): weighted sums,
the colour-jitter adjustments, inversion, global histogram equalisation
and CLAHE, entry points with ``device=``.

CLAHE is cv2's (clahe.cpp): per-tile histograms by a scatter-add, cv2's
integer clip and redistribution as the reference writes them
(enhance.py:134-145), per-tile LUTs, then each pixel's four tile LUT
values by a gather and the bilinear blend in the reference's order of
operations (enhance.py:197-201). The reference's one-hot matrix products
(enhance.py:113-190) are exact lookups shaped for a TPU, which gathers at
scalar rate; a gather gives the same values.
"""

from __future__ import annotations

import torch

from kornia_tpu_torch import entry
from kornia_tpu_torch.ops import color as _color
from kornia_tpu_torch.ops.filters import _finalize, div_scalar, index_on
from kornia_tpu_torch.ops.histogram import histogram_u8


@entry
def add_weighted(a: torch.Tensor, alpha: float, b: torch.Tensor,
                 beta: float, gamma: float) -> torch.Tensor:
    """cv2.addWeighted: a·alpha + b·beta + gamma, in a's dtype."""
    out = a.to(torch.float32) * alpha + b.to(torch.float32) * beta + gamma
    return _finalize(out, a.dtype)


def _scale(img: torch.Tensor) -> float:
    return 255.0 if img.dtype == torch.uint8 else 1.0


@entry
def adjust_brightness(img: torch.Tensor, factor: float) -> torch.Tensor:
    """Multiply the intensity by ``factor`` (torchvision's convention)."""
    out = img.to(torch.float32) * factor
    return _finalize(torch.clamp(out, 0.0, _scale(img)), img.dtype)


@entry
def adjust_contrast(img: torch.Tensor, factor: float) -> torch.Tensor:
    """Blend with the mean grayscale value (torchvision's convention)."""
    x = img.to(torch.float32)
    gray = _color.rgb_to_gray(img, device=img.device).to(torch.float32)
    mean = torch.mean(gray)
    out = mean + factor * (x - mean)
    return _finalize(torch.clamp(out, 0.0, _scale(img)), img.dtype)


@entry
def adjust_saturation(img: torch.Tensor, factor: float) -> torch.Tensor:
    x = img.to(torch.float32)
    gray = _color.rgb_to_gray(img, device=img.device).to(torch.float32)
    out = gray + factor * (x - gray)
    return _finalize(torch.clamp(out, 0.0, _scale(img)), img.dtype)


@entry
def adjust_hue(img: torch.Tensor, hue_deg: float) -> torch.Tensor:
    """Rotate the hue by ``hue_deg`` degrees through HSV."""
    hsv = _color.rgb_to_hsv(img, device=img.device)
    if img.dtype == torch.uint8:
        h = torch.remainder(hsv[..., 0].to(torch.float32) + hue_deg / 2.0,
                            180.0)
        h = torch.round(h).to(torch.uint8)
    else:
        h = torch.remainder(hsv[..., 0] + hue_deg, 360.0)
    hsv = torch.cat([h[..., None], hsv[..., 1:]], dim=-1)
    return _color.hsv_to_rgb(hsv, device=img.device)


@entry
def adjust_gamma(img: torch.Tensor, gamma: float, gain: float = 1.0
                 ) -> torch.Tensor:
    scale = _scale(img)
    x = img.to(torch.float32) / scale
    out = gain * x ** gamma
    return _finalize(torch.clamp(out, 0.0, 1.0) * scale, img.dtype)


@entry
def invert(img: torch.Tensor) -> torch.Tensor:
    if img.dtype == torch.uint8:
        return (255 - img.to(torch.int32)).to(torch.uint8)
    return (1.0 - img).to(img.dtype)


@entry
def equalize_hist(gray: torch.Tensor) -> torch.Tensor:
    """Global histogram equalisation of u8 grayscale (cv2.equalizeHist):
    ``lut = round((cdf − cdf_min) / (N − cdf_min) · 255)``."""
    hist = histogram_u8(gray, device=gray.device)
    cdf = torch.cumsum(hist, 0)
    n = gray.numel()
    cdf_min = torch.where(hist > 0, cdf, torch.full_like(cdf, n + 1)).amin()
    denom = torch.clamp(n - cdf_min, min=1)
    lut = torch.clamp(torch.round((cdf - cdf_min).to(torch.float32) / denom
                                  * 255.0), 0, 255)
    return lut.to(torch.uint8)[gray.to(torch.int64)]


@entry
def clahe(gray: torch.Tensor, clip_limit: float = 40.0, grid: tuple = (8, 8)
          ) -> torch.Tensor:
    """Contrast-limited adaptive histogram equalisation of (H, W) u8
    (cv2.createCLAHE), byte-equal to the reference."""
    h, w = gray.shape[:2]
    dev = gray.device
    gy, gx = grid
    th, tw = -(-h // gy), -(-w // gx)            # ceil tile size
    ph, pw = th * gy - h, tw * gx - w
    # cv2 extends to a tile multiple with BORDER_REFLECT_101, at the high
    # ends only
    g = gray.index_select(0, index_on("reflect", h, ph, dev)[ph:])
    g = g.index_select(1, index_on("reflect", w, pw, dev)[pw:])
    tiles = g.reshape(gy, th, gx, tw).permute(0, 2, 1, 3).reshape(
        gy * gx, th * tw).to(torch.int64)

    # (1) per-tile histograms
    ones = torch.ones((), dtype=torch.int32, device=dev).expand(tiles.shape)
    hists = torch.zeros((gy * gx, 256), dtype=torch.int32,
                        device=dev).scatter_add_(1, tiles, ones)

    # (2) cv2's integer clip and redistribution: clip at
    # floor(max(clip·area/256, 1)); excess // 256 to every bin; the
    # remainder +1s bins 0, s, 2s, ... (s = 256 // residual)
    limit = max(int(clip_limit * (th * tw) / 256.0), 1)
    excess = torch.sum(torch.clamp(hists - limit, min=0), dim=1,
                       keepdim=True, dtype=torch.int32)
    hists = torch.clamp(hists, max=limit) + excess // 256
    residual = excess % 256                                   # (T, 1)
    step = torch.clamp(256 // torch.clamp(residual, min=1), min=1)
    idx = torch.arange(256, dtype=torch.int32, device=dev)[None, :]
    is_mult = (idx % step) == 0
    rank = torch.cumsum(is_mult.to(torch.int32), dim=1) - 1
    hists = hists + (is_mult & (rank < residual)).to(torch.int32)
    cdfs = torch.cumsum(hists, dim=1).to(torch.float32)
    luts = torch.clamp(torch.round(cdfs * (255.0 / (th * tw))), 0, 255)

    # (3) the tile pairs and weights of each row (cv2: y·inv_th − 0.5)
    ty = div_scalar(torch.arange(h, dtype=torch.float32, device=dev),
                    th) - 0.5
    y0 = torch.clamp(torch.floor(ty), 0, gy - 1)
    y1 = torch.clamp(y0 + 1, max=gy - 1)
    fy = torch.clamp(ty - y0, 0.0, 1.0)[:, None]
    # ... and of each column, by the reference's half-tile bands: column x
    # lies in band b = (x + tw//2) // tw at offset j, between tiles
    # clip(b − 1) and clip(b)
    lpad = tw // 2
    xp = torch.arange(w, device=dev) + lpad
    band, j = xp // tw, xp % tw
    x0 = torch.clamp(band - 1, 0, gx - 1)
    x1 = torch.clamp(band, 0, gx - 1)
    cols = torch.arange(tw, dtype=torch.float32, device=dev) - lpad
    fx = torch.clamp(div_scalar(cols, tw) + 0.5, 0.0, 1.0)[j][None, :]

    # (4) the four tile LUT values of each pixel, then the blend
    flat = luts.reshape(-1)
    v = gray.to(torch.int64)
    r0 = (y0.to(torch.int64) * gx)[:, None]
    r1 = (y1.to(torch.int64) * gx)[:, None]

    def lookup(row, col):
        return flat[(row + col[None, :]) * 256 + v]

    o00, o01 = lookup(r0, x0), lookup(r0, x1)
    o10, o11 = lookup(r1, x0), lookup(r1, x1)
    top = o00 * (1.0 - fx) + o01 * fx
    bot = o10 * (1.0 - fx) + o11 * fx
    out = top * (1.0 - fy) + bot * fy
    return torch.clamp(torch.round(out), 0, 255).to(torch.uint8)
