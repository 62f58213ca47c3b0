"""Flips, crops and padding (port of kornia_tpu/ops/geometry_utils.py),
entry points with ``device=``. Images are (H, W) or (..., H, W, C)."""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from kornia_tpu_torch import entry
from kornia_tpu_torch.ops.filters import index_on


def _hw_axes(img: torch.Tensor):
    return (-3, -2) if img.ndim >= 3 else (-2, -1)


@entry
def hflip(img: torch.Tensor) -> torch.Tensor:
    """Mirror the columns."""
    return img.flip(_hw_axes(img)[1])


@entry
def vflip(img: torch.Tensor) -> torch.Tensor:
    return img.flip(_hw_axes(img)[0])


@entry
def rot180(img: torch.Tensor) -> torch.Tensor:
    return img.flip(_hw_axes(img))


@entry
def crop(img: torch.Tensor, x: int, y: int, w: int, h: int) -> torch.Tensor:
    """The (h, w) window at column x, row y (Python ints)."""
    if img.ndim >= 3:
        return img[..., y: y + h, x: x + w, :]
    return img[..., y: y + h, x: x + w]


@entry
def center_crop(img: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    ch, cw = size
    ay, ax = _hw_axes(img)
    y = (img.shape[ay] - ch) // 2
    x = (img.shape[ax] - cw) // 2
    return crop(img, x, y, cw, ch, device=img.device)


@entry
def dynamic_crop(img: torch.Tensor, x, y, w: int, h: int) -> torch.Tensor:
    """The (h, w) window of axes 0 and 1 at offset (y, x), where the
    offsets may be tensors on the device. As ``lax.dynamic_slice``, a
    negative start counts from the end and each start is then clamped so
    that the window fits, by index arithmetic on the device (nothing is
    read back)."""
    out = img
    for axis, start, size in ((0, y, h), (1, x, w)):
        n = img.shape[axis]
        if isinstance(start, torch.Tensor):
            s = start.reshape(()).to(torch.int64)
            first = torch.clamp(torch.where(s < 0, s + n, s), 0, n - size)
            idx = first + torch.arange(size, device=img.device)
            out = out.index_select(axis, idx)
        else:
            s = int(start)
            first = min(max(s + n if s < 0 else s, 0), n - size)
            out = out.narrow(axis, first, size)
    return out


@entry
def pad(img: torch.Tensor, top: int, bottom: int, left: int, right: int,
        mode: str = "constant", value: float = 0.0) -> torch.Tensor:
    """Border padding (a subset of cv2.copyMakeBorder): "constant",
    "reflect" (BORDER_REFLECT_101) or "replicate"."""
    ay, ax = _hw_axes(img)
    if mode == "constant":
        if img.ndim >= 3:
            widths = (0, 0, left, right, top, bottom)
        else:
            widths = (left, right, top, bottom)
        # jnp.pad casts the fill to the image's type
        fill = torch.tensor(value).to(img.dtype).item()
        return torch.nn.functional.pad(img, widths, value=fill)
    if mode not in ("reflect", "replicate"):
        raise ValueError(mode)
    h, w = img.shape[ay], img.shape[ax]
    iy = _edges(mode, h, top, bottom, img.device)
    ix = _edges(mode, w, left, right, img.device)
    return img.index_select(ay, iy).index_select(ax, ix)


def _edges(mode: str, n: int, lo: int, hi: int, device) -> torch.Tensor:
    """Indices of an axis of n padded by lo before and hi after."""
    p = max(lo, hi)
    return index_on(mode, n, p, device)[p - lo: p + n + hi]
