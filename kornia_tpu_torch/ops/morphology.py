"""Morphology (port of kornia_tpu/ops/morphology.py): dilate and erode with
a rectangle or any structuring element, and the compositions built on
them, entry points with ``device=``.

A rectangle's max/min is separable and exact in any order. Like the
reference's ``reduce_window`` (morphology.py:18-33), the window pads
(k // 2, (k − 1) // 2) with −inf / +inf, so an even kernel reaches one
pixel further up and left than down and right.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from kornia_tpu_torch import entry


def _padded(img: torch.Tensor, kh: int, kw: int, op: str):
    """float32 (..., H, W, C) view of ``img`` padded with the op's
    identity, and whether a channel axis was added."""
    x = img.to(torch.float32)
    chan = x.ndim >= 3
    if not chan:
        x = x[..., None]
    fill = float("-inf") if op == "max" else float("inf")
    p = torch.nn.functional.pad(
        x, (0, 0, kw // 2, (kw - 1) // 2, kh // 2, (kh - 1) // 2),
        value=fill)
    return x, p, chan


def _reduce(a, b, op):
    return torch.maximum(a, b) if op == "max" else torch.minimum(a, b)


def _reduce2d(img: torch.Tensor, ksize: Tuple[int, int], op: str
              ) -> torch.Tensor:
    kh, kw = ksize
    x, p, chan = _padded(img, kh, kw, op)
    h, w = x.shape[-3], x.shape[-2]
    rows = p[..., 0: h, :, :]
    for dy in range(1, kh):
        rows = _reduce(rows, p[..., dy: dy + h, :, :], op)
    out = rows[..., 0: w, :]
    for dx in range(1, kw):
        out = _reduce(out, rows[..., dx: dx + w, :], op)
    out = out.to(img.dtype)
    return out if chan else out[..., 0]


def _morph_kernel(img: torch.Tensor, kernel, op: str) -> torch.Tensor:
    """Any structuring element: the max/min over its nonzero offsets. The
    element is read on the image's device (offsets outside it take the
    op's identity), so nothing waits for the device."""
    k = torch.as_tensor(kernel).to(img.device) != 0
    kh, kw = k.shape
    x, p, chan = _padded(img, kh, kw, op)
    h, w = x.shape[-3], x.shape[-2]
    fill = torch.full((), float("-inf") if op == "max" else float("inf"),
                      device=img.device)
    acc = None
    for dy in range(kh):
        for dx in range(kw):
            v = torch.where(k[dy, dx], p[..., dy: dy + h, dx: dx + w, :],
                            fill)
            acc = v if acc is None else _reduce(acc, v, op)
    out = acc.to(img.dtype)
    return out if chan else out[..., 0]


@entry
def dilate(img: torch.Tensor, ksize: Tuple[int, int] = (3, 3),
           kernel: Optional[np.ndarray] = None) -> torch.Tensor:
    if kernel is None:
        return _reduce2d(img, ksize, "max")
    return _morph_kernel(img, kernel, "max")


@entry
def erode(img: torch.Tensor, ksize: Tuple[int, int] = (3, 3),
          kernel: Optional[np.ndarray] = None) -> torch.Tensor:
    if kernel is None:
        return _reduce2d(img, ksize, "min")
    return _morph_kernel(img, kernel, "min")


@entry
def opening(img: torch.Tensor, ksize: Tuple[int, int] = (3, 3)
            ) -> torch.Tensor:
    return _reduce2d(_reduce2d(img, ksize, "min"), ksize, "max")


@entry
def closing(img: torch.Tensor, ksize: Tuple[int, int] = (3, 3)
            ) -> torch.Tensor:
    return _reduce2d(_reduce2d(img, ksize, "max"), ksize, "min")


def _difference(a: torch.Tensor, b: torch.Tensor, like: torch.Tensor):
    out = a.to(torch.float32) - b.to(torch.float32)
    if like.dtype == torch.uint8:
        return torch.clamp(out, 0, 255).to(torch.uint8)
    return out.to(like.dtype)


@entry
def gradient(img: torch.Tensor, ksize: Tuple[int, int] = (3, 3)
             ) -> torch.Tensor:
    """Dilation minus erosion."""
    return _difference(_reduce2d(img, ksize, "max"),
                       _reduce2d(img, ksize, "min"), img)


@entry
def top_hat(img: torch.Tensor, ksize: Tuple[int, int] = (3, 3)
            ) -> torch.Tensor:
    """The image minus its opening."""
    return _difference(img, opening(img, ksize, device=img.device), img)


@entry
def black_hat(img: torch.Tensor, ksize: Tuple[int, int] = (3, 3)
              ) -> torch.Tensor:
    """The closing minus the image."""
    return _difference(closing(img, ksize, device=img.device), img, img)
