"""Packed and planar video formats → RGB, and RGB → NV12 (port of
kornia_tpu/ops/yuv.py), entry points with ``device=``.

Limited-range BT.601 (ITU-R studio swing), like cv2's COLOR_YUV2RGB_NV12
family; chroma is upsampled by replication (an expand, no index upload)
and the math runs in float32.
"""

from __future__ import annotations

from typing import Tuple

import torch

from kornia_tpu_torch import entry

# BT.601 limited-range coefficients (cv2's ITU-R constants)
_Y_COEF = 1.163999557
_RV = 1.59599304
_GU = -0.390999794
_GV = -0.812999725
_BU = 2.017999649


def _ycbcr_to_rgb(y: torch.Tensor, u: torch.Tensor, v: torch.Tensor
                  ) -> torch.Tensor:
    yf = (y.to(torch.float32) - 16.0) * _Y_COEF
    uf = u.to(torch.float32) - 128.0
    vf = v.to(torch.float32) - 128.0
    r = yf + _RV * vf
    g = yf + _GU * uf + _GV * vf
    b = yf + _BU * uf
    rgb = torch.stack([r, g, b], dim=-1)
    return torch.clamp(torch.round(rgb), 0, 255).to(torch.uint8)


def _repeat2(c: torch.Tensor, dim: int) -> torch.Tensor:
    """Each entry of axis ``dim`` twice (``jnp.repeat(c, 2, dim)``)."""
    dim %= c.ndim
    shape = c.shape
    out = c.unsqueeze(dim + 1).expand(shape[:dim + 1] + (2,)
                                      + shape[dim + 1:])
    return out.reshape(shape[:dim] + (2 * shape[dim],) + shape[dim + 1:])


def _upsample2(c: torch.Tensor) -> torch.Tensor:
    """(H/2, W/2) chroma → (H, W) by replication."""
    return _repeat2(_repeat2(c, -1), -2)


def _pairs(plane: torch.Tensor) -> torch.Tensor:
    """Interleaved chroma as (H/2, W/2, 2), from that shape or packed
    (H/2, W) rows."""
    if plane.ndim == 2:
        return plane.reshape(plane.shape[0], plane.shape[1] // 2, 2)
    return plane


def rgb_from_nv12(y_plane: torch.Tensor, uv_plane: torch.Tensor
                  ) -> torch.Tensor:
    """NV12: (H, W) luma + (H/2, W/2, 2) interleaved UV (or packed (H/2, W)
    rows UVUV...) → (H, W, 3) RGB u8, on the planes' device (ported
    before the entry points of this module took ``device=``)."""
    uv = _pairs(uv_plane)
    return _ycbcr_to_rgb(y_plane, _upsample2(uv[..., 0]),
                         _upsample2(uv[..., 1]))


@entry
def rgb_from_nv21(y_plane: torch.Tensor, vu_plane: torch.Tensor
                  ) -> torch.Tensor:
    """NV21: as NV12 with the chroma pairs in V, U order."""
    vu = _pairs(vu_plane)
    return _ycbcr_to_rgb(y_plane, _upsample2(vu[..., 1]),
                         _upsample2(vu[..., 0]))


@entry
def rgb_from_i420(y: torch.Tensor, u: torch.Tensor, v: torch.Tensor
                  ) -> torch.Tensor:
    """I420: separate (H, W), (H/2, W/2), (H/2, W/2) planes."""
    return _ycbcr_to_rgb(y, _upsample2(u), _upsample2(v))


@entry
def rgb_from_yv12(y: torch.Tensor, v: torch.Tensor, u: torch.Tensor
                  ) -> torch.Tensor:
    """YV12: I420 with the V plane first."""
    return _ycbcr_to_rgb(y, _upsample2(u), _upsample2(v))


def _packed422(data: torch.Tensor, y_idx: Tuple[int, int], u_idx: int,
               v_idx: int) -> torch.Tensor:
    """(H, W·2) byte rows of 4-byte macro-pixels → (H, W, 3) RGB."""
    h = data.shape[0]
    quads = data.reshape(h, -1, 4)
    y = torch.stack([quads[..., y_idx[0]], quads[..., y_idx[1]]],
                    dim=-1).reshape(h, -1)
    return _ycbcr_to_rgb(y, _repeat2(quads[..., u_idx], -1),
                         _repeat2(quads[..., v_idx], -1))


@entry
def rgb_from_yuyv(data: torch.Tensor) -> torch.Tensor:
    """YUYV (YUY2): bytes Y0 U Y1 V."""
    return _packed422(data, (0, 2), 1, 3)


@entry
def rgb_from_uyvy(data: torch.Tensor) -> torch.Tensor:
    """UYVY: bytes U Y0 V Y1."""
    return _packed422(data, (1, 3), 0, 2)


@entry
def rgb_from_yvyu(data: torch.Tensor) -> torch.Tensor:
    """YVYU: bytes Y0 V Y1 U."""
    return _packed422(data, (0, 2), 3, 1)


@entry
def nv12_from_rgb(rgb: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """RGB u8 → (Y (H, W), interleaved UV (H/2, W/2, 2)) u8 planes, BT.601
    limited range, chroma averaged over each 2×2 block."""
    x = rgb.to(torch.float32)
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    y = 16.0 + 0.256788 * r + 0.504129 * g + 0.097906 * b
    u = 128.0 - 0.148223 * r - 0.290993 * g + 0.439216 * b
    v = 128.0 + 0.439216 * r - 0.367788 * g - 0.071427 * b

    def u8(t):
        return torch.clamp(torch.round(t), 0, 255).to(torch.uint8)

    h, w = u.shape[-2], u.shape[-1]
    u2 = u.reshape(h // 2, 2, w // 2, 2).mean(dim=(1, 3))
    v2 = v.reshape(h // 2, 2, w // 2, 2).mean(dim=(1, 3))
    return u8(y), u8(torch.stack([u2, v2], dim=-1))
