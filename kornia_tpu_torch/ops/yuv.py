"""NV12 → RGB (port of kornia_tpu/ops/yuv.py:27-49, the part
``preprocess_nv12`` uses; the other planar and packed formats are not ported
yet).

Limited-range BT.601 (ITU-R studio swing), like cv2's COLOR_YUV2RGB_NV12;
chroma is upsampled by replication and the math runs in float32.
"""

from __future__ import annotations

import torch

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


def _upsample2(c: torch.Tensor) -> torch.Tensor:
    """(H/2, W/2) chroma → (H, W) by replication."""
    return c.repeat_interleave(2, dim=-1).repeat_interleave(2, dim=-2)


def rgb_from_nv12(y_plane: torch.Tensor, uv_plane: torch.Tensor
                  ) -> torch.Tensor:
    """NV12: (H, W) luma + (H/2, W/2, 2) interleaved UV (or packed (H/2, W)
    rows UVUV...) → (H, W, 3) RGB u8."""
    if uv_plane.ndim == 2:
        uv_plane = uv_plane.reshape(uv_plane.shape[0],
                                    uv_plane.shape[1] // 2, 2)
    u = _upsample2(uv_plane[..., 0])
    v = _upsample2(uv_plane[..., 1])
    return _ycbcr_to_rgb(y_plane, u, v)
