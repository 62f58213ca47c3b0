"""Fused DNN preprocessing: frame → normalised CHW tensor (port of
kornia_tpu/ops/preprocess.py).

The resize + normalise + HWC→CHW core is one kernel,
``cuda_kernels.fused_preprocess`` (bilinear, float32: the numerics of the
JAX package's one-program kernel, not the bf16 passes of its two-einsum
path, which it stays within one u8 LSB of). Letterboxing resizes to the
fitted size through the same kernel and places the result on the normalised
pad canvas. The other ``interp`` modes (nearest, bicubic, lanczos, area)
take the reference's dense route (preprocess.py:75-95): two float32
band-matrix products (``ops/resize``'s matrices), then ``/255`` and the
normalisation, where the reference runs two bf16 passes.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Sequence, Tuple

import torch

from kornia_tpu_torch import resolve_device, to_device
from kornia_tpu_torch.ops import cuda_kernels as ck
from kornia_tpu_torch.ops import yuv as _yuv
from kornia_tpu_torch.ops.filters import const_on
from kornia_tpu_torch.ops.resize import matrix_on


class ResizeMode(enum.Enum):
    STRETCH = "stretch"
    LETTERBOX = "letterbox"


class NormalizeMode(enum.Enum):
    UNIT_SCALE = "unit_scale"  # x / 255
    MEAN_STD = "mean_std"      # (x/255 - mean) / std


@dataclasses.dataclass(frozen=True)
class PreprocessorConfig:
    """Preprocessor settings, as kornia_tpu's PreprocessorConfig."""

    out_size: Tuple[int, int]  # (h, w)
    resize_mode: ResizeMode = ResizeMode.STRETCH
    normalize: NormalizeMode = NormalizeMode.UNIT_SCALE
    mean: Sequence[float] = (0.0, 0.0, 0.0)
    std: Sequence[float] = (1.0, 1.0, 1.0)
    interp: str = "bilinear"
    pad_value: float = 114.0 / 255.0  # YOLO-style letterbox gray
    bgr_output: bool = False


def resize_normalize_to_tensor(rgb_u8, cfg: PreprocessorConfig,
                               device="cuda") -> torch.Tensor:
    """(H, W, 3) u8 (numpy or tensor) → (1, 3, out_h, out_w) f32 on
    ``device``."""
    dev = resolve_device(device)
    rgb = to_device(rgb_u8, dev, torch.uint8).contiguous()
    out_h, out_w = cfg.out_size
    h, w, _ = rgb.shape
    if cfg.resize_mode is ResizeMode.LETTERBOX:
        scale = min(out_h / h, out_w / w)
        rh, rw = int(round(h * scale)), int(round(w * scale))
        pad_top = (out_h - rh) // 2
        pad_left = (out_w - rw) // 2
    else:
        rh, rw = out_h, out_w
        pad_top = pad_left = 0

    mean_std = cfg.normalize is NormalizeMode.MEAN_STD
    mean = tuple(cfg.mean) if mean_std else (0.0, 0.0, 0.0)
    std = tuple(cfg.std) if mean_std else (1.0, 1.0, 1.0)
    if cfg.interp == "bilinear":
        t = ck.fused_preprocess(rgb, rh, rw, mean, std)      # (3, rh, rw)
    else:
        t = _dense_resize_normalize(rgb, rh, rw, cfg.interp, mean, std,
                                    mean_std)
    if cfg.bgr_output:
        t = t.flip(0)

    if cfg.resize_mode is ResizeMode.LETTERBOX:
        canvas = torch.full((3, out_h, out_w), cfg.pad_value,
                            dtype=torch.float32, device=dev)
        if mean_std:
            canvas = ((canvas - const_on(mean, dev)[:, None, None])
                      / const_on(std, dev)[:, None, None])
        canvas[:, pad_top: pad_top + rh, pad_left: pad_left + rw] = t
        t = canvas
    return t[None]


def _dense_resize_normalize(rgb: torch.Tensor, rh: int, rw: int, interp: str,
                            mean, std, mean_std: bool) -> torch.Tensor:
    """(H, W, 3) u8 → (3, rh, rw) f32 by the two dense products of
    ``interp``'s matrices, rows then columns, then ``·(1/255)`` and the
    normalisation, in the reference's order."""
    h, w, _ = rgb.shape
    dev = rgb.device
    wy = matrix_on(h, rh, interp, False, dev)
    wx = matrix_on(w, rw, interp, False, dev)
    src = rgb.permute(2, 0, 1).to(torch.float32)               # (3, H, W)
    t = torch.matmul(torch.matmul(wy, src), wx.T) * (1.0 / 255.0)
    if mean_std:
        t = ((t - const_on(mean, dev)[:, None, None])
             / const_on(std, dev)[:, None, None])
    return t


def preprocess_nv12(y_plane, uv_plane, cfg: PreprocessorConfig,
                    device="cuda") -> torch.Tensor:
    """NV12 frame → (1, 3, H, W) f32."""
    dev = resolve_device(device)
    rgb = _yuv.rgb_from_nv12(to_device(y_plane, dev, torch.uint8),
                             to_device(uv_plane, dev, torch.uint8))
    return resize_normalize_to_tensor(rgb, cfg, dev)


class Preprocessor:
    """A configured preprocessor: ``Preprocessor(cfg)(rgb_u8)``."""

    def __init__(self, cfg: PreprocessorConfig, device="cuda"):
        self.cfg = cfg
        self.device = device

    def __call__(self, rgb_u8) -> torch.Tensor:
        return resize_normalize_to_tensor(rgb_u8, self.cfg, self.device)
