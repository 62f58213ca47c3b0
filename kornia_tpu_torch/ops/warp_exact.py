"""Exact single-pass warps and remap (port of kornia_tpu/ops/warp_pallas.py).

The JAX module reformulates an exact bilinear sample with the TPU's
vector-rate primitives: (8, 128) destination chunks, candidate-row
selects, lane rolls, DMA staging, a rot90 + integer pre-shear
(``_lane_shift_pallas``) for large rotations, and a capacity gate with a
scalar-gather fallback. A per-pixel sampler on Hopper takes every map
directly, so here each entry point prepares the map as the Pallas path
does and makes one K7 launch (``cuda_kernels.remap``, csrc/remap.cu).
No map is refused and nothing falls back. A warp matrix that is a CUDA
tensor is inverted on the card and the kernel reads the coefficients from
device memory: such a call never waits for the device. That pays where
the matrix comes out of device work still in the queue (a tracker's
estimate, frame after frame): the host runs ahead instead of stalling on
every frame. On an idle card the dozen small ops of the inversion cost
more host time than the wait they spare, so a caller that holds the
matrix on the host passes it from there (chip_smoke.py times both).

The contract is the Pallas path's (warp_pallas.py:783-825, 1145-1195):
nearest rounds with ``floor(map + 0.5)`` (the gather route rounds half to
even), border padding clips the map to the image before sampling (the
gather route clamps each tap), ``warp_affine_exact`` inverts the 2×2 part
by adjugate / determinant, and ``warp_perspective_exact`` takes the
homography's inverse. The four taps are summed in ``grid_sample``'s order.

:func:`lane_shift` is K8 (csrc/lane_shift.cu), the JAX sheared branch's
integer pre-shear. No warp of the port calls it; it is kept with its
contract, its plain version and its tests.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from kornia_tpu_torch import resolve_device, to_device
from kornia_tpu_torch.ops import cuda_kernels as ck


def _finalize(out: torch.Tensor, dtype) -> torch.Tensor:
    """f32 samples → ``dtype``; u8 rounds half to even and clamps."""
    if dtype == torch.uint8:
        return torch.clamp(torch.round(out), 0, 255).to(torch.uint8)
    return out.to(dtype)


def _sample(img, dev, out_hw, form, coefs=None, map_x=None, map_y=None,
            mode="bilinear", padding_mode="zeros", fill_value=0.0):
    """(H, W) or (H, W, C) image → K7 → the same layout and dtype. u8 and
    f32 images go to the kernel as they are (it rounds u8 itself); other
    dtypes are sampled as f32 and cast back."""
    if mode not in ("bilinear", "nearest"):
        raise ValueError(f"exact sampling supports bilinear/nearest, got "
                         f"{mode}")
    if padding_mode not in ("zeros", "border"):
        raise ValueError(f"exact sampling supports zeros/border padding, "
                         f"got {padding_mode}")
    img = to_device(img, dev)
    squeeze = img.ndim == 2
    x = img[..., None] if squeeze else img
    dtype = x.dtype
    if dtype not in (torch.uint8, torch.float32):
        x = x.to(torch.float32)
    out = ck.remap(x.contiguous(), out_hw, form, coefs=coefs, map_x=map_x,
                   map_y=map_y, nearest=mode == "nearest",
                   border=padding_mode == "border", fill=float(fill_value))
    if out.dtype != dtype:
        out = _finalize(out, dtype)
    return out[..., 0] if squeeze else out


def remap_exact(img, map_x, map_y, mode: str = "bilinear",
                padding_mode: str = "zeros", fill_value: float = 0.0,
                device="cuda") -> torch.Tensor:
    """cv2.remap with exact bilinear (or nearest) taps, any map.

    ``img``: (H, W) or (H, W, C); ``map_x``/``map_y``: (Ho, Wo) source
    pixel coordinates. Returns (Ho, Wo[, C]) of the image's dtype."""
    dev = resolve_device(device)
    mx = to_device(map_x, dev, torch.float32).contiguous()
    my = to_device(map_y, dev, torch.float32).contiguous()
    if mx.shape != my.shape or mx.ndim != 2:
        raise ValueError("remap_exact: map_x and map_y must be (Ho, Wo)")
    return _sample(img, dev, tuple(mx.shape), "data", map_x=mx, map_y=my,
                   mode=mode, padding_mode=padding_mode,
                   fill_value=fill_value)


def _matrix(m, rows: int) -> torch.Tensor:
    """A (rows, 3) matrix as a float32 tensor on the device it came from:
    a numpy array or a CPU tensor stays on the host and its coefficients
    go to the kernel by value; a CUDA tensor stays on the card, the
    coefficients are computed there and the kernel reads them from device
    memory, so nothing waits for the device."""
    if isinstance(m, torch.Tensor):
        t = m.detach().to(dtype=torch.float32)
    else:
        t = torch.as_tensor(np.asarray(m), dtype=torch.float32)
    if tuple(t.shape) != (rows, 3):
        raise ValueError(f"expected a ({rows}, 3) matrix, got "
                         f"{tuple(t.shape)}")
    return t


def affine_coefs(m) -> torch.Tensor:
    """The nine destination → source coefficients of the 2×3 source →
    destination matrix ``m``, inverted by adjugate / determinant in f32 as
    warp_pallas.py:1163-1175 does (|det| < 1e-12 → 1e-12), on the matrix's
    own device. Every step is one IEEE f32 operation on either device
    (the translation's two-term products are written out, not a matmul),
    so a CUDA matrix gives the host's coefficients bit for bit; no step
    copies to or from the card."""
    mm = _matrix(m, 2)
    a00, a01, a10, a11 = mm[0, 0], mm[0, 1], mm[1, 0], mm[1, 1]
    det = a00 * a11 - a01 * a10
    det = torch.where(det.abs() < 1e-12, 1e-12, det)
    ainv = torch.stack([a11, -a01, -a10, a00]).reshape(2, 2) / det
    prod = (-ainv) * mm[:, 2]                 # rows: (-i_r0)·t0, (-i_r1)·t1
    tinv = prod[:, 0] + prod[:, 1]
    return torch.cat([torch.cat([ainv, tinv[:, None]], dim=1).reshape(6),
                      _last_row(str(mm.device))])


@functools.lru_cache(maxsize=None)
def _last_row(device: str) -> torch.Tensor:
    """[0, 0, 1] on ``device``, made once."""
    return torch.tensor([0.0, 0.0, 1.0], dtype=torch.float32, device=device)


def warp_affine_exact(img, m, dsize: Tuple[int, int],
                      mode: str = "bilinear", padding_mode: str = "zeros",
                      fill_value: float = 0.0, device="cuda"
                      ) -> torch.Tensor:
    """Exact cv2.warpAffine: ``m`` is the 2×3 source → destination matrix,
    ``dsize`` the (height, width) of the result. Every destination pixel
    samples the inverse map, evaluated per pixel inside the kernel."""
    dev = resolve_device(device)
    return _sample(img, dev, tuple(dsize), "affine", coefs=affine_coefs(m),
                   mode=mode, padding_mode=padding_mode,
                   fill_value=fill_value)


def warp_perspective_exact(img, m, dsize: Tuple[int, int],
                           mode: str = "bilinear",
                           padding_mode: str = "zeros",
                           fill_value: float = 0.0, device="cuda"
                           ) -> torch.Tensor:
    """Exact cv2.warpPerspective by the 3×3 source → destination
    homography ``m``; the kernel divides by the inverse's third row,
    clamped to |den| ≥ 1e-8 (warp_pallas.py:922). A CUDA ``m`` is inverted
    on the card without a wait (so a singular one is not reported, and the
    inverse may differ from the host's in its last bits)."""
    dev = resolve_device(device)
    mm = _matrix(m, 3)
    if mm.device.type == "cpu":
        coefs = torch.linalg.inv(mm).reshape(9)
    else:
        coefs = torch.linalg.inv_ex(mm).inverse.reshape(9)
    return _sample(img, dev, tuple(dsize), "persp", coefs=coefs, mode=mode,
                   padding_mode=padding_mode, fill_value=fill_value)


def lane_shift(src, shifts, out_w: int, device="cuda") -> torch.Tensor:
    """K8: ``out[..., r, j] = src[..., r, j - shifts[r]]``, zero outside,
    for (rr, cc) or (B, rr, cc) f32 ``src`` and (rr,) integer shifts."""
    dev = resolve_device(device)
    src = to_device(src, dev, torch.float32).contiguous()
    shifts = to_device(shifts, dev, torch.int32).contiguous()
    return ck.lane_shift(src, shifts, int(out_w))
