"""Affine warp by shear decomposition on a square canvas (port of
kornia_tpu/ops/warp_shear.py).

The inverse map ``src = L·dst + t`` is decomposed as ``L = U·Σ·Vᵀ`` (closed
form 2×2 SVD) and applied as a chain of sampling passes: each rotation is a
90°-multiple canvas permutation plus three unit-diagonal shears
(``_shear_x`` and ``_shear_y``, K9's row and column modes in
csrc/shear_x.cu), each axis scale a 1-D band matmul with a tent matrix
built at run time from σ. It interpolates several times, so it is
approximate (≈3% off the exact warp); ``warp_affine(method="shear")`` keeps
it for A/B comparison.

The decomposition's scalars (SVD angles, shear slopes, offsets and the
per-row shifts) are float32 host parameters computed on the CPU, as the
kernels' launch parameters are; the canvas passes run on the image's
device. The JAX package vmaps the passes over channels; here the channels
are the batch dimension of each kernel launch.

Sampling-pass algebra (P = (M, o): out(p) = in(M p + o), p = (x, y) in
canvas coordinates): applying P_a then P_b gives
out(p) = in(M_a M_b p + M_a o_b + o_a).
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from kornia_tpu_torch import resolve_device, to_device
from kornia_tpu_torch.ops import cuda_kernels as ck
from kornia_tpu_torch.ops.warp_exact import _finalize

_F32 = torch.float32


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def _t(v) -> torch.Tensor:
    return torch.as_tensor(v, dtype=_F32)


def _mat2(a, b, c, d) -> torch.Tensor:
    return torch.stack([torch.stack([a, b]), torch.stack([c, d])])


def _shear_x(img: torch.Tensor, shifts: torch.Tensor) -> torch.Tensor:
    """out[..., y, x] = img[..., y, x + shifts[y]] (linear in x, zero
    outside): K9 on (B, c, c) f32 canvases, ``shifts`` (c,) f32."""
    return ck.shear_x(img.contiguous(),
                      shifts.to(device=img.device, dtype=_F32).contiguous())


def _shear_y(img: torch.Tensor, shifts: torch.Tensor) -> torch.Tensor:
    """out[..., y, x] = img[..., y + shifts[x], x] (linear in y, zero
    outside): K9's column mode on the canvas in its own layout, the
    x-shear of the transpose without a transpose."""
    return ck.shear_y(img.contiguous(),
                      shifts.to(device=img.device, dtype=_F32).contiguous())


def _rot90_case(n: int):
    """Content permutation for the sampling pass
    out(p) = in(R(n·90°)(p − c) + c) on a square canvas (as np.rot90 on
    the last two axes)."""
    if n == 0:
        return lambda x: x
    if n == 1:
        return lambda x: torch.rot90(x, 1, dims=(-2, -1))
    if n == 2:
        return lambda x: torch.flip(x, dims=(-2, -1))
    return lambda x: torch.rot90(x, -1, dims=(-2, -1))


def _rot_pass(ch: torch.Tensor, m_rot: torch.Tensor, o: torch.Tensor,
              c: int) -> torch.Tensor:
    """General rotation sampling pass out(p) = ch(m_rot p + o) for a proper
    rotation ``m_rot`` (host f32): the 90°-multiple as a canvas permutation
    about the centre, the |θ_r| ≤ 45° residual as three shears carrying the
    full offset."""
    cvec = _t([(c - 1) / 2.0, (c - 1) / 2.0])
    theta = torch.atan2(m_rot[1, 0], m_rot[0, 0])
    half_pi = _t(math.pi / 2)
    n90 = torch.round(theta / half_pi)
    n = int(n90.to(torch.int32)) % 4
    theta_r = theta - n90 * half_pi

    ch90 = _rot90_case(n)(ch)

    # residual map: R90_c applied first ⇒ (M_s, o_s) with R90 M_s = m_rot
    # and R90 o_s + o90 = o, o90 = cvec − R90 cvec
    ang = _t(n) * half_pi
    c9, s9 = torch.cos(ang), torch.sin(ang)
    r90inv = _mat2(c9, s9, -s9, c9)
    o_r = r90inv @ (o - cvec) + cvec

    k = -torch.tan(theta_r / 2.0)
    mm = torch.sin(theta_r)
    ys = torch.arange(c, dtype=_F32)
    # P1 = Sx(k, b1), P2 = Sy(mm, b2), P3 = Sx(k, 0): total offset
    # (b1 + k b2, b2) ⇒ b2 = o_r[1], b1 = o_r[0] − k o_r[1]
    b2 = o_r[1]
    b1 = o_r[0] - k * b2
    out = _shear_x(ch90, k * ys + b1)
    out = _shear_y(out, mm * ys + b2)
    return _shear_x(out, k * ys)


def _scale_x(img: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    """out[..., y, x] = img[..., y, σ·(x − c) + c] along x (about-centre
    scale): a band matmul with a tent matrix built from the run-time σ.
    Off-canvas taps give zero. A plain float32 product (TF32 off), as the
    JAX package leaves it to XLA outside any kernel."""
    c = img.shape[-1]
    dev = img.device
    ctr = (c - 1) / 2.0
    xs = torch.arange(c, dtype=_F32, device=dev)
    src = sigma.to(dev) * (xs - ctr) + ctr
    w = torch.clamp(1.0 - torch.abs(src[:, None] - xs[None, :]), min=0.0)
    inside = (src[:, None] >= 0.0) & (src[:, None] <= c - 1)
    w = torch.where(inside, w, torch.zeros((), dtype=_F32, device=dev))
    return torch.matmul(img, w.T)


def warp_affine_shear(img, m, dsize: Tuple[int, int],
                      device="cuda") -> torch.Tensor:
    """Affine warp (cv2.warpAffine semantics) by shear decomposition.

    img: (H, W) or (H, W, C); m: (2, 3) source → destination; dsize:
    (new_h, new_w). Bilinear, zero border. |σ| is clamped to ≥ 1e-3."""
    dev = resolve_device(device)
    img = to_device(img, dev)
    new_h, new_w = dsize
    squeeze = img.ndim == 2
    x = img[..., None] if squeeze else img
    h, w, nch = x.shape
    in_dtype = img.dtype

    # the canvas holds the content diagonal plus the shear excursions
    # (warp_shear.py:219-227)
    c = _round_up(int(math.ceil(1.3 * math.hypot(max(h, new_h),
                                                 max(w, new_w)))) + 64,
                  256)
    oy = (c - h) // 2
    ox = (c - w) // 2
    doy = (c - new_h) // 2
    dox = (c - new_w) // 2
    cvec = _t([(c - 1) / 2.0, (c - 1) / 2.0])

    # inverse map in canvas coordinates: src_c = L dst_c + t_c
    if isinstance(m, torch.Tensor):
        mm = m.detach().to(device="cpu", dtype=_F32)
    else:
        mm = torch.as_tensor(np.asarray(m), dtype=_F32)
    a = mm[:, :2]
    tiny = _t(1e-12)
    det = a[0, 0] * a[1, 1] - a[0, 1] * a[1, 0]
    det = torch.where(det.abs() < tiny, tiny, det)
    linv = _mat2(a[1, 1], -a[0, 1], -a[1, 0], a[0, 0]) / det
    tinv = -linv @ mm[:, 2]
    off_dst = _t([dox, doy])
    off_src = _t([ox, oy])
    t_c = -linv @ off_dst + tinv + off_src

    # closed-form SVD linv = U Σ Vᵀ (a reflection folds into Σ's sign)
    e = (linv[0, 0] + linv[1, 1]) / 2
    f_ = (linv[0, 0] - linv[1, 1]) / 2
    g = (linv[1, 0] + linv[0, 1]) / 2
    hh = (linv[1, 0] - linv[0, 1]) / 2
    q = torch.sqrt(e * e + hh * hh)
    r = torch.sqrt(f_ * f_ + g * g)
    s1 = q + r
    s2 = q - r
    a1 = torch.atan2(g, f_)
    a2 = torch.atan2(hh, e)
    gamma = (a2 + a1) / 2

    small = _t(1e-3)
    s1 = torch.where(s1.abs() < small, small, s1)
    s2m = s2.abs()
    s2m = torch.where(s2m < small, small, s2m)
    flip = bool(s2 < 0)
    sgn = _t(-1.0 if flip else 1.0)
    zero = _t(0.0)

    # P1 = rot(U) about the centre
    cg, sg = torch.cos(gamma), torch.sin(gamma)
    m1 = _mat2(cg, -sg, sg, cg)
    o1 = cvec - m1 @ cvec
    # P2 = diag(s1, sgn·s2m) about the centre (the flip as a row reverse)
    m2 = _mat2(s1, zero, zero, sgn * s2m)
    o2 = cvec - m2 @ cvec
    m12 = m1 @ m2
    o12 = m1 @ o2 + o1
    # P3: m12 @ m3 = linv, m12 @ o3 + o12 = t_c
    det12 = m12[0, 0] * m12[1, 1] - m12[0, 1] * m12[1, 0]
    det12 = torch.where(det12.abs() < tiny, tiny, det12)
    m12inv = _mat2(m12[1, 1], -m12[0, 1], -m12[1, 0], m12[0, 0]) / det12
    m3 = m12inv @ linv
    o3 = m12inv @ (t_c - o12)
    th3 = torch.atan2(m3[1, 0], m3[0, 0])
    c3, s3 = torch.cos(th3), torch.sin(th3)
    m3 = _mat2(c3, -s3, s3, c3)
    # move the translation beyond the rotation's about-centre offset into
    # the final crop, leaving a sub-pixel residual for the shears
    o3_center = cvec - m3 @ cvec
    delta = torch.round(m3.T @ (o3 - o3_center))
    o3 = o3 - m3 @ delta
    crop_x = min(max(dox + int(delta[0].to(torch.int32)), 0), c - new_w)
    crop_y = min(max(doy + int(delta[1].to(torch.int32)), 0), c - new_h)

    canvas = torch.zeros((nch, c, c), dtype=_F32, device=dev)
    canvas[:, oy:oy + h, ox:ox + w] = x.to(_F32).permute(2, 0, 1)

    ch = _rot_pass(canvas, m1, o1, c)                        # P1
    ch = _scale_x(ch, s1)                                    # P2 (x)
    ch = _scale_x(ch.transpose(-1, -2), s2m).transpose(-1, -2)   # P2 (y)
    if flip:
        ch = torch.flip(ch, dims=(-2,))                      # P2 flip
    ch = _rot_pass(ch, m3, o3, c)                            # P3

    out = ch[:, crop_y:crop_y + new_h, crop_x:crop_x + new_w].permute(
        1, 2, 0)
    out = _finalize(out, in_dtype)
    return out[..., 0] if squeeze else out
