"""Colour-space conversions (port of kornia_tpu/ops/color.py).

Conventions as the reference's: float32 images are RGB in [0, 1]; HSV/HLS
hue is in degrees [0, 360) for float32 and [0, 180) for u8; u8 grayscale
uses cv2's fixed-point weights ``(R·4899 + G·9617 + B·1868 + 8192) >> 14``
(byte-equal to cv2); Lab/Luv/XYZ are sRGB (D65). Every function takes
(..., H, W, C) and is an entry point with ``device=``. The 3×3 colour
matrices are nine elementwise multiply-adds in the reference's order, and
the colormap LUTs are built on the host with numpy and cached per device.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from kornia_tpu_torch import entry
from kornia_tpu_torch.ops.filters import const_on

# --------------------------------------------------------------------------
# helpers
# --------------------------------------------------------------------------


def _matvec3(x: torch.Tensor, m) -> torch.Tensor:
    """A 3×3 colour matrix along the last axis, as elementwise ops."""
    c0, c1, c2 = x[..., 0], x[..., 1], x[..., 2]
    return torch.stack([m[i][0] * c0 + m[i][1] * c1 + m[i][2] * c2
                        for i in range(3)], dim=-1)


def _is_u8(x) -> bool:
    return x.dtype == torch.uint8


def _to_f32_unit(x: torch.Tensor) -> torch.Tensor:
    """u8 → float32 in [0, 1]; float passes through as float32."""
    if _is_u8(x):
        return x.to(torch.float32) * (1.0 / 255.0)
    return x.to(torch.float32)


def _u8(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(x), 0, 255).to(torch.uint8)


def _from_f32_unit(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    if _is_u8(like):
        return _u8(x * 255.0)
    return x.to(like.dtype)


def _select(i: torch.Tensor, vals, default):
    """``jnp.select([i == 0, ..., i == n-1], vals, default)``."""
    out = default
    for k in range(len(vals) - 1, -1, -1):
        out = torch.where(i == k, vals[k], out)
    return out


# --------------------------------------------------------------------------
# grayscale
# --------------------------------------------------------------------------

# ITU-R BT.601 luma weights
_GRAY_W = (0.299, 0.587, 0.114)


@entry
def rgb_to_gray(rgb: torch.Tensor) -> torch.Tensor:
    """(..., H, W, 3) → (..., H, W, 1); the u8 path is byte-equal to cv2."""
    if _is_u8(rgb):
        r, g, b = (rgb[..., i].to(torch.int32) for i in range(3))
        y = (r * 4899 + g * 9617 + b * 1868 + (1 << 13)) >> 14
        return y.to(torch.uint8)[..., None]
    y = (rgb[..., 0] * _GRAY_W[0] + rgb[..., 1] * _GRAY_W[1]
         + rgb[..., 2] * _GRAY_W[2])
    return y.to(rgb.dtype)[..., None]


@entry
def bgr_to_gray(bgr: torch.Tensor) -> torch.Tensor:
    return rgb_to_gray(bgr.flip(-1), device=bgr.device)


@entry
def gray_to_rgb(gray: torch.Tensor) -> torch.Tensor:
    """(..., H, W, 1) → (..., H, W, 3)."""
    return gray.expand(gray.shape[:-1] + (3,))


# --------------------------------------------------------------------------
# channel shuffles / alpha
# --------------------------------------------------------------------------


@entry
def rgb_to_bgr(rgb: torch.Tensor) -> torch.Tensor:
    return rgb.flip(-1)


bgr_to_rgb = rgb_to_bgr


@entry
def rgb_to_rgba(rgb: torch.Tensor, alpha=None) -> torch.Tensor:
    if alpha is None:
        alpha = 255 if _is_u8(rgb) else 1.0
    a = torch.full(rgb.shape[:-1] + (1,), alpha, dtype=rgb.dtype,
                   device=rgb.device)
    return torch.cat([rgb, a], dim=-1)


@entry
def rgba_to_rgb(rgba: torch.Tensor) -> torch.Tensor:
    return rgba[..., :3]


@entry
def bgra_to_rgba(bgra: torch.Tensor) -> torch.Tensor:
    return torch.cat([bgra[..., :3].flip(-1), bgra[..., 3:4]], dim=-1)


# --------------------------------------------------------------------------
# HSV / HLS (OpenCV conventions)
# --------------------------------------------------------------------------


def _hue_from_maxmin(r, g, b, vmax, diff):
    """Hue in degrees, [0, 360)."""
    safe = torch.where(diff > 0, diff, torch.ones_like(diff))
    h = torch.where(
        vmax == r, 60.0 * (g - b) / safe,
        torch.where(vmax == g, 120.0 + 60.0 * (b - r) / safe,
                    240.0 + 60.0 * (r - g) / safe))
    h = torch.where(diff > 0, h, torch.zeros_like(h))
    return torch.where(h < 0, h + 360.0, h)


@entry
def rgb_to_hsv(rgb: torch.Tensor) -> torch.Tensor:
    """float32: H ∈ [0, 360), S, V ∈ [0, 1]. u8: H ∈ [0, 180), S, V ∈
    [0, 255] (cv2)."""
    x = _to_f32_unit(rgb)
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    vmax = torch.maximum(torch.maximum(r, g), b)
    vmin = torch.minimum(torch.minimum(r, g), b)
    diff = vmax - vmin
    h = _hue_from_maxmin(r, g, b, vmax, diff)
    pos = vmax > 0
    s = torch.where(pos, diff / torch.where(pos, vmax, torch.ones_like(vmax)),
                    torch.zeros_like(vmax))
    if _is_u8(rgb):
        return _u8(torch.stack([h * 0.5, s * 255.0, vmax * 255.0], dim=-1))
    return torch.stack([h, s, vmax], dim=-1).to(rgb.dtype)


@entry
def hsv_to_rgb(hsv: torch.Tensor) -> torch.Tensor:
    if _is_u8(hsv):
        h = hsv[..., 0].to(torch.float32) * 2.0
        s = hsv[..., 1].to(torch.float32) / 255.0
        v = hsv[..., 2].to(torch.float32) / 255.0
    else:
        h, s, v = (hsv[..., i].to(torch.float32) for i in range(3))
    h = torch.remainder(h / 60.0, 6.0)
    i = torch.floor(h)
    f = h - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    i = i.to(torch.int32)
    r = _select(i, [v, q, p, p, t], v)
    g = _select(i, [t, v, v, q, p], p)
    b = _select(i, [p, p, t, v, v], q)
    return _from_f32_unit(torch.stack([r, g, b], dim=-1), hsv)


@entry
def rgb_to_hls(rgb: torch.Tensor) -> torch.Tensor:
    """float32: H ∈ [0, 360), L, S ∈ [0, 1]; u8 scaled like cv2 (H/2,
    L·255, S·255)."""
    x = _to_f32_unit(rgb)
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    vmax = torch.maximum(torch.maximum(r, g), b)
    vmin = torch.minimum(torch.minimum(r, g), b)
    diff = vmax - vmin
    l = 0.5 * (vmax + vmin)
    h = _hue_from_maxmin(r, g, b, vmax, diff)
    denom = torch.where(l < 0.5, vmax + vmin, 2.0 - vmax - vmin)
    s = torch.where(diff > 0,
                    diff / torch.where(denom > 0, denom,
                                       torch.ones_like(denom)),
                    torch.zeros_like(diff))
    if _is_u8(rgb):
        return _u8(torch.stack([h * 0.5, l * 255.0, s * 255.0], dim=-1))
    return torch.stack([h, l, s], dim=-1).to(rgb.dtype)


@entry
def hls_to_rgb(hls: torch.Tensor) -> torch.Tensor:
    if _is_u8(hls):
        h = hls[..., 0].to(torch.float32) * 2.0
        l = hls[..., 1].to(torch.float32) / 255.0
        s = hls[..., 2].to(torch.float32) / 255.0
    else:
        h, l, s = (hls[..., i].to(torch.float32) for i in range(3))
    c = (1.0 - torch.abs(2.0 * l - 1.0)) * s
    hp = torch.remainder(h / 60.0, 6.0)
    xc = c * (1.0 - torch.abs(torch.remainder(hp, 2.0) - 1.0))
    i = torch.floor(hp).to(torch.int32)
    z = torch.zeros_like(c)
    r = _select(i, [c, xc, z, z, xc], c)
    g = _select(i, [xc, c, c, xc, z], z)
    b = _select(i, [z, z, xc, c, c], xc)
    m = l - 0.5 * c
    return _from_f32_unit(torch.stack([r + m, g + m, b + m], dim=-1), hls)


# --------------------------------------------------------------------------
# CIE XYZ / Lab / Luv (sRGB D65)
# --------------------------------------------------------------------------

_RGB2XYZ = (
    (0.412453, 0.357580, 0.180423),
    (0.212671, 0.715160, 0.072169),
    (0.019334, 0.119193, 0.950227),
)
_XYZ2RGB = (
    (3.240479, -1.537150, -0.498535),
    (-0.969256, 1.875991, 0.041556),
    (0.055648, -0.204043, 1.057311),
)
_WHITE = (0.950456, 1.0, 1.088754)      # D65 reference white


def _srgb_to_linear(c):
    return torch.where(c <= 0.04045, c / 12.92,
                       torch.pow((c + 0.055) / 1.055, 2.4))


def _linear_to_srgb(c):
    c = torch.clamp(c, min=0.0)
    return torch.where(c <= 0.0031308, c * 12.92,
                       1.055 * torch.pow(c, 1.0 / 2.4) - 0.055)


def _cbrt(t):
    # torch has no cbrt: the real cube root through pow of |t|
    return torch.sign(t) * torch.pow(torch.abs(t), 1.0 / 3.0)


@entry
def rgb_to_xyz(rgb: torch.Tensor, *, linear_input: bool = True
               ) -> torch.Tensor:
    """cv2 treats float32 RGB as already linear for XYZ."""
    x = _to_f32_unit(rgb)
    if not linear_input:
        x = _srgb_to_linear(x)
    out = _matvec3(x, _RGB2XYZ)
    return _from_f32_unit(out, rgb) if _is_u8(rgb) else out.to(rgb.dtype)


@entry
def xyz_to_rgb(xyz: torch.Tensor, *, linear_output: bool = True
               ) -> torch.Tensor:
    x = xyz.to(torch.float32)
    if _is_u8(xyz):
        x = x / 255.0
    out = _matvec3(x, _XYZ2RGB)
    if not linear_output:
        out = _linear_to_srgb(out)
    return _from_f32_unit(torch.clamp(out, 0.0, 1.0), xyz)


def _lab_f(t):
    # cv2: threshold 0.008856, slope 7.787, offset 16/116
    return torch.where(t > 0.008856, _cbrt(t), 7.787 * t + 16.0 / 116.0)


def _lab_f_inv(t):
    t3 = t ** 3
    return torch.where(t3 > 0.008856, t3, (t - 16.0 / 116.0) / 7.787)


@entry
def rgb_to_lab(rgb: torch.Tensor) -> torch.Tensor:
    """float32: L ∈ [0, 100], a, b ≈ [−127, 127] (cv2); u8 scaled L·255/100,
    a + 128, b + 128."""
    x = _srgb_to_linear(_to_f32_unit(rgb))
    xyz = _matvec3(x, _RGB2XYZ)
    xn = xyz[..., 0] / _WHITE[0]
    yn = xyz[..., 1] / _WHITE[1]
    zn = xyz[..., 2] / _WHITE[2]
    fx, fy, fz = _lab_f(xn), _lab_f(yn), _lab_f(zn)
    l = torch.where(yn > 0.008856, 116.0 * _cbrt(yn) - 16.0, 903.3 * yn)
    a = 500.0 * (fx - fy)
    b = 200.0 * (fy - fz)
    if _is_u8(rgb):
        return _u8(torch.stack([l * 255.0 / 100.0, a + 128.0, b + 128.0],
                               dim=-1))
    return torch.stack([l, a, b], dim=-1).to(rgb.dtype)


@entry
def lab_to_rgb(lab: torch.Tensor) -> torch.Tensor:
    if _is_u8(lab):
        l = lab[..., 0].to(torch.float32) * (100.0 / 255.0)
        a = lab[..., 1].to(torch.float32) - 128.0
        b = lab[..., 2].to(torch.float32) - 128.0
    else:
        l, a, b = (lab[..., i].to(torch.float32) for i in range(3))
    fy = (l + 16.0) / 116.0
    fx = fy + a / 500.0
    fz = fy - b / 200.0
    xn = _lab_f_inv(fx) * _WHITE[0]
    yn = torch.where(l > 903.3 * 0.008856, fy ** 3, l / 903.3) * _WHITE[1]
    zn = _lab_f_inv(fz) * _WHITE[2]
    lin = _matvec3(torch.stack([xn, yn, zn], dim=-1), _XYZ2RGB)
    return _from_f32_unit(torch.clamp(_linear_to_srgb(lin), 0.0, 1.0), lab)


_UN = 4.0 * _WHITE[0] / (_WHITE[0] + 15.0 + 3.0 * _WHITE[2])
_VN = 9.0 / (_WHITE[0] + 15.0 + 3.0 * _WHITE[2])


@entry
def rgb_to_luv(rgb: torch.Tensor) -> torch.Tensor:
    """CIE L*u*v* (cv2's float32 convention; u8 scaled as cv2)."""
    x = _srgb_to_linear(_to_f32_unit(rgb))
    xyz = _matvec3(x, _RGB2XYZ)
    X, Y, Z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    l = torch.where(Y > 0.008856, 116.0 * _cbrt(Y) - 16.0, 903.3 * Y)
    denom = X + 15.0 * Y + 3.0 * Z
    safe = torch.where(denom > 0, denom, torch.ones_like(denom))
    up = 4.0 * X / safe
    vp = 9.0 * Y / safe
    u = 13.0 * l * (up - _UN)
    v = 13.0 * l * (vp - _VN)
    if _is_u8(rgb):
        return _u8(torch.stack([l * 255.0 / 100.0,
                                (u + 134.0) * 255.0 / 354.0,
                                (v + 140.0) * 255.0 / 262.0], dim=-1))
    return torch.stack([l, u, v], dim=-1).to(rgb.dtype)


@entry
def luv_to_rgb(luv: torch.Tensor) -> torch.Tensor:
    if _is_u8(luv):
        l = luv[..., 0].to(torch.float32) * (100.0 / 255.0)
        u = luv[..., 1].to(torch.float32) * (354.0 / 255.0) - 134.0
        v = luv[..., 2].to(torch.float32) * (262.0 / 255.0) - 140.0
    else:
        l, u, v = (luv[..., i].to(torch.float32) for i in range(3))
    one = torch.ones_like(l)
    zero = torch.zeros_like(l)
    safe_l = torch.where(l > 0, l, one)
    up = u / (13.0 * safe_l) + _UN
    vp = v / (13.0 * safe_l) + _VN
    Y = torch.where(l > 8.0, ((l + 16.0) / 116.0) ** 3, l / 903.3)
    safe_vp = torch.where(vp != 0, vp, one)
    X = torch.where(l > 0, Y * 9.0 * up / (4.0 * safe_vp), zero)
    Z = torch.where(l > 0, Y * (12.0 - 3.0 * up - 20.0 * vp)
                    / (4.0 * safe_vp), zero)
    out = _linear_to_srgb(_matvec3(torch.stack([X, Y, Z], dim=-1), _XYZ2RGB))
    return _from_f32_unit(torch.clamp(out, 0.0, 1.0), luv)


# --------------------------------------------------------------------------
# analog YUV (kornia convention; the video formats are in ops/yuv.py)
# --------------------------------------------------------------------------

_RGB2YUV = (
    (0.299, 0.587, 0.114),
    (-0.14713, -0.28886, 0.436),
    (0.615, -0.51499, -0.10001),
)
_YUV2RGB = (
    (1.0, 0.0, 1.13983),
    (1.0, -0.39465, -0.58060),
    (1.0, 2.03211, 0.0),
)
_YUV_OFFSET = (0.0, 128.0, 128.0)


@entry
def rgb_to_yuv(rgb: torch.Tensor) -> torch.Tensor:
    out = _matvec3(_to_f32_unit(rgb), _RGB2YUV)
    if _is_u8(rgb):
        return _u8(out * 255.0 + const_on(_YUV_OFFSET, rgb.device))
    return out.to(rgb.dtype)


@entry
def yuv_to_rgb(yuv: torch.Tensor) -> torch.Tensor:
    x = yuv.to(torch.float32)
    if _is_u8(yuv):
        x = (x - const_on(_YUV_OFFSET, yuv.device)) / 255.0
    out = torch.clamp(_matvec3(x, _YUV2RGB), 0.0, 1.0)
    return _from_f32_unit(out, yuv)


# --------------------------------------------------------------------------
# sepia
# --------------------------------------------------------------------------

_SEPIA = (
    (0.393, 0.769, 0.189),
    (0.349, 0.686, 0.168),
    (0.272, 0.534, 0.131),
)


@entry
def sepia(rgb: torch.Tensor) -> torch.Tensor:
    out = torch.clamp(_matvec3(_to_f32_unit(rgb), _SEPIA), 0.0, 1.0)
    return _from_f32_unit(out, rgb)


# --------------------------------------------------------------------------
# colormaps: 256-entry u8 LUTs built on the host (color.py:388-578)
# --------------------------------------------------------------------------


def _viridis_lut():
    """Viridis from matplotlib's anchor points, linearly interpolated."""
    anchors = np.array(
        [
            [0.267004, 0.004874, 0.329415],
            [0.282623, 0.140926, 0.457517],
            [0.253935, 0.265254, 0.529983],
            [0.206756, 0.371758, 0.553117],
            [0.163625, 0.471133, 0.558148],
            [0.127568, 0.566949, 0.550556],
            [0.134692, 0.658636, 0.517649],
            [0.266941, 0.748751, 0.440573],
            [0.477504, 0.821444, 0.318195],
            [0.741388, 0.873449, 0.149561],
            [0.993248, 0.906157, 0.143936],
        ],
        dtype=np.float32,
    )
    xi = np.linspace(0.0, 1.0, 256)
    xp = np.linspace(0.0, 1.0, len(anchors))
    lut = np.stack([np.interp(xi, xp, anchors[:, c]) for c in range(3)],
                   axis=-1)
    return (lut * 255.0).round().astype(np.uint8)


def _jet_lut():
    """OpenCV-style jet from the piecewise-linear formula."""
    x = np.linspace(0.0, 1.0, 256)

    def ramp(v):
        return np.clip(1.5 - np.abs(v), 0.0, 1.0)

    lut = np.stack([ramp(4.0 * (x - 0.75)), ramp(4.0 * (x - 0.5)),
                    ramp(4.0 * (x - 0.25))], -1)
    return (lut * 255.0).round().astype(np.uint8)


def _turbo_lut():
    """Google Turbo (its published 6th-order polynomial fit)."""
    x = np.linspace(0.0, 1.0, 256)
    v = np.stack([np.ones_like(x), x, x**2, x**3, x**4, x**5], -1)
    kr = np.array([0.13572138, 4.61539260, -42.66032258, 132.13108234,
                   -152.94239396, 59.28637943])
    kg = np.array([0.09140261, 2.19418839, 4.84296658, -14.18503333,
                   4.27729857, 2.82956604])
    kb = np.array([0.10667330, 12.64194608, -60.58204836, 110.36276771,
                   -89.90310912, 27.34824973])
    lut = np.stack([v @ kr, v @ kg, v @ kb], -1).clip(0, 1)
    return (lut * 255.0).round().astype(np.uint8)


def _hot_lut():
    x = np.linspace(0.0, 1.0, 256)
    lut = np.stack([np.clip(x / 0.4, 0, 1), np.clip((x - 0.4) / 0.4, 0, 1),
                    np.clip((x - 0.8) / 0.2, 0, 1)], -1)
    return (lut * 255.0).round().astype(np.uint8)


def _gray_lut():
    x = np.arange(256, dtype=np.uint8)
    return np.stack([x, x, x], -1)


def _formula_lut(fn):
    """A 256-entry u8 LUT builder from an (x in [0, 1]) → (r, g, b in
    [0, 1]) formula."""

    def build():
        x = np.linspace(0.0, 1.0, 256)
        lut = np.stack(fn(x), -1).clip(0.0, 1.0)
        return (lut * 255.0).round().astype(np.uint8)

    return build


# MATLAB/OpenCV's classic linear maps (public closed forms)
def _autumn(x):
    return np.ones_like(x), x, np.zeros_like(x)


def _winter(x):
    return np.zeros_like(x), x, 1.0 - 0.5 * x


def _spring(x):
    return np.ones_like(x), x, 1.0 - x


def _summer(x):
    return x, 0.5 + 0.5 * x, np.full_like(x, 0.4)


def _cool(x):
    return x, 1.0 - x, np.ones_like(x)


def _ocean(x):
    return np.clip(3 * x - 2, 0, 1), np.clip((3 * x - 1) / 2, 0, 1), x


def _bone(x):
    r = np.where(x < 0.75, 7 / 8 * x, 11 / 8 * x - 3 / 8)
    g = np.where(x < 0.375, 7 / 8 * x,
                 np.where(x < 0.75, 29 / 24 * x - 1 / 8, 7 / 8 * x + 1 / 8))
    b = np.where(x < 0.375, 29 / 24 * x, 7 / 8 * x + 1 / 8)
    return r, g, b


def _pink(x):
    # MATLAB pink = sqrt((2·gray + hot) / 3)
    hr = np.clip(x / 0.4, 0, 1)
    hg = np.clip((x - 0.4) / 0.4, 0, 1)
    hb = np.clip((x - 0.8) / 0.2, 0, 1)
    return (np.sqrt((2 * x + hr) / 3), np.sqrt((2 * x + hg) / 3),
            np.sqrt((2 * x + hb) / 3))


def _hue_ramp(h):
    return (np.clip(np.abs(h - 3.0) - 1.0, 0, 1),
            np.clip(2.0 - np.abs(h - 2.0), 0, 1),
            np.clip(2.0 - np.abs(h - 4.0), 0, 1))


def _hsv_map(x):
    return _hue_ramp(x * 6.0)


def _rainbow(x):
    # violet → blue → green → yellow → red (hue 240° down to 0°)
    return _hue_ramp((1.0 - x) * 4.0 / 6.0 * 6.0)


def _deepgreen(x):
    # black → deep green → white (OpenCV 4.x DEEPGREEN's shape)
    return (np.clip(2 * x - 1, 0, 1), x,
            np.clip(2 * x - 1, 0, 1) * 0.8 + np.clip(3 * x - 2.4, 0, 1) * 0.2)


def _matplotlib_lut(name):
    """matplotlib's published LUT data; ValueError without matplotlib."""

    def build():
        try:
            import matplotlib
        except ImportError as e:
            raise ValueError(f"colormap '{name}' needs matplotlib for its "
                             "published LUT data") from e
        lut = matplotlib.colormaps[name](np.linspace(0.0, 1.0, 256))[:, :3]
        return (lut * 255.0).round().astype(np.uint8)

    return build


_LUT_BUILDERS = {
    "viridis": _viridis_lut,
    "jet": _jet_lut,
    "turbo": _turbo_lut,
    "hot": _hot_lut,
    "gray": _gray_lut,
    "autumn": _formula_lut(_autumn),
    "winter": _formula_lut(_winter),
    "spring": _formula_lut(_spring),
    "summer": _formula_lut(_summer),
    "cool": _formula_lut(_cool),
    "ocean": _formula_lut(_ocean),
    "bone": _formula_lut(_bone),
    "pink": _formula_lut(_pink),
    "hsv": _formula_lut(_hsv_map),
    "rainbow": _formula_lut(_rainbow),
    "deepgreen": _formula_lut(_deepgreen),
    "magma": _matplotlib_lut("magma"),
    "inferno": _matplotlib_lut("inferno"),
    "plasma": _matplotlib_lut("plasma"),
    "cividis": _matplotlib_lut("cividis"),
    "twilight": _matplotlib_lut("twilight"),
    # MATLAB's parula is license-encumbered; viridis is its open stand-in
    "parula": _matplotlib_lut("viridis"),
}


@functools.lru_cache(maxsize=None)
def _lut_on(name: str, device: torch.device) -> torch.Tensor:
    if name not in _LUT_BUILDERS:
        raise ValueError(f"unknown colormap: {name}; available: "
                         f"{sorted(_LUT_BUILDERS)}")
    return torch.from_numpy(_LUT_BUILDERS[name]()).to(device)


@entry
def apply_colormap(gray: torch.Tensor, name: str = "viridis"
                   ) -> torch.Tensor:
    """(..., H, W) or (..., H, W, 1) u8/float gray → (..., H, W, 3) u8 RGB
    through the named 256-entry LUT."""
    lut = _lut_on(name, gray.device)
    if gray.ndim >= 3 and gray.shape[-1] == 1:
        gray = gray[..., 0]
    if _is_u8(gray):
        idx = gray.to(torch.int64)
    else:
        idx = torch.clamp(torch.round(gray * 255.0), 0, 255).to(torch.int64)
    return lut[idx]

