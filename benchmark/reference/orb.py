"""Plain ORB and Hamming matching: the reference the front end is judged by.

A frozen copy of the port's plain ORB route (kornia_tpu_torch at commit
7a07e2e: features/orb.py's gather describe form, features/fast.py's
FAST-9 score, 3×3 NMS, two-tier gate, Harris-ranked per-cell top-k and
stable top-k, ops/resize.py's bilinear matrices, ops/filters.py's
Gaussian blur, features/responses.py's central-gradient Harris map,
features/matching.py's cross-checked Lowe matcher) in PyTorch ops only.
It imports nothing of the port. The paired-window describe form the
program runs gives the same numbers as this gather form: its windows are
the edge-replicated image around each keypoint.

``ftype`` is the precision of the image arithmetic (pyramid, Harris,
blur, orientation, the Hamming product): float32 is the configuration's,
bfloat16 the control's. The integer bookkeeping (ranks packed with their
positions, indices) stays exact in either.
"""

from __future__ import annotations

import functools
import json
import math
import os
from typing import NamedTuple

import numpy as np
import torch

_PATCH_HALF = 15
_HARRIS_K = 0.04
_RING = (
    (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
    (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
)
_BIG = 1 << 16


class Features(NamedTuple):
    xy: torch.Tensor           # (N, 2) level-0 pixels
    angle: torch.Tensor        # (N,)
    octave: torch.Tensor       # (N,) int32
    descriptors: torch.Tensor  # (N, 256) u8 bits
    mask: torch.Tensor         # (N,) bool


@functools.lru_cache(maxsize=None)
def brief_pattern() -> np.ndarray:
    """(256, 4) int32: the learned BRIEF pattern of Rublee et al. 2011
    (OpenCV's ``bit_pattern_31_``)."""
    path = os.path.join(os.path.dirname(__file__),
                        "brief_pattern_rublee2011.json")
    with open(path) as f:
        return np.asarray(json.load(f), np.int32)


def level_budgets(n_features: int, n_levels: int, scale: float):
    inv = [1.0 / scale ** i for i in range(n_levels)]
    total = sum(inv)
    raw = [int(round(n_features * v / total)) for v in inv]
    raw[0] += n_features - sum(raw)
    return raw


def level_shapes(hw, n_levels: int, scale: float):
    h, w = hw
    return [(h, w)] + [(int(round(h / scale ** i)), int(round(w / scale ** i)))
                       for i in range(1, n_levels)]


@functools.lru_cache(maxsize=64)
def _bilinear_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) cv2 bilinear weights, out-of-range taps clamped."""
    scale = n_in / n_out
    w = np.zeros((n_out, n_in), dtype=np.float64)
    for i in range(n_out):
        fx = (i + 0.5) * scale - 0.5
        taps = np.arange(int(math.floor(fx - 1.0)), int(math.ceil(fx + 1.0)) + 1)
        wt = np.maximum(0.0, 1.0 - np.abs(taps - fx))
        if wt.sum() != 0:
            wt = wt / wt.sum()
        for j, ww in zip(np.clip(taps, 0, n_in - 1), wt):
            w[i, j] += ww
    return w.astype(np.float32)


def _gauss1d(ksize: int, sigma: float) -> np.ndarray:
    x = np.arange(ksize, dtype=np.float64) - (ksize - 1) * 0.5
    k = np.exp(-(x * x) / (2.0 * sigma * sigma))
    return (k / k.sum()).astype(np.float32)


def _reflect101(n: int, p: int) -> np.ndarray:
    i = np.arange(-p, n + p)
    if n == 1:
        return np.zeros_like(i)
    i = np.mod(i, 2 * (n - 1))
    return np.where(i > n - 1, 2 * (n - 1) - i, i)


def _div(t: torch.Tensor, c: float) -> torch.Tensor:
    """A true division by ``c`` (not a multiply by its reciprocal)."""
    return t / torch.tensor(float(c), dtype=t.dtype, device=t.device)


def _conv_sep(x: torch.Tensor, k: np.ndarray) -> torch.Tensor:
    """Separable (H, W) convolution with reflect-101 borders, in x's type."""
    h, w = x.shape
    p = len(k) // 2
    dev = x.device
    xp = x.index_select(0, torch.from_numpy(_reflect101(h, p)).to(dev))
    xp = xp.index_select(1, torch.from_numpy(_reflect101(w, p)).to(dev))
    out = None
    for i, kv in enumerate(k):
        term = xp[i: i + h, :] * float(kv)
        out = term if out is None else out + term
    out2 = None
    for j, kv in enumerate(k):
        term = out[:, j: j + w] * float(kv)
        out2 = term if out2 is None else out2 + term
    return out2


def _resize_u8(img: torch.Tensor, hw, ftype) -> torch.Tensor:
    wy = torch.from_numpy(_bilinear_matrix(img.shape[0], hw[0])).to(
        img.device, ftype)
    wx = torch.from_numpy(_bilinear_matrix(img.shape[1], hw[1])).to(
        img.device, ftype)
    out = torch.matmul(torch.matmul(wy, img.to(ftype)), wx.T)
    return torch.clamp(torch.round(out.float()), 0, 255).to(torch.uint8)


def _fast_score_nms(x: torch.Tensor, threshold: float) -> torch.Tensor:
    """FAST-9 score (cv2's V measure) zeroed under ``threshold`` and on the
    3-px border, then 3×3 non-maximum suppression."""
    h, w = x.shape
    p = torch.nn.functional.pad(x, (3, 3, 3, 3))
    diff = torch.stack([p[3 + dy: 3 + dy + h, 3 + dx: 3 + dx + w]
                        for dy, dx in _RING]) - x[None]
    arc_min, arc_max = diff, diff
    for c in range(1, 9):
        arc_min = torch.minimum(arc_min, torch.roll(diff, -c, 0))
        arc_max = torch.maximum(arc_max, torch.roll(diff, -c, 0))
    score = torch.maximum(arc_min.amax(0), -arc_max.amin(0))
    score = torch.where(score > threshold, score, torch.zeros_like(score))
    valid = torch.zeros((h, w), dtype=torch.bool, device=x.device)
    valid[3: h - 3, 3: w - 3] = True
    score = torch.where(valid, score, torch.zeros_like(score)).float()
    pooled = torch.nn.functional.max_pool2d(score[None, None], 3, stride=1,
                                            padding=1)[0, 0]
    return torch.where(score >= pooled, score, torch.zeros_like(score))


def _harris(x: torch.Tensor) -> torch.Tensor:
    """det − k·tr² of the Gaussian-windowed (5, σ 1) structure tensor of
    central differences on the edge-replicated image."""
    h, w = x.shape
    dev = x.device
    iy = torch.clamp(torch.arange(-1, h + 1, device=dev), 0, h - 1)
    ix = torch.clamp(torch.arange(-1, w + 1, device=dev), 0, w - 1)
    p = x.index_select(0, iy).index_select(1, ix)
    gx = 0.5 * (p[1:-1, 2:] - p[1:-1, :-2])
    gy = 0.5 * (p[2:, 1:-1] - p[:-2, 1:-1])
    kern = _gauss1d(5, 1.0)
    sxx = _conv_sep(gx * gx, kern)
    syy = _conv_sep(gy * gy, kern)
    sxy = _conv_sep(gx * gy, kern)
    tr = sxx + syy
    return (sxx * syy - sxy * sxy - _HARRIS_K * tr * tr).float()


def _cells(h: int, w: int, cs: int):
    return -(-h // cs), -(-w // cs)


def _cell_max(x: torch.Tensor, cs: int) -> torch.Tensor:
    gy, gx = x.shape[0] // cs, x.shape[1] // cs
    return x.reshape(gy, cs, gx, cs).amax(dim=(1, 3))


def _cell_repeat(m: torch.Tensor, cs: int) -> torch.Tensor:
    gy, gx = m.shape
    return m[:, None, :, None].expand(gy, cs, gx, cs).reshape(gy * cs, gx * cs)


def _two_tier(s_lo: torch.Tensor, hi: float, cs: int) -> torch.Tensor:
    """Cells with a score above ``hi`` keep only those, the rest keep the
    low tier."""
    s_hi = torch.where(s_lo > hi, s_lo, torch.zeros_like(s_lo))
    h, w = s_lo.shape
    gy, gx = _cells(h, w, cs)
    padded = torch.nn.functional.pad(s_hi, (0, gx * cs - w, 0, gy * cs - h))
    has_hi = _cell_repeat(_cell_max(padded, cs) > 0, cs)[:h, :w]
    return torch.where(has_hi, s_hi, s_lo)


def _cell_topk(rank: torch.Tensor, cs: int, per_cell: int):
    """Per-cell top-``per_cell`` of integer ranks (0 = ineligible), cells
    first, ties to the lowest row-major position: (xy, rank)."""
    h, w = rank.shape
    gy, gx = _cells(h, w, cs)
    dev = rank.device
    sp = torch.nn.functional.pad(rank, (0, gx * cs - w, 0, gy * cs - h))
    hh, ww = sp.shape
    ys = (torch.arange(hh, device=dev) % cs)[:, None]
    xs = (torch.arange(ww, device=dev) % cs)[None, :]
    pos = (2047 - (ys * cs + xs)).to(torch.float32)
    sp = torch.where(sp > 0, sp * 2048.0 + pos, torch.zeros_like(sp))
    keys = []
    for _ in range(per_cell):
        m = _cell_max(sp, cs)
        keys.append(m)
        sp = torch.where(sp == _cell_repeat(m, cs), torch.zeros_like(sp), sp)
    k = torch.stack(keys)
    score = torch.floor(k / 2048.0)
    p = 2047.0 - (k - score * 2048.0)
    py = torch.floor(_div(p, cs))
    px = p - py * cs
    cyo = (torch.arange(gy, device=dev, dtype=torch.float32) * cs)[None, :, None]
    cxo = (torch.arange(gx, device=dev, dtype=torch.float32) * cs)[None, None, :]
    xy = torch.stack([px + cxo, py + cyo], dim=-1).permute(1, 2, 0, 3)
    return xy.reshape(-1, 2), score.permute(1, 2, 0).reshape(-1)


def _select(level: torch.Tensor, budget: int, cfg: dict, ftype):
    """One level's keypoints: (xy level pixels (budget, 2), valid)."""
    lh, lw = level.shape
    cs = cfg["cell_size"]
    per_cell = max(2, -(-2 * budget // (_cells(lh, lw, cs)[0]
                                         * _cells(lh, lw, cs)[1])))
    x = level.to(ftype)
    sel = _two_tier(_fast_score_nms(x, cfg["fast_threshold_low"]),
                    cfg["fast_threshold_high"], cs)
    hmap = _harris(x)
    eligible = sel > 0.0
    hmax = torch.where(eligible, hmap, float("-inf")).amax()
    hmin = torch.where(eligible, hmap, float("inf")).amin()
    span = torch.clamp(hmax - hmin, min=1e-12)
    q = torch.floor((hmap - hmin) / span * 8190.0) + 1.0
    q = torch.where(eligible, torch.clamp(q, 1.0, 8191.0),
                    torch.zeros_like(q))
    xy, qv = _cell_topk(q, cs, per_cell)
    # the dequantised Harris score ranks the level's budget
    score = torch.where(qv > 0, _div(qv - 1.0, 8190.0) * span + hmin,
                        torch.zeros_like(qv))
    ranked = torch.where(qv > 0, score, torch.full_like(score, float("-inf")))
    vals, idx = torch.sort(ranked, descending=True, stable=True)
    vals, idx = vals[:budget], idx[:budget]
    return xy[idx], torch.isfinite(vals)


def _centroid_angle(patches: torch.Tensor) -> torch.Tensor:
    dev = patches.device
    yy, xx = np.mgrid[-_PATCH_HALF: _PATCH_HALF + 1,
                      -_PATCH_HALF: _PATCH_HALF + 1]
    mask = torch.from_numpy((xx * xx + yy * yy <= _PATCH_HALF ** 2)
                            .astype(np.float32)).to(dev, patches.dtype)
    offs = torch.arange(-_PATCH_HALF, _PATCH_HALF + 1, device=dev).to(
        patches.dtype)
    m10 = torch.sum(patches * mask * offs[None, None, :], dim=(1, 2))
    m01 = torch.sum(patches * mask * offs[None, :, None], dim=(1, 2))
    return torch.atan2(m01.float(), m10.float())


def _orientation(img: torch.Tensor, xy_int: torch.Tensor) -> torch.Tensor:
    h, w = img.shape
    offs = torch.arange(-_PATCH_HALF, _PATCH_HALF + 1, device=img.device)
    xy = xy_int.to(torch.int64)
    iy = torch.clamp(xy[:, 1, None, None] + offs[None, :, None], 0, h - 1)
    ix = torch.clamp(xy[:, 0, None, None] + offs[None, None, :], 0, w - 1)
    return _centroid_angle(img[iy, ix])


def _brief(blurred: torch.Tensor, xy_int: torch.Tensor,
           angle: torch.Tensor) -> torch.Tensor:
    """Rotated BRIEF-256 bits by per-tap gathers from the blurred level."""
    pat = torch.from_numpy(brief_pattern()).to(angle.device, torch.float32)
    ca, sa = torch.cos(angle), torch.sin(angle)
    h, w = blurred.shape
    cx = xy_int[:, 0].to(torch.int64)[:, None]
    cy = xy_int[:, 1].to(torch.int64)[:, None]

    def sample(px, py):
        rx = torch.round(px[None, :] * ca[:, None] - py[None, :] * sa[:, None])
        ry = torch.round(px[None, :] * sa[:, None] + py[None, :] * ca[:, None])
        gx = torch.clamp(cx + rx.to(torch.int64), 0, w - 1)
        gy = torch.clamp(cy + ry.to(torch.int64), 0, h - 1)
        return blurred[gy, gx]

    return (sample(pat[:, 0], pat[:, 1])
            < sample(pat[:, 2], pat[:, 3])).to(torch.uint8)


def orb(gray_u8, cfg: dict, device, ftype=torch.float32) -> Features:
    """ORB of an (H, W) u8 frame with the configuration's ``orb`` widths
    (n_features, n_levels, scale_factor, fast thresholds, cell_size)."""
    gray = torch.as_tensor(np.asarray(gray_u8)).to(device)
    n_levels, scale = cfg["n_levels"], cfg["scale_factor"]
    budgets = level_budgets(cfg["n_features"], n_levels, scale)
    shapes = level_shapes(gray.shape, n_levels, scale)
    levels = [gray]
    for hw in shapes[1:]:
        levels.append(_resize_u8(levels[-1], hw, ftype))
    kern = _gauss1d(7, 2.0)
    parts = []
    for i, (lv, budget) in enumerate(zip(levels, budgets)):
        xy, valid = _select(lv, budget, cfg, ftype)
        xy_int = torch.round(xy).to(torch.int32)
        img = lv.to(ftype)
        ang = _orientation(img, xy_int)
        desc = _brief(_conv_sep(img, kern), xy_int, ang)
        parts.append((xy * scale ** i, ang,
                      torch.full((budget,), i, dtype=torch.int32,
                                 device=gray.device), desc, valid))
    return Features(*(torch.cat(f) for f in zip(*parts)))


def packbits(bits: torch.Tensor) -> torch.Tensor:
    """(N, 256) bits → (N, 32) u8, most significant bit first."""
    w = 1 << torch.arange(7, -1, -1, dtype=torch.int32, device=bits.device)
    return ((bits != 0).to(torch.int32).reshape(bits.shape[0], -1, 8)
            * w).sum(-1).to(torch.uint8)


def match(a_bits, b_bits, a_mask, b_mask, max_distance: float = 64.0,
          ratio: float = 0.75, ftype=torch.float32) -> torch.Tensor:
    """Cross-checked Lowe-ratio Hamming matches: (N,) int64 train index of
    each query row, −1 where none; ties to the lower index."""
    wide = torch.float64 if ftype == torch.float32 else ftype
    af, bf = a_bits.to(wide), b_bits.to(wide)
    d = (af.sum(1, keepdim=True) + bf.sum(1, keepdim=True).T
         - 2.0 * (af @ bf.T)).to(torch.int64)
    d = torch.where(a_mask[:, None] & b_mask[None, :], d,
                    torch.full_like(d, _BIG))
    best_idx = torch.argmin(d, dim=1)
    best = d.gather(1, best_idx[:, None])[:, 0]
    second = d.scatter(1, best_idx[:, None],
                       torch.iinfo(d.dtype).max).amin(dim=1)
    rows = torch.arange(d.shape[0], device=d.device)
    ok = ((best <= max_distance)
          & (best.to(torch.float32) <= ratio * second.to(torch.float32))
          & (torch.argmin(d, dim=0)[best_idx] == rows))
    return torch.where(ok, best_idx, torch.full_like(best_idx, -1))
