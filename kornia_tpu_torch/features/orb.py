"""ORB detector + descriptor (port of kornia_tpu/features/orb.py).

The FAST score, its 3×3 NMS and the dense Harris map of every pyramid
level come from one CUDA kernel launch per 16 levels
(``cuda_kernels.fast_harris_levels``); then per level the two-tier gate and
the packed per-cell top-k pick candidates and a stable top-k takes the
level budget. The describe stage has three forms, chosen by the
``describe=`` argument of :func:`orb_detect_and_describe` (the reference
picks them by environment variable and backend):

* ``"paired"`` (the default for an even budget sum): all levels in one
  edge-replicated canvas, keypoints 2i and 2i+1 share one (40, 128) window
  (``cuda_kernels.windows_paired``), intensity-centroid orientation on
  those windows, then ``cuda_kernels.brief_rotated``: one kernel that
  rotates the pattern by each keypoint's (cos, sin), samples the window's
  1024 taps and compares, windows in, descriptor bits out;
* ``"unpaired"`` (odd budget sums): one (48, 128) window per keypoint from
  the same kind of canvas (``cuda_kernels.windows``); BRIEF either by
  ``brief="sample"`` (``cuda_kernels.brief_rotated`` on the 48-row layout,
  512 taps per window) or by ``brief="lane_gather"`` (tap coordinates in
  PyTorch ops, four ``cuda_kernels.lane_gather`` passes and a one-hot row
  reduction);
* ``"gather"``: per-level patch gathers in plain PyTorch, no windows.

:func:`orb_detect_and_describe_quadtree` distributes keypoints with the
literal ORB-SLAM3 quadtree on the host and describes per level through
``cuda_kernels.windows``.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import os
from typing import List, NamedTuple, Tuple

import numpy as np
import torch

from kornia_tpu_torch import resolve_device, to_device
from kornia_tpu_torch.features.fast import (_two_tier_gate,
                                            fast_detect_cells,
                                            fast_harris_cells, stable_topk)
from kornia_tpu_torch.features.quadtree import distribute_quadtree
from kornia_tpu_torch.ops import cuda_kernels as ck
from kornia_tpu_torch.ops.filters import gaussian_blur
from kornia_tpu_torch.ops.resize import resize

_PATCH = 31
_HALF = _PATCH // 2  # 15
_PAIR_CX = (32, 96)   # per-half centres in the paired window layout
_WIN_H = 48           # unpaired keypoint window: covers the 31×31
_WIN_W = 128          # orientation patch and all rotated BRIEF taps
_WIN_CY = 24
_WIN_CX = 64


@functools.lru_cache(maxsize=None)
def brief_pattern(seed: int = 7, n_bits: int = 256) -> np.ndarray:
    """(n_bits, 4) int32 (x1, y1, x2, y2) offsets in [-14, 14], the seeded
    Gaussian variant."""
    rng = np.random.default_rng(seed)
    pts = rng.normal(0.0, _PATCH / 5.0, size=(n_bits, 4))
    return np.clip(np.round(pts), -_HALF + 1, _HALF - 1).astype(np.int32)


@functools.lru_cache(maxsize=None)
def brief_pattern_rublee2011() -> np.ndarray:
    """(256, 4) int32: the published learned BRIEF pattern of Rublee et al.
    2011 (OpenCV's ``bit_pattern_31_``), the bit space of ORBvoc-class
    vocabularies."""
    path = os.path.join(os.path.dirname(__file__),
                        "brief_pattern_rublee2011.json")
    with open(path) as f:
        return np.asarray(json.load(f), np.int32)


def _resolve_pattern(pattern: str, seed: int) -> np.ndarray:
    if pattern == "rublee2011":
        return brief_pattern_rublee2011()
    if pattern == "seeded":
        return brief_pattern(seed)
    raise ValueError(f"unknown BRIEF pattern {pattern!r}")


@functools.lru_cache(maxsize=None)
def _pattern_on(pattern: str, seed: int, device) -> torch.Tensor:
    """The (256, 4) int32 pattern on ``device`` (a torch.device or its
    name), uploaded once per (pattern, seed, device)."""
    return torch.from_numpy(_resolve_pattern(pattern, seed)).to(
        device).contiguous()


@functools.lru_cache(maxsize=None)
def _circular_mask() -> np.ndarray:
    """(31, 31) mask of the intensity-centroid circle of radius 15."""
    yy, xx = np.mgrid[-_HALF: _HALF + 1, -_HALF: _HALF + 1]
    return (xx * xx + yy * yy <= _HALF * _HALF).astype(np.float32)


class OrbFeatures(NamedTuple):
    """Fixed-capacity ORB output."""

    xy: torch.Tensor           # (N, 2) float32 in level-0 pixel coords
    score: torch.Tensor        # (N,) response
    angle: torch.Tensor        # (N,) radians
    octave: torch.Tensor       # (N,) int32
    descriptors: torch.Tensor  # (N, 256) uint8 bits in {0, 1}
    mask: torch.Tensor         # (N,) bool valid


@dataclasses.dataclass(frozen=True)
class OrbConfig:
    """ORB-SLAM3 settings, as kornia_tpu's OrbConfig."""

    n_features: int = 2000
    n_levels: int = 8
    scale_factor: float = 1.2
    fast_threshold_high: float = 20.0
    fast_threshold_low: float = 7.0
    cell_size: int = 35
    pattern: str = "rublee2011"
    pattern_seed: int = 7
    harris_rescore: bool = True


def _level_budgets(cfg: OrbConfig) -> List[int]:
    """Per-level keypoint counts ∝ 1/scale^i (ORB-SLAM3 distribution)."""
    inv = [1.0 / cfg.scale_factor ** i for i in range(cfg.n_levels)]
    total = sum(inv)
    raw = [int(round(cfg.n_features * v / total)) for v in inv]
    raw[0] += cfg.n_features - sum(raw)
    return raw


def _pyramid(gray_u8: torch.Tensor, cfg: OrbConfig) -> List[torch.Tensor]:
    h, w = gray_u8.shape
    levels = [gray_u8]
    for i in range(1, cfg.n_levels):
        s = cfg.scale_factor ** i
        nh, nw = int(round(h / s)), int(round(w / s))
        levels.append(resize(levels[-1], (nh, nw)))
    return levels


def _level_candidates(level_img: torch.Tensor, budget: int, cfg: OrbConfig,
                      maps=None):
    """Per-cell-capped candidates of one octave: (xy (C, 2), score (C,)
    with −inf in the invalid slots). ``maps``: the level's (NMS'd score,
    Harris map) from ``cuda_kernels.fast_harris_levels``; None computes
    them for this level alone."""
    lh, lw = level_img.shape
    n_cells = (-(-lh // cfg.cell_size)) * (-(-lw // cfg.cell_size))
    per_cell = max(2, -(-2 * budget // n_cells))
    # the Harris map goes unused when harris_rescore is off
    s_lo, hmap = (maps if maps is not None
                  else ck.fast_harris(level_img, cfg.fast_threshold_low))
    sel = _two_tier_gate(s_lo, cfg.fast_threshold_high, cfg.cell_size)
    common = dict(cell_size=cfg.cell_size,
                  threshold_high=cfg.fast_threshold_high,
                  threshold_low=cfg.fast_threshold_low, per_cell=per_cell,
                  sel=sel)
    if cfg.harris_rescore:
        kps = fast_harris_cells(level_img, hmap, **common)
    else:
        kps = fast_detect_cells(level_img, **common)
    ninf = torch.full_like(kps.score, float("-inf"))
    return kps.xy, torch.where(kps.mask, kps.score, ninf)


def _select_level(level_img: torch.Tensor, budget: int, cfg: OrbConfig,
                  maps=None):
    """Detection + budgeted selection for one octave: (xy level coords,
    vals, valid). The top-k is stable: the lower index first on ties, as
    ``lax.top_k``. ``maps`` as for :func:`_level_candidates`."""
    xy_all, scores = _level_candidates(level_img, budget, cfg, maps)
    vals, idx = stable_topk(scores, budget)
    xy = xy_all[idx]
    valid = torch.isfinite(vals)
    return xy, torch.where(valid, vals, torch.zeros_like(vals)), valid


def _gather_patches(gray_f: torch.Tensor, xy_int: torch.Tensor,
                    half: int) -> torch.Tensor:
    """(K, 2h+1, 2h+1) patches centred at integer keypoints, edge-clamped."""
    h, w = gray_f.shape
    offs = torch.arange(-half, half + 1, device=gray_f.device)
    xy = xy_int.to(torch.int64)
    iy = torch.clamp(xy[:, 1, None, None] + offs[None, :, None], 0, h - 1)
    ix = torch.clamp(xy[:, 0, None, None] + offs[None, None, :], 0, w - 1)
    return gray_f[iy, ix]


def _extract_windows(img_f: torch.Tensor, xy_int: torch.Tensor
                     ) -> torch.Tensor:
    """(K, 48, 128) windows centred at (K, 2) int32 keypoints of one frame,
    edge-replicated at the borders."""
    return ck.windows(img_f.to(torch.float32).contiguous(),
                      xy_int.contiguous(), _WIN_H, _WIN_CY, _WIN_CX)


def _extract_windows_packed(frames: List[torch.Tensor],
                            xys: List[torch.Tensor]) -> torch.Tensor:
    """(K, 48, 128) windows over all levels from ONE stacked canvas: each
    keypoint's y is offset by its level's first canvas row."""
    canvas, starts = ck.prepare_window_canvas(frames, _WIN_H, _WIN_CY)
    xy = torch.cat([
        x + torch.tensor([0, s], dtype=torch.int32, device=x.device)[None]
        for x, s in zip(xys, starts)]).contiguous()
    wimg = max(int(f.shape[1]) for f in frames)
    return ck.windows(canvas, xy, _WIN_H, prepared=(starts[-1], wimg))


def _centroid_angle(patches: torch.Tensor) -> torch.Tensor:
    """Intensity-centroid orientation of (K, 31, 31) patches, radians."""
    dev = patches.device
    mask = torch.from_numpy(_circular_mask()).to(dev)
    offs = torch.arange(-_HALF, _HALF + 1, dtype=torch.float32, device=dev)
    m10 = torch.sum(patches * mask * offs[None, None, :], dim=(1, 2))
    m01 = torch.sum(patches * mask * offs[None, :, None], dim=(1, 2))
    return torch.atan2(m01, m10)


def orientation_from_windows(windows: torch.Tensor) -> torch.Tensor:
    """Intensity-centroid orientation from (K, 48, 128) windows."""
    return _centroid_angle(
        windows[:, _WIN_CY - _HALF: _WIN_CY + _HALF + 1,
                _WIN_CX - _HALF: _WIN_CX + _HALF + 1])


def orientation_ic(gray_f: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """Intensity-centroid orientation at (K, 2) keypoints by a patch
    gather."""
    xy_int = torch.round(xy).to(torch.int32)
    return _centroid_angle(_gather_patches(gray_f, xy_int, _HALF))


def _extract_windows_packed_paired(frames: List[torch.Tensor],
                                   xys: List[torch.Tensor]) -> torch.Tensor:
    """(K/2, 40, 128) paired windows over all levels from ONE stacked
    canvas: each keypoint's y is offset by its level's first canvas row."""
    canvas, starts = ck.prepare_window_canvas(frames)
    xy = torch.cat([
        x + torch.tensor([0, s], dtype=torch.int32, device=x.device)[None]
        for x, s in zip(xys, starts)]).contiguous()
    wimg = max(int(f.shape[1]) for f in frames)
    return ck.windows_paired(canvas, xy, wimg)


def orientation_from_windows_paired(windows: torch.Tensor) -> torch.Tensor:
    """Intensity-centroid orientation from paired (K/2, 40, 128) windows →
    (K,) radians in keypoint order."""
    angs = [_centroid_angle(
        windows[:, ck.PAIR_CY - _HALF: ck.PAIR_CY + _HALF + 1,
                cx - _HALF: cx + _HALF + 1]) for cx in _PAIR_CX]
    return torch.stack(angs, dim=1).reshape(-1)


def _brief_tap_coords(angle: torch.Tensor, seed: int, pattern: str,
                      half_w: int | None = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(K, 512) int32 window-space (rows, cols) of the rotated BRIEF taps,
    [A(256), B(256)], clipped to the window (orb.py:188-210). ``half_w=None``
    is the unpaired (48, 128) window centred at (24, 64); ``half_w`` re-bases
    the columns for a half window centred at lane ``half_w`` and row 20 of
    the 40-row paired layout. The row clip at 40 is active only for a
    seeded pattern tap at ±20 rows, where the two layouts differ as they do
    in the reference."""
    pat = _pattern_on(pattern, seed, angle.device)
    ca, sa = torch.cos(angle), torch.sin(angle)
    px = torch.cat([pat[:, 0], pat[:, 2]]).to(torch.float32)
    py = torch.cat([pat[:, 1], pat[:, 3]]).to(torch.float32)
    dx = torch.round(px[None, :] * ca[:, None]
                     - py[None, :] * sa[:, None]).to(torch.int32)
    dy = torch.round(px[None, :] * sa[:, None]
                     + py[None, :] * ca[:, None]).to(torch.int32)
    if half_w is None:
        cols = torch.clamp(_WIN_CX + dx, 0, _WIN_W - 1)
        rows = torch.clamp(_WIN_CY + dy, 0, _WIN_H - 1)
    else:
        cols = torch.clamp(half_w + dx, 0, 2 * half_w - 1)
        rows = torch.clamp(ck.PAIR_CY + dy, 0, ck.PAIR_WIN_H - 1)
    return rows, cols


def brief_from_windows_paired(windows: torch.Tensor, angle: torch.Tensor,
                              seed: int = 7,
                              pattern: str = "rublee2011") -> torch.Tensor:
    """Rotated BRIEF-256 (K, 256) u8 bits from paired (K/2, 40, 128)
    blurred windows and (K,) angles: each window's 1024 taps (keypoint
    2i's 512 about lane 32, 2i+1's about lane 96) rotated, sampled and
    compared in one ``cuda_kernels.brief_rotated`` pass."""
    return ck.brief_rotated(
        windows.contiguous(), torch.cos(angle), torch.sin(angle),
        _pattern_on(pattern, seed, angle.device), "paired")


def brief_from_windows(windows: torch.Tensor, angle: torch.Tensor,
                       seed: int = 7, pattern: str = "rublee2011",
                       brief: str = "sample") -> torch.Tensor:
    """Rotated BRIEF-256 (K, 256) u8 bits from (K, 48, 128) blurred windows.

    ``brief="sample"``: one ``cuda_kernels.brief_rotated`` pass (rotation,
    the 512 taps of each window, the compare).
    ``brief="lane_gather"``: per group of 128 taps, a lane gather of the tap
    columns from every window row (one index row serves a window's 48
    rows), then a one-hot reduction over the rows (orb.py:239-251). Both
    give the same bits."""
    k = windows.shape[0]
    if brief == "sample":
        return ck.brief_rotated(
            windows.contiguous(), torch.cos(angle), torch.sin(angle),
            _pattern_on(pattern, seed, angle.device), "unpaired")
    if brief != "lane_gather":
        raise ValueError(f"unknown BRIEF formulation {brief!r}")
    rows, cols = _brief_tap_coords(angle, seed, pattern)
    src = windows.reshape(k * _WIN_H, _WIN_W)
    iota_y = torch.arange(_WIN_H, device=windows.device)[None, :, None]
    zero = torch.zeros((), dtype=windows.dtype, device=windows.device)
    samples = []
    for g in range(4):
        cg = cols[:, g * 128: (g + 1) * 128].contiguous()   # (K, 128)
        gathered = ck.lane_gather(src, cg).reshape(k, _WIN_H, 128)
        rg = rows[:, g * 128: (g + 1) * 128]           # (K, 128)
        oh = iota_y == rg[:, None, :]
        samples.append(torch.sum(torch.where(oh, gathered, zero), dim=1))
    s = torch.cat(samples, dim=1)                      # (K, 512)
    return (s[:, :256] < s[:, 256:]).to(torch.uint8)


def brief_describe(blurred_f: torch.Tensor, xy: torch.Tensor,
                   angle: torch.Tensor, seed: int = 7,
                   pattern: str = "rublee2011") -> torch.Tensor:
    """Rotated BRIEF-256 (K, 256) u8 bits by per-tap gathers from the
    blurred frame."""
    pat = _pattern_on(pattern, seed, angle.device).to(torch.float32)
    ca, sa = torch.cos(angle), torch.sin(angle)
    h, w = blurred_f.shape
    cx = torch.round(xy[:, 0]).to(torch.int64)[:, None]
    cy = torch.round(xy[:, 1]).to(torch.int64)[:, None]

    def sample(px, py):
        rx = torch.round(px[None, :] * ca[:, None] - py[None, :] * sa[:, None])
        ry = torch.round(px[None, :] * sa[:, None] + py[None, :] * ca[:, None])
        gx = torch.clamp(cx + rx.to(torch.int64), 0, w - 1)
        gy = torch.clamp(cy + ry.to(torch.int64), 0, h - 1)
        return blurred_f[gy, gx]

    bits = sample(pat[:, 0], pat[:, 1]) < sample(pat[:, 2], pat[:, 3])
    return bits.to(torch.uint8)


def pack_descriptors(bits: torch.Tensor) -> torch.Tensor:
    """(N, 256) {0,1} → (N, 32) uint8, bit j of byte i = bit 8i+j."""
    b = bits.reshape(bits.shape[0], 32, 8).to(torch.int32)
    weights = torch.tensor([1, 2, 4, 8, 16, 32, 64, 128], dtype=torch.int32,
                           device=bits.device)
    return torch.sum(b * weights, dim=-1).to(torch.uint8)


def unpack_descriptors(packed: torch.Tensor) -> torch.Tensor:
    """(N, 32) uint8 → (N, 256) {0,1} bits."""
    shifts = torch.arange(8, dtype=torch.uint8, device=packed.device)
    bits = (packed[..., None] >> shifts) & 1
    return bits.reshape(packed.shape[0], -1)


_DESCRIBE = ("auto", "paired", "unpaired", "gather")
_BRIEF = ("sample", "lane_gather")


def _resolve_describe(describe: str, brief: str, n_keypoints: int) -> str:
    if describe not in _DESCRIBE:
        raise ValueError(f"unknown describe form {describe!r}")
    if brief not in _BRIEF:
        raise ValueError(f"unknown BRIEF formulation {brief!r}")
    if describe == "auto":
        describe = ("paired" if n_keypoints % 2 == 0 and brief == "sample"
                    else "unpaired")
    if describe == "paired" and n_keypoints % 2:
        raise ValueError("the paired describe form needs an even keypoint "
                         "count")
    if brief != "sample" and describe != "unpaired":
        raise ValueError(f"brief={brief!r} exists only in the unpaired "
                         "describe form")
    return describe


def orb_detect_and_describe(gray_u8, cfg: OrbConfig = OrbConfig(),
                            device="cuda", describe: str = "auto",
                            brief: str = "sample") -> OrbFeatures:
    """Multi-scale ORB on an (H, W) u8 frame (numpy or tensor), on
    ``device``.

    ``describe``: "auto" (paired for an even budget sum, else unpaired),
    "paired", "unpaired" or "gather"; ``brief``: "sample" or, in the
    unpaired form only, "lane_gather" (see the module docstring)."""
    dev = resolve_device(device)
    gray = to_device(gray_u8, dev, torch.uint8)
    budgets = _level_budgets(cfg)
    describe = _resolve_describe(describe, brief, sum(budgets))
    levels = _pyramid(gray, cfg)
    maps = ck.fast_harris_levels(levels, cfg.fast_threshold_low)
    sels = [_select_level(img, budget, cfg, m)
            for img, budget, m in zip(levels, budgets, maps)]
    grays_f = [img.to(torch.float32) for img in levels]
    blurs = [gaussian_blur(g, (7, 7), 2.0) for g in grays_f]
    xy_ints = [torch.round(xy).to(torch.int32) for xy, _, _ in sels]
    if describe == "paired":
        ang = orientation_from_windows_paired(
            _extract_windows_packed_paired(grays_f, xy_ints))
        desc = brief_from_windows_paired(
            _extract_windows_packed_paired(blurs, xy_ints), ang,
            cfg.pattern_seed, cfg.pattern)
    elif describe == "unpaired":
        ang = orientation_from_windows(
            _extract_windows_packed(grays_f, xy_ints))
        desc = brief_from_windows(
            _extract_windows_packed(blurs, xy_ints), ang,
            cfg.pattern_seed, cfg.pattern, brief)
    else:
        angs = [orientation_ic(gf, xy)
                for gf, (xy, _, _) in zip(grays_f, sels)]
        desc = torch.cat([
            brief_describe(bl, xy, a, cfg.pattern_seed, cfg.pattern)
            for bl, (xy, _, _), a in zip(blurs, sels, angs)])
        ang = torch.cat(angs)
    xy = torch.cat([s[0] * cfg.scale_factor ** i
                    for i, s in enumerate(sels)])
    score = torch.cat([s[1] for s in sels])
    octv = torch.cat([torch.full((b,), i, dtype=torch.int32, device=dev)
                      for i, b in enumerate(budgets)])
    mask = torch.cat([s[2] for s in sels])
    return OrbFeatures(xy=xy, score=score, angle=ang, octave=octv,
                       descriptors=desc, mask=mask)


def orb_detect_and_describe_quadtree(gray_u8, cfg: OrbConfig = OrbConfig(),
                                     device="cuda", brief: str = "sample"
                                     ) -> OrbFeatures:
    """ORB with the literal ORB-SLAM3 quadtree distribution.

    Per level the FAST candidates (the plain two-tier composition, as the
    reference's quadtree path runs it) come off the device, the
    data-dependent quadtree selects on the host, and orientation + BRIEF run
    on the device at the selected positions, padded to the level budget."""
    if brief not in _BRIEF:
        raise ValueError(f"unknown BRIEF formulation {brief!r}")
    dev = resolve_device(device)
    gray = to_device(gray_u8, dev, torch.uint8)
    budgets = _level_budgets(cfg)
    parts = []
    for i, (img, budget) in enumerate(zip(_pyramid(gray, cfg), budgets)):
        lh, lw = img.shape
        n_cells = (-(-lh // cfg.cell_size)) * (-(-lw // cfg.cell_size))
        per_cell = max(2, -(-2 * budget // n_cells))
        kps = fast_detect_cells(
            img, cell_size=cfg.cell_size,
            threshold_high=cfg.fast_threshold_high,
            threshold_low=cfg.fast_threshold_low, per_cell=per_cell)
        xy_np = kps.xy.cpu().numpy()
        ninf = torch.full_like(kps.score, float("-inf"))
        sc_np = torch.where(kps.mask, kps.score, ninf).cpu().numpy()
        valid = sc_np > 0.0
        sel = distribute_quadtree(xy_np[valid], sc_np[valid], budget, lw, lh)
        chosen = np.nonzero(valid)[0][sel]
        # fixed-shape describe: pad the selection to the budget
        idx = np.concatenate([chosen,
                              np.zeros(budget - len(chosen), np.int64)])
        vmask = np.arange(budget) < len(chosen)

        gray_f = img.to(torch.float32)
        xy = torch.from_numpy(xy_np[idx]).to(dev)
        xy_int = torch.round(xy).to(torch.int32)
        blurred = gaussian_blur(gray_f, (7, 7), 2.0)
        ang = orientation_from_windows(_extract_windows(gray_f, xy_int))
        desc = brief_from_windows(_extract_windows(blurred, xy_int), ang,
                                  cfg.pattern_seed, cfg.pattern, brief)
        score = np.where(vmask, sc_np[idx], 0.0).astype(np.float32)
        parts.append((
            xy * (cfg.scale_factor ** i),
            torch.from_numpy(score).to(dev),
            ang,
            torch.full((budget,), i, dtype=torch.int32, device=dev),
            desc,
            torch.from_numpy(vmask).to(dev),
        ))
    return OrbFeatures(*(torch.cat(field) for field in zip(*parts)))
