"""ORB detector + descriptor (port of kornia_tpu/features/orb.py).

The pyramid's levels come from :func:`orb_pyramid`: on the card one
kernel, K12, one launch for every level of a frame; on the CPU its plain
version, the chain of bilinear resizes of ``ops/pyramid.scale_pyramid``.
The FAST score, its 3×3 NMS and the dense Harris map of every pyramid
level come from one CUDA kernel launch per 16 levels
(``fast.fast_harris_levels``, K1); then per level the two-tier gate and
the packed per-cell top-k pick candidates and a stable top-k takes the
level budget, all levels in one :func:`orb_select` call (on the card one
kernel, K10, 3 launches a frame). The describe stage has three forms,
chosen by the ``describe=`` argument of :func:`orb_detect_and_describe`
(the reference picks them by environment variable and backend):

* ``"paired"`` (the default for an even budget sum): every level's
  keypoints in one :func:`orb_describe` call, on the card one kernel, K11
  (the levels' blur, intensity-centroid orientation and rotated BRIEF, u8
  levels in, angles and descriptor bits out). Its plain version (the CPU
  route) is the paired composition: all levels in one edge-replicated
  canvas, keypoints 2i and 2i+1 share one (40, 128) window
  (:func:`_extract_windows_packed_paired`, ``cuda_kernels.windows_paired``),
  :func:`orientation_from_windows_paired` on those windows, then
  :func:`brief_from_windows_paired` (``cuda_kernels.brief_rotated``), which
  rotates the pattern by each keypoint's (cos, sin), samples the window's
  1024 taps and compares;
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

import ctypes
import dataclasses
import functools
import json
import os
from typing import List, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from kornia_tpu_torch import resolve_device, to_device
from kornia_tpu_torch.features.fast import (cell_budget, fast_detect_cells,
                                            fast_harris, fast_harris_levels,
                                            select_cells)
from kornia_tpu_torch.features.quadtree import distribute_quadtree
from kornia_tpu_torch.ops import cuda_kernels as ck
from kornia_tpu_torch.ops.filters import (const_on, gaussian_blur,
                                          gaussian_kernel1d)
from kornia_tpu_torch.ops.pyramid import scale_pyramid
from kornia_tpu_torch.ops.resize import matrix_on
from kornia_tpu_torch.utils import tracing

_PATCH = 31
_HALF = _PATCH // 2  # 15
# keypoint windows (ck.WIN_H/WIN_CY/WIN_CX unpaired, ck.PAIR_WIN_H/PAIR_CY
# paired) are 128 lanes wide: they cover the 31×31 orientation patch and
# all rotated BRIEF taps
_WIN_W = 128
_PAIR_CX = (32, 96)   # the lanes the two halves of a paired window centre on
# the Gaussian blur of the describe stage, every form
_BLUR_KSIZE, _BLUR_SIGMA = 7, 2.0


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


@functools.lru_cache(maxsize=None)
def _circular_mask_on(device) -> torch.Tensor:
    """:func:`_circular_mask` on ``device``, uploaded once per device."""
    return torch.from_numpy(_circular_mask()).to(device)


def _centroid_angle(patches: torch.Tensor) -> torch.Tensor:
    """Intensity-centroid orientation of (K, 31, 31) patches, radians."""
    dev = patches.device
    mask = _circular_mask_on(dev)
    offs = torch.arange(-_HALF, _HALF + 1, dtype=torch.float32, device=dev)
    m10 = torch.sum(patches * mask * offs[None, None, :], dim=(1, 2))
    m01 = torch.sum(patches * mask * offs[None, :, None], dim=(1, 2))
    return torch.atan2(m01, m10)


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


# --------------------------------------------------------------------------
# K12: ORB's image pyramid, every level of a frame
# --------------------------------------------------------------------------

# each level starts on a 16-byte boundary of K12's buffer, as a fresh
# allocation would, and is padded to it (a kernel thread stores 4 bytes)
_PYRAMID_ALIGN = 16


class PyramidPlan(NamedTuple):
    """K12's host-side plan for one frame shape."""

    shapes: Tuple[Tuple[int, int], ...]   # every level, level 0 the frame
    offsets: Tuple[int, ...]    # byte offset of level i >= 1 in the buffer
    nbytes: int                 # the buffer's size
    taps: np.ndarray            # (N, 4) int32 rows (i0, i1, w0, w1 bits)
    ytabs: Tuple[int, ...]      # first taps row of level i >= 1's rows
    xtabs: Tuple[int, ...]      # first taps row of its columns


@functools.lru_cache(maxsize=64)
def pyramid_plan(h: int, w: int, n_levels: int,
                 scale_factor: float) -> PyramidPlan:
    """K12's plan for an (h, w) frame: level i is round(dim /
    scale_factor^i) (``ops/pyramid.scale_pyramid``'s rule), resized from
    level i - 1; its output rows and columns take the one or two non-zero
    weights of ``ops/resize._resize_matrix``'s rows
    (``cuda_kernels._resize_taps``), the row table of each level, then its
    column table, one (i0, i1, w0, w1) row each, the weights' f32 bits.
    Raises where a level rounds to no row or column."""
    shapes = [(h, w)] + [(int(round(h / scale_factor ** i)),
                          int(round(w / scale_factor ** i)))
                         for i in range(1, max(n_levels, 1))]
    if any(lh < 1 or lw < 1 for lh, lw in shapes):
        raise ValueError(f"orb_pyramid: {n_levels} levels at "
                         f"{scale_factor} make an empty level of {(h, w)}: "
                         f"{shapes}")
    offsets, rows, ytabs, xtabs = [], [], [], []
    nbytes = n_taps = 0
    for (ph, pw), (lh, lw) in zip(shapes, shapes[1:]):
        offsets.append(nbytes)
        nbytes += -(-lh * lw // _PYRAMID_ALIGN) * _PYRAMID_ALIGN
        for n_in, n_out, tabs in ((ph, lh, ytabs), (pw, lw, xtabs)):
            idx, wt = ck._resize_taps(n_in, n_out)
            rows.append(np.concatenate([idx, wt.view(np.int32)], axis=1))
            tabs.append(n_taps)
            n_taps += n_out
    taps = (np.concatenate(rows) if rows
            else np.zeros((0, 4), np.int32))
    return PyramidPlan(tuple(shapes), tuple(offsets), nbytes,
                       np.ascontiguousarray(taps), tuple(ytabs), tuple(xtabs))


# the high bit of a tap row's second index: the plain chain's product adds
# that output's two taps as two rounded products, not as one FMA chain
_SPLIT_BIT = np.int32(-2 ** 31)
# products the sum order of each output is read from: at least this many
# values an output (over random operands of the product's shape)
_ORDER_SAMPLES = 256


def _fma_f32(a: torch.Tensor, b: torch.Tensor,
             c: torch.Tensor) -> torch.Tensor:
    """f32 fma(a, b, c) of f32 tensors, exact, in float64 ops: a * b is
    exact in float64; the float64 sum s with c and its error e (TwoSum)
    give the exact sum, which rounds to f32 as s does unless s lies on a
    midpoint of the f32 grid, where the sign of e decides."""
    p = a.double() * b.double()
    c = c.double()
    s = p + c
    bb = s - p
    e = (p - (s - bb)) + (c - bb)
    r = s.float()
    r64 = r.double()
    up = torch.nextafter(r, torch.full_like(r, float("inf")))
    dn = torch.nextafter(r, torch.full_like(r, float("-inf")))
    r = torch.where((s == (r64 + up.double()) / 2) & (e > 0), up, r)
    return torch.where((s == (r64 + dn.double()) / 2) & (e < 0), dn, r)


def _split_outputs(tab, src: torch.Tensor, got: torch.Tensor):
    """For one product's outputs (``tab``: their taps i0, i1 (n_out,) and
    w0, w1 (n_out, 1) over the rows of ``src``; each output's values in a
    row of ``got``): (split, fused), each (n_out,) bool, where some value
    is the two taps' rounded products added and not their FMA chain
    fma(w1, x1, w0 * x0), or the other way round; and whether every value
    is one of the two."""
    i0, i1, w0, w1 = tab
    x1 = src[i1]
    # a product of two f32 values is exact in float64, so one cast rounds
    # it; so is the sum of two f32 values that lie within 2^29 of each
    # other, and a smaller one cannot move the sum to an f32 midpoint
    first = (w0.double() * src[i0].double()).float()
    second = (w1.double() * x1.double()).float()
    split = got == (first.double() + second.double()).float()
    fused = got == _fma_f32(w1, x1, first)
    return ((split & ~fused).any(1), (fused & ~split).any(1),
            (fused | split).all())


@functools.lru_cache(maxsize=64)
def pyramid_sum_order(h: int, w: int, n_levels: int, scale_factor: float,
                      device: torch.device) -> np.ndarray:
    """Per row of :func:`pyramid_plan`'s taps, whether the plain chain's
    product on ``device`` adds that output's two taps as two rounded
    products (True) or as one FMA chain over k ascending (False). A
    library's matrix product splits its sum over k where the kernel it
    picks for the product's shapes does (split-K slices, a tile's k range,
    a small-N reduction), which no formula of the weights says; so it is
    read once per frame shape from the products themselves: the two
    ``torch.matmul`` of ``ops/resize.resize`` with its cached matrices, on
    random f32 operands of their shapes, at least _ORDER_SAMPLES values an
    output, compared on ``device`` with both orders computed exactly. An
    output whose values never tell the two apart gets False (the two agree
    for its weights). Raises where an output takes both orders, or a value
    neither."""
    plan = pyramid_plan(h, w, n_levels, scale_factor)
    gen = torch.Generator(device=device).manual_seed(12)
    taps = torch.from_numpy(plan.taps).to(device)
    seen, sound = [], []
    for i, ((ph, pw), (lh, lw)) in enumerate(zip(plan.shapes,
                                                 plan.shapes[1:])):
        wy = matrix_on(ph, lh, "bilinear", False, device)
        wx = matrix_on(pw, lw, "bilinear", False, device)
        # the rows pass Wy @ X (X: ph x pw), then the columns T @ Wx^T
        # (T: lh x pw); each output's values along the other axis
        for first, n_out, shape, product, axis in (
                (plan.ytabs[i], lh, (ph, pw), lambda x: wy @ x, 0),
                (plan.xtabs[i], lw, (lh, pw), lambda t: t @ wx.T, 1)):
            rows = taps[first: first + n_out]
            tab = (rows[:, 0].long(), rows[:, 1].long(),
                   rows[:, 2:3].view(torch.float32),
                   rows[:, 3:4].view(torch.float32))
            split = torch.zeros(n_out, dtype=torch.bool, device=device)
            fused = torch.zeros_like(split)
            for _ in range(min(64, -(-_ORDER_SAMPLES // shape[1 - axis]))):
                src = torch.rand(shape, generator=gen, device=device) * 255
                got = product(src)
                if axis:
                    src, got = src.T, got.T
                s_, f_, ok = _split_outputs(tab, src, got)
                split |= s_
                fused |= f_
                sound.append(ok)
            sound.append(~(split & fused).any())
            seen.append(split)
    if not bool(torch.stack(sound).all()):
        raise ValueError(f"orb_pyramid: the plain chain's products at "
                         f"{plan.shapes} sum some output in an order K12 "
                         "does not take")
    return (torch.cat(seen).cpu().numpy() if seen
            else np.zeros(0, bool))


def pyramid_launches(plan: PyramidPlan):
    """Per K12 launch, the index of its source level and its ctypes
    arguments up to the source pointer (levels, their hs and ws, the
    offsets and table rows of its levels >= 1): up to
    ORB_SELECT_MAX_LEVELS levels a launch (the kernel's table, K10's
    limit), its source included, each launch after the first from the
    last level of the one before."""
    launches = []
    n = len(plan.shapes)
    for first in range(0, n - 1, ORB_SELECT_MAX_LEVELS - 1):
        last = min(first + ORB_SELECT_MAX_LEVELS, n)     # levels [first, last)
        m = last - first
        out = slice(first, last - 1)      # the plan's entries of levels >= 1
        launches.append((first, (
            m, (ctypes.c_int * m)(*[lh for lh, _ in plan.shapes[first:last]]),
            (ctypes.c_int * m)(*[lw for _, lw in plan.shapes[first:last]]),
            (ctypes.c_longlong * (m - 1))(*plan.offsets[out]),
            (ctypes.c_int * (m - 1))(*plan.ytabs[out]),
            (ctypes.c_int * (m - 1))(*plan.xtabs[out]))))
    return tuple(launches)


def pyramid_taps(h: int, w: int, n_levels: int, scale_factor: float,
                 device: torch.device) -> np.ndarray:
    """:func:`pyramid_plan`'s taps with :func:`pyramid_sum_order` on
    ``device`` in the high bit of each row's second index: the table K12
    reads."""
    taps = pyramid_plan(h, w, n_levels, scale_factor).taps.copy()
    split = pyramid_sum_order(h, w, n_levels, scale_factor, device)
    taps[split, 1] |= _SPLIT_BIT
    return taps


@functools.lru_cache(maxsize=64)
def _pyramid_table(h: int, w: int, n_levels: int, scale_factor: float,
                   device: int):
    """:func:`pyramid_plan`, :func:`pyramid_taps` on card ``device``
    (read and uploaded once per frame shape: a host sync) and
    :func:`pyramid_launches`."""
    dev = torch.device("cuda", device)
    plan = pyramid_plan(h, w, n_levels, scale_factor)
    taps = torch.from_numpy(pyramid_taps(h, w, n_levels, scale_factor,
                                         dev)).to(dev)
    return plan, taps, pyramid_launches(plan)


def orb_pyramid(gray: torch.Tensor, n_levels: int,
                scale_factor: float = 1.2) -> List[torch.Tensor]:
    """ORB's geometric pyramid of an (H, W) u8 frame: ``n_levels`` levels,
    level i round(dim / scale_factor^i), each the bilinear resize of the
    one before it (ORB-SLAM's chain), level 0 ``gray`` itself.

    The plain version, ``ops/pyramid.scale_pyramid``, on a CPU tensor; on
    the card one launch for up to ORB_SELECT_MAX_LEVELS levels, byte-equal
    to it, levels >= 1 views of one buffer, no host sync once a frame shape
    has its table (:func:`pyramid_taps`). Raises for a card frame that is
    not a contiguous 2-D u8 tensor and where :func:`pyramid_plan` or
    :func:`pyramid_sum_order` does."""
    if gray.is_cpu:
        return scale_pyramid(gray, n_levels, scale_factor, device=gray.device)
    ck.check(gray, "orb_pyramid frame", torch.uint8, 2)
    if n_levels <= 1:
        return [gray]
    h, w = gray.shape
    plan, taps, launches = _pyramid_table(h, w, int(n_levels),
                                          float(scale_factor),
                                          gray.get_device())
    buf = torch.empty(plan.nbytes, dtype=torch.uint8, device=gray.device)
    levels = [gray] + [buf.as_strided(shape, (shape[1], 1), off)
                       for shape, off in zip(plan.shapes[1:], plan.offsets)]
    fn = ck.kernel("orb_pyramid")
    for first, args in launches:
        rc = fn(*args, levels[first].data_ptr(), buf.data_ptr(),
                taps.data_ptr(), ck.stream(gray))
        ck.launched("orb_pyramid", rc)
    return levels


def _pyramid(gray_u8: torch.Tensor, cfg: OrbConfig) -> List[torch.Tensor]:
    """ORB's pyramid at ``cfg``'s levels and scale: :func:`orb_pyramid`."""
    return orb_pyramid(gray_u8, cfg.n_levels, cfg.scale_factor)


def _select_level(level_img: torch.Tensor, budget: int, cfg: OrbConfig,
                  maps=None):
    """Detection + budgeted selection for one octave: (xy level coords,
    vals, valid), by ``fast.select_cells``. ``maps``: the level's (NMS'd
    score, Harris map) from ``fast.fast_harris_levels``; None computes
    them for this level alone."""
    s_lo, hmap = (maps if maps is not None
                  else fast_harris(level_img, cfg.fast_threshold_low))
    return select_cells(level_img, s_lo, hmap, budget, cfg.cell_size,
                        cfg.fast_threshold_high, cfg.harris_rescore)


# --------------------------------------------------------------------------
# K10: ORB's per-level selection, all levels of a frame
# --------------------------------------------------------------------------

# levels one K10 call takes (the kernel's MAX_LEVELS: its parameter table)
ORB_SELECT_MAX_LEVELS = 32
# slots of one level (the kernel's MAX_SLOTS)
ORB_SELECT_MAX_SLOTS = 1 << 24
# a level's sort keeps an 8-byte key a slot, padded to the next power of
# two: in one block's shared memory up to this many keys (the kernel's
# MAX_SORT: 128 KiB of the 227 KB a block may use), else in the scratch,
# in global memory
ORB_SELECT_SHARED_SORT = 16384


def _pow2(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length()


@functools.lru_cache(maxsize=64)
def orb_select_plan(shapes: Tuple[Tuple[int, int], ...],
                    budgets: Tuple[int, ...], cell_size: int):
    """Per level (cells, per_cell) of ORB's selection on levels of
    ``shapes`` with ``budgets`` keypoints, or None where K10 cannot take
    the frame: no level or more than ORB_SELECT_MAX_LEVELS, cell_size² over
    2048 (the packed key's 11 position bits), an empty level, or a level
    with more than ORB_SELECT_MAX_SLOTS slots."""
    if (not 1 <= len(shapes) <= ORB_SELECT_MAX_LEVELS
            or len(budgets) != len(shapes)
            or not 1 <= cell_size * cell_size <= 2048):
        return None
    plan = []
    for (h, w), b in zip(shapes, budgets):
        if h < 1 or w < 1 or b < 0:
            return None
        cells, per_cell = cell_budget(h, w, b, cell_size)
        if cells * per_cell > ORB_SELECT_MAX_SLOTS:
            return None
        plan.append((cells, per_cell))
    return tuple(plan)


@functools.lru_cache(maxsize=64)
def _select_table(shapes: Tuple[Tuple[int, int], ...],
                  budgets: Tuple[int, ...], cell_size: int):
    """The kernel's (hs, ws, budgets, per_cell) ctypes arrays and the
    scratch's f32 words (8 bytes a cell and a slot, and a sort key of the
    levels sorted in global memory), made once per pyramid shape; raises
    where :func:`orb_select_plan` finds no plan."""
    plan = orb_select_plan(shapes, budgets, cell_size)
    if plan is None:
        raise ValueError(f"orb_select cannot take levels {list(shapes)} with "
                         f"budgets {list(budgets)} and cell {cell_size}")
    n = len(shapes)
    ints = [(ctypes.c_int * n)(*v) for v in (
        [h for h, _ in shapes], [w for _, w in shapes], budgets,
        [p for _, p in plan])]
    keys = [_pow2(c * p) for c, p in plan]
    return (*ints, 2 * sum(c + c * p for c, p in plan)
            + 2 * sum(k for k in keys if k > ORB_SELECT_SHARED_SORT))


def _orb_select_plain(levels, maps, budgets, cell_size, threshold_high,
                      harris_rescore=True):
    """features/fast.py::select_cells on every level: the per-level
    composition (two-tier gate, Harris quantisation, packed cell top-k,
    stable_topk, gather)."""
    return [select_cells(img, s, h, int(b), cell_size, threshold_high,
                         harris_rescore)
            for img, (s, h), b in zip(levels, maps, budgets)]


def orb_select(levels: Sequence[torch.Tensor],
               maps: Sequence[Tuple[torch.Tensor, torch.Tensor]],
               budgets: Sequence[int], cell_size: int, threshold_high: float,
               harris_rescore: bool = True) -> List[Tuple[torch.Tensor, ...]]:
    """ORB's keypoint selection on every (H, W) u8 level of a frame: per
    level (xy (B, 2) f32 level coordinates, vals (B,) f32, valid (B,)
    bool), as ``fast.select_cells`` gives them on ``levels[i]``, K1's
    (score, Harris) pair ``maps[i]`` (``fast.fast_harris_levels``) and
    ``budgets[i]`` keypoints.

    The plain version on a CPU tensor; on the card one call of the kernel,
    3 launches (2 without ``harris_rescore``) for every level together, no
    host sync, the outputs views of one buffer. Raises where
    :func:`orb_select_plan` finds no plan."""
    levels, maps = list(levels), list(maps)
    budgets = tuple(int(b) for b in budgets)
    if not levels or not len(levels) == len(maps) == len(budgets):
        raise ValueError("orb_select: one map pair and one budget a level")
    if levels[0].is_cpu:
        return _orb_select_plain(levels, maps, budgets, cell_size,
                                 threshold_high, harris_rescore)
    shapes = tuple(tuple(img.shape) for img in levels)
    hs, ws, bs, pcs, nf = _select_table(shapes, budgets, int(cell_size))
    # device indices, not torch.device objects: this loop runs every frame
    d = levels[0].get_device()
    for i, (img, pair) in enumerate(zip(levels, maps)):
        if img.dtype != torch.uint8 or img.get_device() != d:
            raise ValueError(f"orb_select level {i}: expected torch.uint8 on "
                             f"{levels[0].device}, got {img.dtype} on "
                             f"{img.device}")
        for t, what in zip(pair, ("score", "Harris")):
            ck.check(t, f"orb_select level {i} {what} map", torch.float32, 2)
            if t.shape != img.shape or t.get_device() != d:
                raise ValueError(f"orb_select level {i}: {what} map "
                                 f"{tuple(t.shape)} on {t.device}, level "
                                 f"{shapes[i]} on {img.device}")
    k = sum(budgets)
    # one buffer: the scratch, xy, vals (f32), then valid (u8)
    nw = nf + 3 * k
    buf = torch.empty(4 * nw + k, dtype=torch.uint8, device=levels[0].device)
    words = buf[:4 * nw].view(torch.float32)
    xy = words[nf:nf + 2 * k].view(k, 2)
    vals = words[nf + 2 * k:]
    valid = buf[4 * nw:].view(torch.bool)
    n = len(levels)
    rescore = bool(harris_rescore)
    rc = ck.kernel("orb_select")(
        n, (ctypes.c_void_p * n)(*[s.data_ptr() for s, _ in maps]),
        (ctypes.c_void_p * n)(*[h.data_ptr() for _, h in maps]),
        hs, ws, bs, pcs, int(cell_size), float(threshold_high), int(rescore),
        buf.data_ptr(), xy.data_ptr(), vals.data_ptr(), valid.data_ptr(),
        ck.stream(levels[0]))
    ck.launched("orb_select", rc, 3 if rescore else 2)
    return list(zip(xy.split(budgets), vals.split(budgets),
                    valid.split(budgets)))


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
                      xy_int.contiguous())


def _extract_windows_packed(frames: List[torch.Tensor],
                            xys: List[torch.Tensor]) -> torch.Tensor:
    """(K, 48, 128) windows over all levels from ONE stacked canvas: each
    keypoint's y is offset by its level's first canvas row."""
    canvas, starts = ck.prepare_window_canvas(frames, ck.WIN_H, ck.WIN_CY)
    wimg = max(int(f.shape[1]) for f in frames)
    return ck.windows(canvas, _canvas_xy(xys, starts),
                      prepared=(starts[-1], wimg))


def _canvas_xy(xys: Sequence[torch.Tensor], starts: Sequence[int]
               ) -> torch.Tensor:
    """(K, 2) int32 canvas keypoints of every level: each level's (x, y)
    with y offset by its first canvas row (``prepare_window_canvas``'s
    ``starts``), the offsets one constant on the keypoints' device (no
    upload once it is made)."""
    offs = const_on(tuple((0, s) for s in starts[:-1]), xys[0].device,
                    torch.int32)
    return torch.cat([x + offs[i] for i, x in enumerate(xys)]).contiguous()


def orientation_from_windows(windows: torch.Tensor) -> torch.Tensor:
    """Intensity-centroid orientation from (K, 48, 128) windows."""
    return _centroid_angle(
        windows[:, ck.WIN_CY - _HALF: ck.WIN_CY + _HALF + 1,
                ck.WIN_CX - _HALF: ck.WIN_CX + _HALF + 1])


def orientation_ic(gray_f: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """Intensity-centroid orientation at (K, 2) keypoints by a patch
    gather."""
    xy_int = torch.round(xy).to(torch.int32)
    return _centroid_angle(_gather_patches(gray_f, xy_int, _HALF))


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
        cols = torch.clamp(ck.WIN_CX + dx, 0, _WIN_W - 1)
        rows = torch.clamp(ck.WIN_CY + dy, 0, ck.WIN_H - 1)
    else:
        cols = torch.clamp(half_w + dx, 0, 2 * half_w - 1)
        rows = torch.clamp(ck.PAIR_CY + dy, 0, ck.PAIR_WIN_H - 1)
    return rows, cols


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
    src = windows.reshape(k * ck.WIN_H, _WIN_W)
    iota_y = torch.arange(ck.WIN_H, device=windows.device)[None, :, None]
    zero = torch.zeros((), dtype=windows.dtype, device=windows.device)
    samples = []
    for g in range(4):
        cg = cols[:, g * 128: (g + 1) * 128].contiguous()   # (K, 128)
        gathered = ck.lane_gather(src, cg).reshape(k, ck.WIN_H, 128)
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


# --------------------------------------------------------------------------
# the paired describe stage: its composition, and K11, all levels of a frame
# --------------------------------------------------------------------------


def _extract_windows_packed_paired(frames: Sequence[torch.Tensor],
                                   xys: Sequence[torch.Tensor]
                                   ) -> torch.Tensor:
    """(K/2, 40, 128) paired windows over all levels from ONE stacked
    canvas: each keypoint's y is offset by its level's first canvas row;
    keypoints 2i and 2i+1 share window i, centred at lanes 32 and 96."""
    canvas, starts = ck.prepare_window_canvas(list(frames))
    wimg = max(int(f.shape[1]) for f in frames)
    return ck.windows_paired(canvas, _canvas_xy(xys, starts), wimg)


def orientation_from_windows_paired(windows: torch.Tensor) -> torch.Tensor:
    """Intensity-centroid orientation from paired (K/2, 40, 128) windows →
    (K,) radians in keypoint order."""
    angs = [_centroid_angle(
        windows[:, ck.PAIR_CY - _HALF: ck.PAIR_CY + _HALF + 1,
                cx - _HALF: cx + _HALF + 1]) for cx in _PAIR_CX]
    return torch.stack(angs, dim=1).reshape(-1)


def brief_from_windows_paired(windows: torch.Tensor, angle: torch.Tensor,
                              pattern: torch.Tensor) -> torch.Tensor:
    """Rotated BRIEF-256 (K, 256) u8 bits from paired (K/2, 40, 128)
    blurred windows, (K,) angles and the (256, 4) int32 pattern: each
    window's 1024 taps (keypoint 2i's 512 about lane 32, 2i+1's about lane
    96) rotated, sampled and compared in one ``cuda_kernels.brief_rotated``
    pass."""
    return ck.brief_rotated(windows.contiguous(), torch.cos(angle),
                            torch.sin(angle), pattern, "paired")


@functools.lru_cache(maxsize=None)
def _blur_taps():
    """The blur's seven f32 taps as K11's ctypes argument."""
    taps = gaussian_kernel1d(_BLUR_KSIZE, _BLUR_SIGMA)
    return (ctypes.c_float * _BLUR_KSIZE)(*[float(v) for v in taps])


def _orb_describe_shape(levels, xys, pattern):
    """Checks shared by the kernel and plain routes of
    :func:`orb_describe`; returns (shapes, budgets)."""
    if not levels or len(levels) != len(xys):
        raise ValueError("orb_describe: one keypoint tensor a level")
    for i, (img, xy) in enumerate(zip(levels, xys)):
        if img.ndim != 2:
            raise ValueError(f"orb_describe level {i}: expected (H, W), got "
                             f"{tuple(img.shape)}")
        if xy.ndim != 2 or xy.shape[1] != 2:
            raise ValueError(f"orb_describe level {i}: xy must be (B, 2), "
                             f"got {tuple(xy.shape)}")
    budgets = tuple(int(xy.shape[0]) for xy in xys)
    if sum(budgets) % 2:
        raise ValueError("orb_describe: the paired form needs an even "
                         "keypoint count")
    if tuple(pattern.shape) != (256, 4):
        raise ValueError("orb_describe: pattern must be (256, 4)")
    return tuple(tuple(img.shape) for img in levels), budgets


@functools.lru_cache(maxsize=64)
def _describe_table(shapes: Tuple[Tuple[int, int], ...],
                    budgets: Tuple[int, ...]):
    """The kernel's (hs, ws, budgets) ctypes arrays, made once per pyramid
    shape; raises where K11 cannot take the frame: no level or more than
    ORB_SELECT_MAX_LEVELS (K10's limit), or an empty level."""
    n = len(shapes)
    if not 1 <= n <= ORB_SELECT_MAX_LEVELS or len(budgets) != n:
        raise ValueError(f"orb_describe takes 1 to {ORB_SELECT_MAX_LEVELS} "
                         f"levels, got {n}")
    if any(h < 1 or w < 1 for h, w in shapes):
        raise ValueError(f"orb_describe cannot take an empty level: "
                         f"{list(shapes)}")
    return tuple((ctypes.c_int * n)(*v) for v in (
        [h for h, _ in shapes], [w for _, w in shapes], budgets))


def _orb_describe_plain(levels, xys, pattern):
    """The paired composition: the f32 levels and their blurs, both
    level-stacked canvases (:func:`_extract_windows_packed_paired`, K2 on
    the card), :func:`orientation_from_windows_paired`, then
    :func:`brief_from_windows_paired` (K3) on the blurred windows."""
    grays_f = [img.to(torch.float32) for img in levels]
    blurs = [gaussian_blur(g, (_BLUR_KSIZE, _BLUR_KSIZE), _BLUR_SIGMA)
             for g in grays_f]
    xy_ints = [torch.round(xy).to(torch.int32) for xy in xys]
    ang = orientation_from_windows_paired(
        _extract_windows_packed_paired(grays_f, xy_ints))
    bits = brief_from_windows_paired(
        _extract_windows_packed_paired(blurs, xy_ints), ang, pattern)
    return ang, bits


def orb_describe_fused(levels: Sequence[torch.Tensor]) -> bool:
    """Whether :func:`orb_describe` runs K11 on these levels (a card
    tensor) rather than its plain version."""
    return not levels[0].is_cpu


def orb_describe(levels: Sequence[torch.Tensor],
                 xys: Sequence[torch.Tensor], pattern: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """ORB's paired describe stage on every (H, W) u8 level of a frame:
    ``xys[i]`` the (B_i, 2) f32 level coordinates of level i's keypoints
    (:func:`orb_select`'s xy), ``pattern`` the (256, 4) int32 BRIEF pattern
    on the levels' device. Returns ((K,) f32 intensity-centroid angles,
    (K, 256) u8 rotated BRIEF bits of the 7 x 7 σ 2 blurred levels), K =
    ΣB_i, even, keypoints in level order.

    The plain version (:func:`_orb_describe_plain`) on a CPU tensor; on the
    card one launch for every level, no host sync, bit-equal to it for any
    keypoint position. Raises where :func:`_describe_table` does."""
    levels, xys = list(levels), list(xys)
    shapes, budgets = _orb_describe_shape(levels, xys, pattern)
    if not orb_describe_fused(levels):
        return _orb_describe_plain(levels, xys, pattern)
    hs, ws, bs = _describe_table(shapes, budgets)
    d = levels[0].get_device()
    for i, (img, xy) in enumerate(zip(levels, xys)):
        ck.check(img, f"orb_describe level {i}", torch.uint8, 2)
        ck.check(xy, f"orb_describe level {i} xy", torch.float32, 2)
        if img.get_device() != d or xy.get_device() != d:
            raise ValueError(f"orb_describe level {i}: level on {img.device}"
                             f" and xy on {xy.device}, not {levels[0].device}")
    ck.check(pattern, "orb_describe pattern", torch.int32, 2)
    if pattern.get_device() != d or pattern.data_ptr() % 16:
        raise ValueError("orb_describe: the pattern must be on the levels' "
                         "device and start on a 16-byte boundary")
    k = sum(budgets)
    angle = torch.empty(k, dtype=torch.float32, device=levels[0].device)
    bits = torch.empty((k, 256), dtype=torch.uint8, device=levels[0].device)
    if k:
        n = len(levels)
        rc = ck.kernel("orb_describe")(
            n, (ctypes.c_void_p * n)(*[img.data_ptr() for img in levels]),
            (ctypes.c_void_p * n)(*[xy.data_ptr() for xy in xys]), hs, ws,
            bs, _blur_taps(), pattern.data_ptr(), angle.data_ptr(),
            bits.data_ptr(), ck.stream(levels[0]))
        ck.launched("orb_describe", rc)
    return angle, bits


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


def _describe(levels: List[torch.Tensor], sels, cfg: OrbConfig,
              describe: str, brief: str):
    """Orientation and descriptor bits of the selected keypoints of every
    level in the resolved ``describe`` form: ((N,) angles, (N, 256) u8)."""
    if describe == "paired":
        return orb_describe(
            levels, [xy for xy, _, _ in sels],
            _pattern_on(cfg.pattern, cfg.pattern_seed, levels[0].device))
    grays_f = [img.to(torch.float32) for img in levels]
    blurs = [gaussian_blur(g, (_BLUR_KSIZE, _BLUR_KSIZE), _BLUR_SIGMA)
             for g in grays_f]
    xy_ints = [torch.round(xy).to(torch.int32) for xy, _, _ in sels]
    if describe == "unpaired":
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
    return ang, desc


def orb_detect_and_describe(gray_u8, cfg: OrbConfig = OrbConfig(),
                            device="cuda", describe: str = "auto",
                            brief: str = "sample") -> OrbFeatures:
    """Multi-scale ORB on an (H, W) u8 frame (numpy or tensor), on
    ``device``.

    ``describe``: "auto" (paired for an even budget sum, else unpaired),
    "paired", "unpaired" or "gather"; ``brief``: "sample" or, in the
    unpaired form only, "lane_gather" (see the module docstring).

    Its stages are spans (``utils.tracing``): ``features.orb`` around the
    call, inside it ``.upload``, ``.pyramid`` (attribute ``"fused"`` on the
    card, K12, else ``"composed"``), ``.fast_harris``, ``.select`` (every
    level in one :func:`orb_select` call, attribute ``"all"``),
    ``.describe`` (attribute ``"fused"`` where the paired form runs on the
    card, K11, else ``"composed"``) and ``.assemble``."""
    with tracing.span("features.orb"):
        dev = resolve_device(device)
        with tracing.span("features.orb.upload"):
            gray = to_device(gray_u8, dev, torch.uint8)
        budgets = _level_budgets(cfg)
        describe = _resolve_describe(describe, brief, sum(budgets))
        with tracing.span("features.orb.pyramid",
                          "composed" if gray.is_cpu else "fused"):
            levels = _pyramid(gray, cfg)
        with tracing.span("features.orb.fast_harris"):
            maps = fast_harris_levels(levels, cfg.fast_threshold_low)
        with tracing.span("features.orb.select", "all"):
            sels = orb_select(levels, maps, budgets, cfg.cell_size,
                              cfg.fast_threshold_high, cfg.harris_rescore)
        route = ("fused" if describe == "paired"
                 and orb_describe_fused(levels) else "composed")
        with tracing.span("features.orb.describe", route):
            ang, desc = _describe(levels, sels, cfg, describe, brief)
        with tracing.span("features.orb.assemble"):
            xy = torch.cat([s[0] * cfg.scale_factor ** i
                            for i, s in enumerate(sels)])
            score = torch.cat([s[1] for s in sels])
            octv = torch.cat([torch.full((b,), i, dtype=torch.int32,
                                         device=dev)
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
        _, per_cell = cell_budget(lh, lw, budget, cfg.cell_size)
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
        blurred = gaussian_blur(gray_f, (_BLUR_KSIZE, _BLUR_KSIZE),
                                _BLUR_SIGMA)
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
