"""FAST corner detection (port of kornia_tpu/features/fast.py).

The dense formulation of the reference: the 16 ring neighbours are static
shifts of the image, the "≥ N contiguous" test is a min/max over N circular
neighbours, NMS is a 3×3 max-pool equality and the per-cell selection is a
packed max-reduce. On the card the score, NMS and Harris map of ORB's levels
come from one CUDA kernel, K1 (:func:`fast_harris_levels`), and the score of
the detector path (:func:`fast_detect`, ``_score_dispatch``,
``_score_nms_dispatch``, ``_two_tier_select``) from the same kernel's
score-only forms, at any arc length (``_kernel_score``); ``fast_score``,
``nms_maxpool`` and ``harris_response`` are their plain versions.
"""

from __future__ import annotations

import ctypes
import functools
import operator
from typing import List, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from kornia_tpu_torch import entry
from kornia_tpu_torch.features.responses import harris_response
from kornia_tpu_torch.ops import cuda_kernels as ck
from kornia_tpu_torch.ops.filters import div_scalar, gaussian_kernel1d

# 16-point Bresenham circle of radius 3, clockwise from 12 o'clock
# ((dy, dx) offsets) — the standard FAST-16 ring.
_RING = (
    (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
    (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
)


def _ring_stack(gray_f: torch.Tensor) -> torch.Tensor:
    """(H, W) → (16, H, W) of ring-neighbour values (zero-padded borders)."""
    h, w = gray_f.shape
    p = torch.nn.functional.pad(gray_f, (3, 3, 3, 3))
    return torch.stack([p[3 + dy: 3 + dy + h, 3 + dx: 3 + dx + w]
                        for dy, dx in _RING])


def fast_score(gray: torch.Tensor, threshold: float = 10.0,
               arc_length: int = 9) -> torch.Tensor:
    """Dense FAST corner response, float32 (H, W), 0 where not a corner:
    the largest threshold at which the pixel stays a corner (cv2's V
    measure), zeroed under ``threshold`` and on the 3-px border."""
    x = gray.to(torch.float32)
    diff = _ring_stack(x) - x[None]
    n = arc_length
    # entry i of each reduction covers the arc of n ring entries from i
    arc_min = diff
    arc_max = diff
    for c in range(1, n):
        arc_min = torch.minimum(arc_min, torch.roll(diff, -c, 0))
        arc_max = torch.maximum(arc_max, torch.roll(diff, -c, 0))
    bright = arc_min.amax(0)
    dark = -arc_max.amin(0)
    score = torch.maximum(bright, dark)
    score = torch.where(score > threshold, score, torch.zeros_like(score))
    h, w = x.shape
    valid = torch.zeros((h, w), dtype=torch.bool, device=x.device)
    valid[3: h - 3, 3: w - 3] = True
    return torch.where(valid, score, torch.zeros_like(score))


def nms_maxpool(score: torch.Tensor, radius: int = 1) -> torch.Tensor:
    """(2r+1)² non-maximum suppression by max-pool equality (−inf pad)."""
    k = 2 * radius + 1
    pooled = torch.nn.functional.max_pool2d(
        score[None, None], k, stride=1, padding=radius)[0, 0]
    return torch.where(score >= pooled, score, torch.zeros_like(score))


class FastKeypoints(NamedTuple):
    """Fixed-capacity keypoint set; ``mask`` marks valid entries."""

    xy: torch.Tensor      # (K, 2) float32, (x, y)
    score: torch.Tensor   # (K,) float32
    mask: torch.Tensor    # (K,) bool


def topk_keypoints(score_map: torch.Tensor, k: int) -> FastKeypoints:
    """The ``k`` strongest responses of an (H, W) map as fixed-shape
    keypoints (fast.py:97-119). The reference's ``approx_max_k`` is
    approximate on the TPU only; elsewhere it is ``top_k``, which this is:
    exact, the lower index first on ties (:func:`stable_topk`)."""
    h, w = score_map.shape
    vals, idx = stable_topk(score_map.reshape(-1), k)
    ys = (idx // w).to(torch.float32)
    xs = (idx % w).to(torch.float32)
    return FastKeypoints(xy=torch.stack([xs, ys], dim=-1), score=vals,
                         mask=vals > 0.0)


def _mask_on(border_mask, like: torch.Tensor):
    """The ROI mask (an (H, W) array or tensor, the reference's
    ``StaticMask.arr``) as float32 on ``like``'s device."""
    if border_mask is None:
        return None
    m = torch.as_tensor(border_mask, dtype=torch.float32)
    return m.to(like.device).contiguous()


def _score_dispatch(gray, threshold, arc_length, border_mask=None):
    """The FAST score without NMS (fast.py:122-137), times the ROI mask
    where given: K1's score-only form on the card, the plain version on
    the CPU."""
    mask = _mask_on(border_mask, gray)
    if not gray.is_cpu:
        return _kernel_score(gray, threshold, arc_length, False, mask)
    s = fast_score(gray, threshold, arc_length)
    return s if mask is None else s * mask


def _score_nms_dispatch(gray, threshold, arc_length, border_mask=None):
    """Score + 3×3 NMS (fast.py:140-162). ``border_mask``, 0/1 over
    (H, W), follows the XLA path: the score keeps its 3-px border kill and
    is multiplied by the mask before the NMS (the Pallas path replaces the
    border kill with the mask instead). K1's score-only form on the card,
    the plain composition on the CPU."""
    mask = _mask_on(border_mask, gray)
    if not gray.is_cpu:
        return _kernel_score(gray, threshold, arc_length, True, mask)
    s = fast_score(gray, threshold, arc_length)
    return nms_maxpool(s if mask is None else s * mask)


def fast_arc(arc_length: int) -> int:
    """The arc length K1 computes for ``arc_length`` (it is compiled for
    1..16): the same value, with n <= 1 taken as 1 and n >= 16 as 16, as
    the reference's log-step doubling reduces them (pallas_kernels.py:
    262-272: an arc of n <= 1 is the ring entry itself, an arc of n >= 16
    covers the whole ring)."""
    return min(max(operator.index(arc_length), 1), 16)


def _kernel_score(img: torch.Tensor, threshold: float, arc_length: int,
                  nms: bool, mask: torch.Tensor | None) -> torch.Tensor:
    """(H, W) u8 card tensor → (H, W) f32: the thresholded FAST-n score (n
    = ``arc_length``), 0 on the 3-px border, times the (H, W) f32 ROI
    ``mask`` where given, then 3×3 non-maximum suppression where ``nms``
    is set. K1 without its Harris phases, one launch."""
    n = fast_arc(arc_length)
    ck.check(img, "fast_score image", torch.uint8, 2)
    if mask is not None:
        ck.check(mask, "fast_score mask", torch.float32, 2)
        if mask.shape != img.shape or mask.get_device() != img.get_device():
            raise ValueError(f"fast_score: mask {tuple(mask.shape)} on "
                             f"{mask.device} must be the image's "
                             f"{tuple(img.shape)} on {img.device}")
    h, w = img.shape
    out = torch.empty((h, w), dtype=torch.float32, device=img.device)
    if out.numel():
        rc = ck.kernel("fast_harris", "fast_score")(
            img.data_ptr(), h, w, 0 if mask is None else mask.data_ptr(),
            out.data_ptr(), float(threshold), int(bool(nms)), n,
            ck.stream(img))
        ck.launched("fast_score", rc)
    return out


# --------------------------------------------------------------------------
# K1: FAST score + NMS + Harris of every level of a pyramid
# --------------------------------------------------------------------------

_HARRIS_K = 0.04
# levels one K1 launch takes (the kernel's parameter table)
FAST_HARRIS_MAX_LEVELS = 16


def _fast_harris_plain(img: torch.Tensor, threshold: float):
    """``nms_maxpool(fast_score(img, threshold))`` and the central-gradient
    Harris map, as the CPU reference runs them (fast.py:159-162,
    orb.py:465)."""
    score = nms_maxpool(fast_score(img, threshold, 9))
    hmap = harris_response(img.to(torch.float32), k=_HARRIS_K, block_size=5,
                           sigma=1.0, grad="central")
    return score, hmap


@functools.lru_cache(maxsize=None)
def _harris_window():
    """The five Gaussian window taps (block 5, sigma 1) as the kernel's
    ctypes argument, made once per process."""
    return (ctypes.c_float * 5)(*[float(v) for v in gaussian_kernel1d(5, 1.0)])


@functools.lru_cache(maxsize=64)
def _level_table(shapes: Tuple[Tuple[int, int], ...]):
    """The kernel's (hs, ws) ctypes arrays and the levels' element offsets
    in the flat outputs, made once per pyramid shape."""
    n = len(shapes)
    offs = np.cumsum([0] + [h * w for h, w in shapes]).tolist()
    return ((ctypes.c_int * n)(*[h for h, _ in shapes]),
            (ctypes.c_int * n)(*[w for _, w in shapes]), offs)


def fast_harris_levels(levels: Sequence[torch.Tensor], threshold: float
                       ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """FAST score + NMS and the Harris map of every (H, W) u8 level of a
    pyramid: a list of (score, Harris) pairs, each (H, W) f32. Any number
    of levels, all on one device, in ceil(n / FAST_HARRIS_MAX_LEVELS)
    kernel launches of consecutive levels (the kernel's level table holds
    16); the maps of one launch are contiguous views of one flat buffer
    (every level's score map, then every level's Harris map)."""
    levels = list(levels)
    if not levels:
        return []
    dev = levels[0].device
    if any(img.device != dev for img in levels):
        raise ValueError("fast_harris_levels: every level must be on one "
                         "device")
    for i, img in enumerate(levels):
        if img.dtype != torch.uint8 or img.ndim != 2:
            raise ValueError(f"fast_harris level {i}: expected a 2-D "
                             f"torch.uint8 tensor, got {img.ndim}-D "
                             f"{img.dtype}")
    return [m for i in range(0, len(levels), FAST_HARRIS_MAX_LEVELS)
            for m in _fast_harris_chunk(
                levels[i:i + FAST_HARRIS_MAX_LEVELS], threshold)]


def _fast_harris_chunk(levels: List[torch.Tensor], threshold: float
                       ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """At most FAST_HARRIS_MAX_LEVELS checked levels: their plain versions
    on the CPU, one kernel launch on the card."""
    if levels[0].is_cpu:
        return [_fast_harris_plain(img, threshold) for img in levels]
    for i, img in enumerate(levels):
        ck.check(img, f"fast_harris level {i}", torch.uint8, 2)
    shapes = tuple(tuple(img.shape) for img in levels)
    hs, ws, offs = _level_table(shapes)
    total = offs[-1]
    # one buffer: every level's score map, then every level's Harris map
    out = torch.empty(2 * total, dtype=torch.float32, device=levels[0].device)
    if total:
        n = len(levels)
        rc = ck.kernel("fast_harris")(
            n, (ctypes.c_void_p * n)(*[img.data_ptr() for img in levels]),
            hs, ws, out.data_ptr(), out.data_ptr() + 4 * total,
            float(threshold), _harris_window(), _HARRIS_K,
            ck.stream(levels[0]))
        ck.launched("fast_harris", rc)
    return [(out.as_strided((h, w), (w, 1), off),
             out.as_strided((h, w), (w, 1), total + off))
            for (h, w), off in zip(shapes, offs)]


def fast_harris(img: torch.Tensor, threshold: float
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(H, W) u8 → (NMS'd FAST-9 score, Harris map), both (H, W) f32: the
    one-level call of :func:`fast_harris_levels`."""
    return fast_harris_levels([img], threshold)[0]


@entry
def fast_detect(gray: torch.Tensor, threshold: float = 10.0,
                max_keypoints: int = 2048, nms: bool = True,
                arc_length: int = 9, border_mask=None) -> FastKeypoints:
    """FAST detection on an (H, W) image: dense score → NMS → top-k
    (fast.py:165-186). ``border_mask`` (an (H, W) 0/1 ROI) is this port's
    addition, as ``_score_nms_dispatch`` takes it; None is the reference's
    call."""
    if nms:
        s = _score_nms_dispatch(gray, threshold, arc_length, border_mask)
    else:
        s = _score_dispatch(gray, threshold, arc_length, border_mask)
    return topk_keypoints(s, max_keypoints)


def _cell_grid(h: int, w: int, cs: int):
    return -(-h // cs), -(-w // cs)


def cell_budget(h: int, w: int, budget: int, cell_size: int):
    """(cells, per_cell) of ORB's per-cell cap on an (h, w) level with
    ``budget`` keypoints: per_cell = max(2, ⌈2·budget / cells⌉)
    (orb.py:433-436)."""
    gy, gx = _cell_grid(h, w, cell_size)
    return gy * gx, max(2, -(-2 * budget // (gy * gx)))


def _cell_max(x: torch.Tensor, cs: int) -> torch.Tensor:
    """(gy·cs, gx·cs) → (gy, gx) max over each cs×cs cell."""
    gy, gx = x.shape[0] // cs, x.shape[1] // cs
    return x.reshape(gy, cs, gx, cs).amax(dim=(1, 3))


def _cell_repeat(m: torch.Tensor, cs: int) -> torch.Tensor:
    """(gy, gx) → (gy·cs, gx·cs), each value repeated over its cell (an
    expand: ``repeat_interleave`` waits for the device)."""
    gy, gx = m.shape
    return m[:, None, :, None].expand(gy, cs, gx, cs).reshape(gy * cs,
                                                              gx * cs)


def _two_tier_gate(s_lo: torch.Tensor, threshold_high: float,
                   cell_size: int) -> torch.Tensor:
    """ORB-SLAM3's per-cell hi/lo tier on an NMS'd low-threshold score map:
    cells with any score above ``threshold_high`` keep only those, the
    others keep the low tier. The cell grid is anchored top-left, padded on
    the high edges only (fast.py:207-224)."""
    zero = torch.zeros_like(s_lo)
    s_hi = torch.where(s_lo > threshold_high, s_lo, zero)
    cs = cell_size
    h, w = s_lo.shape
    gy, gx = _cell_grid(h, w, cs)
    padded = torch.nn.functional.pad(s_hi, (0, gx * cs - w, 0, gy * cs - h))
    has_hi = _cell_repeat(_cell_max(padded, cs) > 0, cs)[:h, :w]
    return torch.where(has_hi, s_hi, s_lo)


def _two_tier_select(gray, threshold_high, threshold_low, arc_length,
                     cell_size, border_mask=None):
    """NMS'd FAST score with the two-tier per-cell threshold (one score
    pass and one NMS serve both tiers, fast.py:189-204), the ROI mask
    applied before the NMS as in :func:`_score_nms_dispatch`."""
    s_lo = _score_nms_dispatch(gray, threshold_low, arc_length, border_mask)
    return _two_tier_gate(s_lo, threshold_high, cell_size)


def cell_topk_packed(rank: torch.Tensor, cell_size: int, per_cell: int):
    """Per-cell top-``per_cell`` of an (H, W) map of INTEGER ranks in
    [0, 8191] (0 = ineligible), cells-major output (fast.py:227-271).

    Packs ``rank·2048 + (2047 − pos_in_cell)`` (exact in float32 below
    2²⁴) and takes ``per_cell`` rounds of a per-cell max and suppress, so
    the winner's position rides along in its value and ties go to the
    lowest row-major position, as ``top_k`` on the cell would pick.
    Returns (xy (C·per_cell, 2) f32, score (C·per_cell,) f32)."""
    if cell_size * cell_size > 2048:
        raise ValueError("cell_topk_packed needs cell_size^2 <= 2048")
    h, w = rank.shape
    cs = cell_size
    gy, gx = _cell_grid(h, w, cs)
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
    k = torch.stack(keys)                            # (per_cell, gy, gx)
    score = torch.floor(k / 2048.0)
    p = 2047.0 - (k - score * 2048.0)
    py = torch.floor(div_scalar(p, cs))
    px = p - py * cs
    cyo = (torch.arange(gy, device=dev, dtype=torch.float32) * cs)[None, :, None]
    cxo = (torch.arange(gx, device=dev, dtype=torch.float32) * cs)[None, None, :]
    xy = torch.stack([px + cxo, py + cyo], dim=-1)   # (per_cell, gy, gx, 2)
    xy = xy.permute(1, 2, 0, 3).reshape(-1, 2)
    score = score.permute(1, 2, 0).reshape(-1)
    return torch.where(score[:, None] > 0, xy, torch.zeros_like(xy)), score


def stable_topk(x: torch.Tensor, k: int):
    """``lax.top_k`` along the last axis: the k largest, descending, the
    lower index first on ties (``torch.topk`` does not promise that)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _cell_topk_general(sel: torch.Tensor, cell_size: int, per_cell: int):
    """Per-cell top-k by the transpose + top-k path (any cell size), with
    the same cells-major order and lowest-index tie-break as
    :func:`cell_topk_packed`."""
    h, w = sel.shape
    cs = cell_size
    gy, gx = _cell_grid(h, w, cs)
    dev = sel.device
    cells = torch.nn.functional.pad(sel, (0, gx * cs - w, 0, gy * cs - h))
    cells = cells.reshape(gy, cs, gx, cs).permute(0, 2, 1, 3).reshape(
        gy * gx, cs * cs)
    vals, idx = stable_topk(cells, per_cell)
    cell = torch.arange(gy * gx, device=dev)
    py = idx // cs + (cell // gx * cs)[:, None]
    px = idx % cs + (cell % gx * cs)[:, None]
    xy = torch.stack([px, py], dim=-1).reshape(-1, 2).to(torch.float32)
    return xy, vals.reshape(-1)


def fast_detect_cells(gray: torch.Tensor, cell_size: int = 35,
                      threshold_high: float = 20.0,
                      threshold_low: float = 7.0, per_cell: int = 8,
                      arc_length: int = 9,
                      sel: torch.Tensor = None) -> FastKeypoints:
    """Grid-cell FAST with the two-tier threshold and a per-cell top-k;
    ``sel``, when given, is the gated NMS'd score map of
    :func:`_two_tier_select` (ORB passes the kernel's)."""
    if sel is None:
        sel = _two_tier_select(gray, threshold_high, threshold_low,
                               arc_length, cell_size)
    if gray.dtype == torch.uint8 and cell_size * cell_size <= 2048:
        xy, score = cell_topk_packed(sel, cell_size, per_cell)
    else:
        xy, score = _cell_topk_general(sel, cell_size, per_cell)
    return FastKeypoints(xy=xy, score=score, mask=score > 0.0)


def fast_harris_cells(gray: torch.Tensor, harris_map: torch.Tensor,
                      cell_size: int = 35, threshold_high: float = 20.0,
                      threshold_low: float = 7.0, per_cell: int = 8,
                      arc_length: int = 9,
                      sel: torch.Tensor = None) -> FastKeypoints:
    """FAST-gated, Harris-ranked per-cell detection (fast.py:326-362): the
    Harris value at each NMS'd FAST corner is quantized to 13 bits over the
    eligible range and ranked in-cell; the score returned is the
    dequantized Harris value."""
    if sel is None:
        sel = _two_tier_select(gray, threshold_high, threshold_low,
                               arc_length, cell_size)
    eligible = sel > 0.0
    hmax = torch.where(eligible, harris_map, float("-inf")).amax()
    hmin = torch.where(eligible, harris_map, float("inf")).amin()
    span = torch.clamp(hmax - hmin, min=1e-12)
    q = torch.floor((harris_map - hmin) / span * 8190.0) + 1.0
    q = torch.where(eligible, torch.clamp(q, 1.0, 8191.0),
                    torch.zeros_like(q))
    if cell_size * cell_size <= 2048:
        xy, qv = cell_topk_packed(q, cell_size, per_cell)
    else:
        xy, qv = _cell_topk_general(q, cell_size, per_cell)
    score = torch.where(qv > 0, div_scalar(qv - 1.0, 8190.0) * span + hmin,
                        torch.zeros_like(qv))
    return FastKeypoints(xy=xy, score=score, mask=qv > 0.0)


def cell_candidates(gray: torch.Tensor, s_lo: torch.Tensor,
                    harris_map: torch.Tensor, budget: int, cell_size: int,
                    threshold_high: float, harris_rescore: bool = True):
    """ORB's per-cell-capped candidates on one (H, W) level
    (kornia_tpu/features/orb.py:428-485): the two-tier gate of the level's
    NMS'd low-tier score ``s_lo``, then each cell's top per_cell
    (:func:`cell_budget`), ranked by the quantised Harris value of
    ``harris_map`` (:func:`fast_harris_cells`) or, without
    ``harris_rescore``, by the gated score (the map goes unread). Returns
    (xy (C, 2), score (C,) with −inf in the empty slots), cells-major."""
    _, per_cell = cell_budget(*gray.shape, budget, cell_size)
    sel = _two_tier_gate(s_lo, threshold_high, cell_size)
    common = dict(cell_size=cell_size, threshold_high=threshold_high,
                  per_cell=per_cell, sel=sel)
    if harris_rescore:
        kps = fast_harris_cells(gray, harris_map, **common)
    else:
        kps = fast_detect_cells(gray, **common)
    ninf = torch.full_like(kps.score, float("-inf"))
    return kps.xy, torch.where(kps.mask, kps.score, ninf)


def select_cells(gray: torch.Tensor, s_lo: torch.Tensor,
                 harris_map: torch.Tensor, budget: int, cell_size: int,
                 threshold_high: float, harris_rescore: bool = True):
    """ORB's detection and budgeted selection on one level: the stable
    top ``budget`` of :func:`cell_candidates` (the lower index first on
    ties, as ``lax.top_k``). Returns (xy (budget, 2), vals (budget,),
    valid (budget,)): vals 0 where not valid."""
    xy_all, scores = cell_candidates(gray, s_lo, harris_map, budget,
                                     cell_size, threshold_high,
                                     harris_rescore)
    vals, idx = stable_topk(scores, budget)
    xy = xy_all[idx]
    valid = torch.isfinite(vals)
    return xy, torch.where(valid, vals, torch.zeros_like(vals)), valid
