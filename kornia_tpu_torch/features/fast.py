"""FAST corner detection (port of kornia_tpu/features/fast.py).

The dense formulation of the reference: the 16 ring neighbours are static
shifts of the image, the "≥ N contiguous" test is a min/max over N circular
neighbours, NMS is a 3×3 max-pool equality and the per-cell selection is a
packed max-reduce. On the card the score, NMS and Harris map of ORB's levels
come from one CUDA kernel (ops/cuda_kernels.fast_harris), and the score of
the detector path (:func:`fast_detect`, ``_score_dispatch``,
``_score_nms_dispatch``, ``_two_tier_select``) from the same kernel's
score-only forms, at any arc length (ops/cuda_kernels.fast_score);
``fast_score`` and ``nms_maxpool`` here are their plain versions.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from kornia_tpu_torch import entry
from kornia_tpu_torch.ops.filters import div_scalar

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


def _kernel_score(gray, threshold, arc_length, nms, mask):
    from kornia_tpu_torch.ops import cuda_kernels as ck

    return ck.fast_score(gray, threshold, nms=nms, mask=mask,
                         arc_length=arc_length)


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
