"""Pyramidal Lucas-Kanade optical flow (port of
kornia_tpu/ops/optical_flow.py), batched over the tracked points.

cv2.calcOpticalFlowPyrLK semantics: an unweighted window cost, status false
when the spatial-gradient matrix is near-singular or the point leaves the
image. Every point runs the same Newton iteration at every pyramid level;
convergence is a per-point mask that freezes the point's displacement.

Three sampling formulations share the math (``method=``):

* ``"gather"``: every patch is a bilinear gather from the frame. Exact at
  any window size; the default on the CPU.
* ``"windows"``: each point's neighbourhood is cut once per level as a
  (48, 128) window (``cuda_kernels.windows``, 4 launches per level) and
  every resample in the Newton loop is two small one-hot matrix products,
  ``R(fy) @ window @ C(fx)ᵀ``. Serves windows up to 27 px.
* ``"taps"``: a (24, 128) window is cut again at the current integer
  estimate in every iteration (``cuda_kernels.windows``, 3 + iterations + 1
  launches per level), so the resample is a 4-tap weighted sum of static
  slices. Serves windows up to 23 px; the default on a CUDA device.

The three clamp differently near the borders by design (the frame edge, the
window edge, the extraction centre), so each is held to the same method of
the JAX package, not to the others. The Newton loop ends when every point is
done or after ``max_iters``; since a finished point is frozen, the result
is that of the fixed-count loop. On a CUDA device that test costs one host
synchronisation per iteration.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, NamedTuple, Tuple

import torch

from kornia_tpu_torch import resolve_device, to_device
from kornia_tpu_torch.ops import cuda_kernels as ck
from kornia_tpu_torch.ops import pyramid as pyr_mod


@dataclass(frozen=True)
class PyrLKParams:
    """cv2-style LK settings, as kornia_tpu's PyrLKParams."""

    window: int = 21
    max_level: int = 3
    max_iters: int = 30
    eps: float = 0.01
    min_eig_threshold: float = 1e-4


class FlowResult(NamedTuple):
    points: torch.Tensor   # (N, 2) tracked xy in the next image
    status: torch.Tensor   # (N,) bool, tracked successfully
    errors: torch.Tensor   # (N,) mean |I - J| over the window


def _scharr_gradients(img: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """3×3 Scharr derivatives of an (H, W) f32 image (cv2's choice for LK),
    replicated border: a central difference along the derivative axis,
    [3 10 3] smoothing along the other, /32 overall."""
    p = torch.nn.functional.pad(img[None, None], (1, 1, 1, 1),
                                mode="replicate")[0, 0]
    gx = p[:, 2:] - p[:, :-2]
    gx = (gx[:-2] * 3 + gx[1:-1] * 10 + gx[2:] * 3) * (1.0 / 32.0)
    gy = p[2:, :] - p[:-2, :]
    gy = (gy[:, :-2] * 3 + gy[:, 1:-1] * 10 + gy[:, 2:] * 3) * (1.0 / 32.0)
    return gx, gy


def _inside(end: torch.Tensor, h: int, w: int) -> torch.Tensor:
    return ((end[:, 0] >= 0) & (end[:, 0] <= w - 1)
            & (end[:, 1] >= 0) & (end[:, 1] <= h - 1))


def _solve_level(ip: torch.Tensor, ix: torch.Tensor, iy: torch.Tensor,
                 sample_j: Callable[[torch.Tensor], torch.Tensor],
                 params: PyrLKParams):
    """The Newton iteration of one level for all points.

    ``ip``, ``ix``, ``iy``: (N, win²) template and gradient patches;
    ``sample_j(d)``: the (N, win²) patch of the next frame at displacement
    ``d`` (N, 2) from the initial guess. Returns (d, ok, err, iterations
    run). A point is done at the first step shorter than ``eps`` (or from
    the start when its gradient matrix is near-singular) and keeps its
    ``d`` from then on."""
    a11 = torch.sum(ix * ix, dim=1)
    a12 = torch.sum(ix * iy, dim=1)
    a22 = torch.sum(iy * iy, dim=1)
    det = a11 * a22 - a12 * a12
    tr = a11 + a22
    min_eig = (tr - torch.sqrt(torch.clamp(tr * tr - 4 * det, min=0.0))) / 2.0
    ok = min_eig / (params.window * params.window) > params.min_eig_threshold
    inv_det = torch.where(det > 1e-12, 1.0 / det, torch.zeros_like(det))

    d = torch.zeros((ip.shape[0], 2), dtype=torch.float32, device=ip.device)
    done = ~ok
    iters = 0
    while iters < params.max_iters and not bool(done.all()):
        diff = ip - sample_j(d)
        b1 = torch.sum(diff * ix, dim=1)
        b2 = torch.sum(diff * iy, dim=1)
        du = (a22 * b1 - a12 * b2) * inv_det
        dv = (a11 * b2 - a12 * b1) * inv_det
        step = torch.stack([du, dv], dim=1)
        d = torch.where(done[:, None], d, d + step)
        done = done | (torch.sum(step * step, dim=1)
                       < params.eps * params.eps)
        iters += 1
    err = torch.mean(torch.abs(ip - sample_j(d)), dim=1)
    return d, ok, err, iters


# ---------------------------------------------------------------------
# gather formulation


def _bilinear_patch(img: torch.Tensor, centers: torch.Tensor,
                    offsets: torch.Tensor) -> torch.Tensor:
    """(N, win²) patches at subpixel ``centers`` (N, 2) xy + ``offsets``
    (win², 2); coordinates clipped to [0, size − 1.001]."""
    h, w = img.shape
    x = torch.clamp(centers[:, None, 0] + offsets[None, :, 0], 0.0, w - 1.001)
    y = torch.clamp(centers[:, None, 1] + offsets[None, :, 1], 0.0, h - 1.001)
    x0f = torch.floor(x)
    y0f = torch.floor(y)
    fx = x - x0f
    fy = y - y0f
    x0 = x0f.to(torch.int64)
    y0 = y0f.to(torch.int64)
    x1 = torch.clamp(x0 + 1, max=w - 1)
    y1 = torch.clamp(y0 + 1, max=h - 1)
    v00 = img[y0, x0]
    v01 = img[y0, x1]
    v10 = img[y1, x0]
    v11 = img[y1, x1]
    return ((1 - fy) * ((1 - fx) * v00 + fx * v01)
            + fy * ((1 - fx) * v10 + fx * v11))


def _track_level_gather(prev, nxt, gx, gy, pts, guess, params):
    win = params.window
    half = (win - 1) / 2.0
    r = torch.arange(win, dtype=torch.float32, device=prev.device) - half
    oy, ox = torch.meshgrid(r, r, indexing="ij")
    offsets = torch.stack([ox.reshape(-1), oy.reshape(-1)], dim=1)
    ip = _bilinear_patch(prev, pts, offsets)
    ix = _bilinear_patch(gx, pts, offsets)
    iy = _bilinear_patch(gy, pts, offsets)
    d, ok, err, iters = _solve_level(
        ip, ix, iy,
        lambda d: _bilinear_patch(nxt, pts + guess + d, offsets), params)
    h, w = prev.shape
    return d, ok & _inside(pts + guess + d, h, w), err, iters


# ---------------------------------------------------------------------
# windows formulation: per-point windows + separable one-hot products
_LKW_H = 48       # window rows
_LKW_W = 64       # window columns kept of the 128 extracted (±21 px of
#                   Newton drift)
_LKW_CY = 24      # window-space row of the point centre
_LKW_CX = 32      # window-space column of the point centre


def _clip_centers(xy_int: torch.Tensor, h: int, w: int) -> torch.Tensor:
    lim = torch.tensor([w - 1, h - 1], dtype=torch.int32,
                       device=xy_int.device)
    return torch.minimum(torch.clamp(xy_int, min=0), lim).contiguous()


def _extract_lk_windows(img: torch.Tensor, centers: torch.Tensor
                        ) -> torch.Tensor:
    """(N, 48, 64) edge-replicated windows at integer ``centers`` (xy)."""
    w128 = ck.windows(img, centers, _LKW_H, _LKW_CY, 64)
    return w128[:, :, 64 - _LKW_CX: 64 + (_LKW_W - _LKW_CX)]


def _sep_weights(base: torch.Tensor, n: int, size: int) -> torch.Tensor:
    """(N, n, size) separable bilinear one-hot rows: row i holds (1 − f) at
    floor(base + i) and f at floor(base + i) + 1, positions clipped to
    [0, size − 1.001] in window space."""
    dev = base.device
    t = base[:, None] + torch.arange(n, dtype=torch.float32, device=dev)
    t = torch.clamp(t, 0.0, size - 1.001)
    t0 = torch.floor(t)
    f = t - t0
    idx = torch.arange(size, dtype=torch.float32, device=dev)
    lo = (idx == t0[..., None]).to(torch.float32)
    hi = (idx == (t0 + 1.0)[..., None]).to(torch.float32)
    return lo * (1.0 - f)[..., None] + hi * f[..., None]


def _sample_window_patch(win: torch.Tensor, off_xy: torch.Tensor,
                         n: int) -> torch.Tensor:
    """(N, n²) bilinear patches from (N, H, W) windows, centred at the
    window centre + subpixel ``off_xy``: two batched matrix products."""
    half = (n - 1) / 2.0
    ry = _sep_weights(off_xy[:, 1] + (_LKW_CY - half), n, win.shape[1])
    cx = _sep_weights(off_xy[:, 0] + (_LKW_CX - half), n, win.shape[2])
    return torch.bmm(torch.bmm(ry, win), cx.transpose(1, 2)).reshape(
        win.shape[0], n * n)


def _track_level_windows(prev, nxt, gx, gy, pts, guess, params):
    h, w = prev.shape
    win = params.window
    tgt = pts + guess
    # the extractor takes in-image centres (the content is edge-replicated)
    cen_prev = _clip_centers(torch.round(pts).to(torch.int32), h, w)
    cen_nxt = _clip_centers(torch.round(tgt).to(torch.int32), h, w)
    prevw = _extract_lk_windows(prev, cen_prev)
    gxw = _extract_lk_windows(gx, cen_prev)
    gyw = _extract_lk_windows(gy, cen_prev)
    nxtw = _extract_lk_windows(nxt, cen_nxt)
    sub_prev = pts - cen_prev.to(torch.float32)
    off_nxt = tgt - cen_nxt.to(torch.float32)
    d, ok, err, iters = _solve_level(
        _sample_window_patch(prevw, sub_prev, win),
        _sample_window_patch(gxw, sub_prev, win),
        _sample_window_patch(gyw, sub_prev, win),
        lambda d: _sample_window_patch(nxtw, off_nxt + d, win), params)
    return d, ok & _inside(tgt + d, h, w), err, iters


# ---------------------------------------------------------------------
# taps formulation: windows of win + 1 rows cut again at the current
# integer estimate in every iteration, so the subpixel resample is a 4-tap
# weighted sum of static window slices
_TAPS_H = 24     # extraction rows (win + 1 <= 24)
_TAPS_M = 8      # placement margin: patch top-lefts down to −8 px stay in
#                  the edge-replicated border instead of being shifted by
#                  the clamp (coarse levels put near-border points there)
_TAPS_CX = 64    # extraction column offset


def _four_tap(w: torch.Tensor, f: torch.Tensor, win: int) -> torch.Tensor:
    """(N, win²) bilinear patches from (N, 24, 128) taps windows whose patch
    top-left sits at window (row 0, column _TAPS_CX − _TAPS_M) + the
    fraction ``f``."""
    fx = f[:, 0][:, None, None]
    fy = f[:, 1][:, None, None]
    c = _TAPS_CX - _TAPS_M
    w00 = w[:, 0:win, c: c + win]
    w01 = w[:, 0:win, c + 1: c + win + 1]
    w10 = w[:, 1: win + 1, c: c + win]
    w11 = w[:, 1: win + 1, c + 1: c + win + 1]
    out = ((1 - fy) * ((1 - fx) * w00 + fx * w01)
           + fy * ((1 - fx) * w10 + fx * w11))
    return out.reshape(w.shape[0], win * win)


def _track_level_taps(prev, nxt, gx, gy, pts, guess, params):
    win = params.window
    h, w = prev.shape
    half = (win - 1) / 2.0

    def patches(img, target):
        """Patches whose top-left lands at target − half. Top-lefts down
        to −_TAPS_M ride the replicated margin unshifted; beyond that the
        clamp of the extraction centre shifts the placement."""
        base = target - half
        cen = _clip_centers(torch.floor(base).to(torch.int32) + _TAPS_M,
                            h, w)
        f = torch.clamp(base - (cen - _TAPS_M).to(torch.float32), 0.0, 1.0)
        return _four_tap(ck.windows(img, cen, _TAPS_H, _TAPS_M, _TAPS_CX),
                         f, win)

    d, ok, err, iters = _solve_level(
        patches(prev, pts), patches(gx, pts), patches(gy, pts),
        lambda d: patches(nxt, pts + guess + d), params)
    return d, ok & _inside(pts + guess + d, h, w), err, iters


# Largest params.window the fixed (48, 64) window serves with a useful
# Newton-drift budget; larger ones go to the gather formulation.
_LKW_MAX_WIN = 27
# Largest window the 24-row taps extraction serves (win + 1 rows).
_TAPS_MAX_WIN = _TAPS_H - 1

_TRACKERS = {"gather": _track_level_gather, "windows": _track_level_windows,
             "taps": _track_level_taps}


def _resolve_method(method: str, window: int, device=None) -> str:
    """Resolve "auto" ("taps" on a CUDA device, "gather" on the CPU) and
    apply the capacity guards: ``taps`` and ``windows`` clamp sampling
    beyond their extraction windows, so oversized requests route down the
    chain taps → windows → gather."""
    if method == "auto":
        on_card = device is not None and torch.device(device).type == "cuda"
        method = "taps" if on_card else "gather"
    if method not in _TRACKERS:
        raise ValueError(f"unknown LK method {method!r}")
    if method == "taps" and window > _TAPS_MAX_WIN:
        method = "windows"
    if method == "windows" and window > _LKW_MAX_WIN:
        return "gather"
    return method


class LKPrecomputed(NamedTuple):
    """Reusable per-frame pyramids + gradients: when tracking many point
    sets against the same frame pair, the stack is built once."""

    prev_levels: Tuple[torch.Tensor, ...]
    next_levels: Tuple[torch.Tensor, ...]
    gx_levels: Tuple[torch.Tensor, ...]
    gy_levels: Tuple[torch.Tensor, ...]


def build_lk_precomputed(prev_gray, next_gray,
                         params: PyrLKParams = PyrLKParams(),
                         device="cuda") -> LKPrecomputed:
    """Build the pyramid + Scharr gradient stack for both frames ((H, W) or
    (H, W, 1), numpy or tensor) on ``device``."""
    dev = resolve_device(device)

    def levels(gray):
        f = to_device(gray, dev).to(torch.float32)
        if f.ndim == 3:
            f = f[..., 0]
        out = [f.contiguous()]
        for _ in range(params.max_level):
            out.append(pyr_mod.pyrdown(out[-1]).contiguous())
        return out

    prevs, nxts = levels(prev_gray), levels(next_gray)
    grads = [_scharr_gradients(p) for p in prevs]
    return LKPrecomputed(
        prev_levels=tuple(prevs), next_levels=tuple(nxts),
        gx_levels=tuple(g[0].contiguous() for g in grads),
        gy_levels=tuple(g[1].contiguous() for g in grads))


def calc_optical_flow_pyr_lk_with_precomputed(
        pre: LKPrecomputed, points, params: PyrLKParams = PyrLKParams(),
        method: str = "auto", stats: dict | None = None) -> FlowResult:
    """Track (N, 2) xy points using a prebuilt pyramid stack, on the stack's
    device. ``stats``, when given, receives ``method`` and ``iterations``
    (Newton iterations run per level, finest level first)."""
    dev = pre.prev_levels[0].device
    method = _resolve_method(method, params.window, dev)
    track = _TRACKERS[method]
    points = to_device(points, dev).to(torch.float32)
    n_levels = len(pre.prev_levels)
    status = torch.ones(points.shape[0], dtype=torch.bool, device=dev)
    err = torch.zeros(points.shape[0], dtype=torch.float32, device=dev)
    flow = torch.zeros_like(points)
    iterations = [0] * n_levels
    for lvl in range(n_levels - 1, -1, -1):
        d, ok, err, iterations[lvl] = track(
            pre.prev_levels[lvl], pre.next_levels[lvl], pre.gx_levels[lvl],
            pre.gy_levels[lvl], points / (2.0 ** lvl), flow, params)
        flow = flow + d
        status = status & ok
        if lvl > 0:
            flow = flow * 2.0
    if stats is not None:
        stats.update(method=method, iterations=iterations)
    return FlowResult(points=points + flow, status=status, errors=err)


def calc_optical_flow_pyr_lk(prev_gray, next_gray, points,
                             params: PyrLKParams = PyrLKParams(),
                             method: str = "auto", device="cuda",
                             stats: dict | None = None) -> FlowResult:
    """Pyramidal LK: track ``points`` (N, 2) xy from ``prev_gray`` to
    ``next_gray`` on ``device``. ``method``: "auto" ("taps" on a CUDA
    device, "gather" on the CPU), "taps", "windows" or "gather"; windows
    too large for a formulation route down the chain to "gather"."""
    pre = build_lk_precomputed(prev_gray, next_gray, params, device)
    return calc_optical_flow_pyr_lk_with_precomputed(pre, points, params,
                                                     method, stats)
