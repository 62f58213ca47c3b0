"""Descriptor matching (port of kornia_tpu/features/matching.py).

For bit descriptors a, b ∈ {0,1}^256, ``hamming(a, b) = |a| + |b| − 2·a·b``,
so the whole N×M distance matrix is one float32 matmul (exact: the sums are
integers ≤ 256; TF32 is off). The JAX package leaves that product to XLA
(matching.py:40-49, no Pallas kernel). Lowe ratio and cross-check are
fixed-shape argmin passes; ties go to the lower index, as in the reference.
Float descriptors match by L2 (:func:`match_descriptors_f32`), map points
by projection into a frame (:func:`match_by_projection`).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from kornia_tpu_torch import resolve_device, to_device
from kornia_tpu_torch.utils import tracing

_BIG = 1 << 16


class Matches(NamedTuple):
    """For each query i, ``idx[i]`` is the matched train index or -1."""

    idx: torch.Tensor    # (N,) int32
    dist: torch.Tensor   # (N,) float32 best distance
    mask: torch.Tensor   # (N,) bool valid match


def hamming_distance_matrix(a_bits: torch.Tensor, b_bits: torch.Tensor,
                            a_mask: Optional[torch.Tensor] = None,
                            b_mask: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """(N, 256) × (M, 256) {0,1} → (N, M) int32; invalid rows get _BIG."""
    af = a_bits.to(torch.float32)
    bf = b_bits.to(torch.float32)
    dots = af @ bf.T
    na = af.sum(dim=1, keepdim=True)
    nb = bf.sum(dim=1, keepdim=True).T
    d = (na + nb - 2.0 * dots).to(torch.int32)
    big = torch.full_like(d, _BIG)
    if a_mask is not None:
        d = torch.where(a_mask[:, None], d, big)
    if b_mask is not None:
        d = torch.where(b_mask[None, :], d, big)
    return d


def _best_two(d: torch.Tensor):
    """Per row of ``d``: (the first minimum's column, the minimum, the
    smallest of the rest), as ``top_k`` of ``−d`` gives them: ties go to
    the lower index, and a tied second is the minimum again."""
    best_idx = torch.argmin(d, dim=1)
    best = d.gather(1, best_idx[:, None])[:, 0]
    big = (float("inf") if d.dtype.is_floating_point
           else torch.iinfo(d.dtype).max)
    second = d.scatter(1, best_idx[:, None], big).amin(dim=1)
    return best_idx, best, second


def match_descriptors(a_bits, b_bits, a_mask=None, b_mask=None,
                      max_distance: float = 64.0,
                      ratio: Optional[float] = 0.75,
                      cross_check: bool = True, device="cuda") -> Matches:
    """Lowe-ratio + cross-check matcher on ``device``; one
    ``features.matching`` span (``utils.tracing``)."""
    with tracing.span("features.matching"):
        dev = resolve_device(device)
        a_bits = to_device(a_bits, dev)
        b_bits = to_device(b_bits, dev)
        a_mask = None if a_mask is None else to_device(a_mask, dev,
                                                       torch.bool)
        b_mask = None if b_mask is None else to_device(b_mask, dev,
                                                       torch.bool)
        d = hamming_distance_matrix(a_bits, b_bits, a_mask, b_mask)
        n = d.shape[0]
        rows = torch.arange(n, device=dev)
        best_idx, best, second = _best_two(d)
        ok = best <= max_distance
        if ratio is not None:
            ok = ok & (best.to(torch.float32)
                       <= ratio * second.to(torch.float32))
        if cross_check:
            b_best = torch.argmin(d, dim=0)
            ok = ok & (b_best[best_idx] == rows)
        return Matches(
            idx=torch.where(ok, best_idx, -1).to(torch.int32),
            dist=best.to(torch.float32),
            mask=ok,
        )


def match_descriptors_f32(a, b, ratio: Optional[float] = 0.8,
                          cross_check: bool = True, a_mask=None, b_mask=None,
                          device="cuda") -> Matches:
    """L2 matcher for (N, D) × (M, D) float descriptors on ``device``:
    ‖a−b‖² = |a|² + |b|² − 2ab from one float32 matmul, Lowe ratio on the
    distances, cross-check; ``dist`` is the best distance (not squared)."""
    dev = resolve_device(device)
    a = to_device(a, dev, torch.float32)
    b = to_device(b, dev, torch.float32)
    dots = a @ b.T
    na = (a * a).sum(dim=1, keepdim=True)
    nb = (b * b).sum(dim=1, keepdim=True).T
    d = torch.clamp(na + nb - 2.0 * dots, min=0.0)
    inf = torch.full_like(d, float("inf"))
    if a_mask is not None:
        d = torch.where(to_device(a_mask, dev, torch.bool)[:, None], d, inf)
    if b_mask is not None:
        d = torch.where(to_device(b_mask, dev, torch.bool)[None, :], d, inf)
    best_idx, best2, second2 = _best_two(d)
    best = torch.sqrt(best2)
    second = torch.sqrt(torch.clamp(second2, min=0.0))
    ok = torch.isfinite(best)
    if ratio is not None:
        ok = ok & (best <= ratio * second)
    if cross_check:
        rows = torch.arange(d.shape[0], device=dev)
        ok = ok & (torch.argmin(d, dim=0)[best_idx] == rows)
    return Matches(idx=torch.where(ok, best_idx, -1).to(torch.int32),
                   dist=best, mask=ok)


def match_by_projection(points3d, point_desc_bits, pose7, k, frame_xy,
                        frame_desc_bits, radius_px: float = 15.0,
                        max_distance: float = 64.0, point_mask=None,
                        frame_mask=None, device="cuda") -> Matches:
    """Projection-guided matching: each (P, 3) map point, moved into the
    camera by the world → camera ``pose7`` and projected with ``k``, is
    matched by Hamming distance only against the (N, 2) frame keypoints
    within ``radius_px`` (the gate folded into the distance matrix). A
    keypoint serves at most one map point: the closest claimant keeps it,
    ties to all of them. Returns Matches over the map points."""
    from kornia_tpu_torch.geometry import liegroup as lg

    dev = resolve_device(device)
    points3d = to_device(points3d, dev, torch.float32)
    pose7 = to_device(pose7, dev, torch.float32)
    k = to_device(k, dev, torch.float32)
    frame_xy = to_device(frame_xy, dev, torch.float32)
    point_mask = (None if point_mask is None
                  else to_device(point_mask, dev, torch.bool))
    frame_mask = (None if frame_mask is None
                  else to_device(frame_mask, dev, torch.bool))
    cam = lg.se3_apply(pose7[None], points3d)
    z = cam[..., 2]
    zs = z[..., None]
    uv = cam[..., :2] / torch.where(torch.abs(zs) < 1e-9,
                                    torch.full_like(zs, 1e-9), zs)
    uv = uv * torch.stack([k[0, 0], k[1, 1]]) + torch.stack([k[0, 2],
                                                             k[1, 2]])
    d = hamming_distance_matrix(to_device(point_desc_bits, dev),
                                to_device(frame_desc_bits, dev),
                                a_mask=point_mask, b_mask=frame_mask)
    sq = ((uv[:, None, :] - frame_xy[None, :, :]) ** 2).sum(dim=-1)
    gate = (sq <= radius_px * radius_px) & (z[:, None] > 1e-6)
    d = torch.where(gate, d, torch.full_like(d, _BIG))
    best = torch.argmin(d, dim=1)
    dmin = d.gather(1, best[:, None])[:, 0]
    ok = dmin <= max_distance
    owner = torch.full((frame_xy.shape[0],), float("inf"), device=dev)
    owner = owner.scatter_reduce(
        0, torch.where(ok, best, torch.zeros_like(best)),
        torch.where(ok, dmin.to(torch.float32),
                    torch.full_like(dmin, float("inf"), dtype=torch.float32)),
        "amin")
    ok = ok & (dmin <= owner[best])
    return Matches(idx=torch.where(ok, best, -1).to(torch.int32),
                   dist=dmin.to(torch.float32), mask=ok)


def unpack_descriptor_bits(packed: torch.Tensor) -> torch.Tensor:
    """(N, 32) u8 packed (np.packbits order, MSB first) → (N, 256) u8
    {0,1} bits, by shifts on the tensor's device."""
    shifts = torch.arange(7, -1, -1, dtype=torch.int32, device=packed.device)
    bits = (packed.to(torch.int32)[:, :, None] >> shifts) & 1
    return bits.reshape(packed.shape[0], packed.shape[1] * 8).to(
        torch.uint8)


def match_descriptors_packed(a_packed, b_packed, a_mask=None, b_mask=None,
                             max_distance: float = 64.0,
                             ratio: Optional[float] = 0.75,
                             cross_check: bool = True,
                             device="cuda") -> Matches:
    """:func:`match_descriptors` over PACKED u8 descriptors (np.packbits
    order), the SLAM loop's entry: unpack on ``device``, then the same
    matmul and argmin passes."""
    dev = resolve_device(device)
    return match_descriptors(
        unpack_descriptor_bits(to_device(a_packed, dev)),
        unpack_descriptor_bits(to_device(b_packed, dev)),
        a_mask=a_mask, b_mask=b_mask, max_distance=max_distance,
        ratio=ratio, cross_check=cross_check, device=dev)


def matched_points(xy_a: torch.Tensor, xy_b: torch.Tensor, matches: Matches
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Matched coordinate pairs, fixed shape (N, 2), and the validity mask."""
    idx = torch.clamp(matches.idx, min=0).to(torch.int64)
    return xy_a, xy_b[idx], matches.mask
