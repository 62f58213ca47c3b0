"""Descriptor matching (port of kornia_tpu/features/matching.py).

For bit descriptors a, b ∈ {0,1}^256, ``hamming(a, b) = |a| + |b| − 2·a·b``,
so the whole N×M distance matrix is one float32 matmul (exact: the sums are
integers ≤ 256; TF32 is off). The JAX package leaves that product to XLA
(matching.py:40-49, no Pallas kernel). Lowe ratio and cross-check are
fixed-shape argmin passes; ties go to the lower index, as in the reference.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from kornia_tpu_torch import resolve_device, to_device

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


def match_descriptors(a_bits, b_bits, a_mask=None, b_mask=None,
                      max_distance: float = 64.0,
                      ratio: Optional[float] = 0.75,
                      cross_check: bool = True, device="cuda") -> Matches:
    """Lowe-ratio + cross-check matcher on ``device``."""
    dev = resolve_device(device)
    a_bits = to_device(a_bits, dev)
    b_bits = to_device(b_bits, dev)
    a_mask = None if a_mask is None else to_device(a_mask, dev, torch.bool)
    b_mask = None if b_mask is None else to_device(b_mask, dev, torch.bool)
    d = hamming_distance_matrix(a_bits, b_bits, a_mask, b_mask)   # (N, M)
    n = d.shape[0]
    rows = torch.arange(n, device=dev)
    # the two smallest per row (top_k of −d): the first minimum, then the
    # smallest of the rest
    best_idx = torch.argmin(d, dim=1)
    best = d[rows, best_idx]
    rest = d.scatter(1, best_idx[:, None], torch.iinfo(torch.int32).max)
    second = rest.amin(dim=1)
    ok = best <= max_distance
    if ratio is not None:
        ok = ok & (best.to(torch.float32) <= ratio * second.to(torch.float32))
    if cross_check:
        b_best = torch.argmin(d, dim=0)
        ok = ok & (b_best[best_idx] == rows)
    return Matches(
        idx=torch.where(ok, best_idx, -1).to(torch.int32),
        dist=best.to(torch.float32),
        mask=ok,
    )


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
