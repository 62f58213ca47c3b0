"""Monocular SLAM: the per-frame tracking step (port of
kornia_tpu/slam/system.py, in part).

Ported: the configuration and result types, the descriptor packing and
shape bucketing helpers, and :func:`track_step`, the counterpart of the
reference's ``_track_step_jit``: packed Hamming match of the frame against
the local map → the matched map points → PnP RANSAC (EPnP, MSAC, LO
refits) → reprojection LM. Every stage takes and gives tensors on one
device and none waits on it, so a frame's step is queued in one go and
the host reads back only what it needs. ``MonocularSlam`` (bootstrap,
keyframing, the map, local BA, loop closure) is not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass
from enum import Enum
from typing import NamedTuple, Optional

import numpy as np
import torch

from kornia_tpu_torch import resolve_device, to_device
from kornia_tpu_torch.features import matching
from kornia_tpu_torch.geometry.pnp import PnPResult, solve_pnp_ransac


class TrackingState(Enum):
    INITIALIZING = "initializing"
    TRACKING = "tracking"
    LOST = "lost"


@dataclass
class SlamConfig:
    n_features: int = 1000
    n_levels: int = 4
    match_max_distance: int = 64
    match_ratio: float = 0.8
    min_init_matches: int = 40
    min_init_inliers: int = 25
    min_track_points: int = 12
    pnp_threshold_px: float = 3.0
    keyframe_min_tracked_ratio: float = 0.6
    keyframe_min_interval: int = 3
    ba_window: int = 5
    ba_iterations: int = 10
    global_ba_iterations: int = 12
    global_ba_on_loop: bool = True
    loop_min_score: float = 0.25
    loop_min_kf_gap: int = 10
    loop_min_matches: int = 20
    seed: int = 0


@dataclass
class FrameResult:
    frame_idx: int
    state: TrackingState
    pose: Optional[np.ndarray]          # (7,) world→camera (None if lost)
    n_tracked: int
    is_keyframe: bool
    loop_closed_with: Optional[int] = None


class TrackStepResult(NamedTuple):
    pose: PnPResult            # world → camera
    inliers: torch.Tensor      # (N,) bool: PnP inlier and matched
    n_inliers: torch.Tensor    # () int64
    match_idx: torch.Tensor    # (N,) int32 map row, -1 if unmatched
    match_mask: torch.Tensor   # (N,) bool


def _pack(desc_bits: torch.Tensor) -> torch.Tensor:
    """(N, D) bits, D a multiple of 8 → (N, D/8) u8 on the tensor's
    device, as ``np.packbits(bits, axis=1)``: MSB first, any non-zero bit
    is 1."""
    b = (desc_bits != 0).to(torch.int32)
    weights = 1 << torch.arange(7, -1, -1, dtype=torch.int32,
                                device=b.device)
    return (b.reshape(b.shape[0], -1, 8) * weights).sum(-1).to(torch.uint8)


def _bucket(n: int, step: int) -> int:
    """Round n up to the bucket grid (powers-of-two multiples of step), so
    the step sees few distinct shapes."""
    b = step
    while b < n:
        b *= 2
    return b


def _pad_rows(arr: torch.Tensor, n_to: int, fill=0.0) -> torch.Tensor:
    """The first ``n_to`` rows of ``arr``, padded with ``fill``."""
    if arr.shape[0] >= n_to:
        return arr[:n_to]
    pad = torch.full((n_to - arr.shape[0],) + tuple(arr.shape[1:]), fill,
                     dtype=arr.dtype, device=arr.device)
    return torch.cat([arr, pad])


_DEFAULT = SlamConfig()


def track_step(frame_desc, frame_mask, frame_xy, map_desc, map_mask,
               map_xyz, k,
               max_distance: float = _DEFAULT.match_max_distance,
               ratio: float = _DEFAULT.match_ratio,
               threshold_px: float = _DEFAULT.pnp_threshold_px,
               generator: Optional[torch.Generator] = None,
               sample_idx=None, device="cuda") -> TrackStepResult:
    """One frame tracked against the local map on ``device``.

    frame_desc (N, 32) u8 packed descriptors, frame_mask (N,), frame_xy
    (N, 2) pixels; map_desc (M, 32), map_mask (M,), map_xyz (M, 3) world
    points; k (3, 3). Matching: Lowe ratio ``ratio``, Hamming distance
    ≤ ``max_distance``, cross-check; then ``solve_pnp_ransac`` with its
    defaults (EPnP, 256 hypotheses of 6 points, MSAC, 2 LO refits, 10 LM
    iterations) at ``threshold_px``. ``generator`` drives the draw;
    ``sample_idx`` (256, 6) replaces it."""
    dev = resolve_device(device)
    m = matching.match_descriptors_packed(
        frame_desc, map_desc, a_mask=frame_mask, b_mask=map_mask,
        max_distance=float(max_distance), ratio=float(ratio), device=dev)
    xyz = to_device(map_xyz, dev, torch.float32)
    world = xyz[torch.clamp(m.idx, min=0).to(torch.int64)]
    pose, inliers, n_inl = solve_pnp_ransac(
        world, frame_xy, k, threshold_px=float(threshold_px), mask=m.mask,
        generator=generator, sample_idx=sample_idx, device=dev)
    return TrackStepResult(pose=pose, inliers=inliers & m.mask,
                           n_inliers=n_inl, match_idx=m.idx,
                           match_mask=m.mask)
