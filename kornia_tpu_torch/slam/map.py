"""SLAM map state: keyframes, map points, covisibility, pose-graph edges
(port of kornia_tpu/slam/map.py).

Host bookkeeping in numpy, as in the reference: float64 poses and points,
u8 packed descriptors, the observation lists and the edge list. The loop
reads the parts a stage needs into tensors on its device; keeping the map
itself in numpy keeps the checkpoint format and the order of every list
(and with it BA's bucketing and summation order) the reference's.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np


@dataclass
class Keyframe:
    kf_id: int
    frame_idx: int
    pose: np.ndarray                  # (7,) se3 world→camera
    xy: np.ndarray                    # (F, 2) keypoint pixels
    descriptors: np.ndarray           # (F, 32) packed u8
    point_ids: np.ndarray             # (F,) int64 map-point id or -1


@dataclass
class SlamMap:
    """Growing map: keyframes + 3D points with descriptors."""

    keyframes: List[Keyframe] = field(default_factory=list)
    point_xyz: np.ndarray = field(
        default_factory=lambda: np.empty((0, 3), np.float64))
    point_desc: np.ndarray = field(
        default_factory=lambda: np.empty((0, 32), np.uint8))
    point_valid: np.ndarray = field(
        default_factory=lambda: np.empty(0, bool))
    # observations: (kf_id, feature_idx) per point
    point_obs: List[List[Tuple[int, int]]] = field(default_factory=list)
    # pose-graph edges: (kf_i, kf_j, rel_pose7, weight)
    edges: List[Tuple[int, int, np.ndarray, float]] = field(
        default_factory=list)

    @property
    def n_points(self) -> int:
        return len(self.point_xyz)

    def add_points(self, xyz: np.ndarray, desc: np.ndarray,
                   obs: List[List[Tuple[int, int]]]) -> np.ndarray:
        """Append points; returns their new ids."""
        n0 = self.n_points
        n = len(xyz)
        self.point_xyz = np.concatenate(
            [self.point_xyz, np.asarray(xyz, np.float64)])
        self.point_desc = np.concatenate(
            [self.point_desc, np.asarray(desc, np.uint8)])
        self.point_valid = np.concatenate(
            [self.point_valid, np.ones(n, bool)])
        self.point_obs.extend([list(o) for o in obs])
        return np.arange(n0, n0 + n, dtype=np.int64)

    def add_observation(self, point_id: int, kf_id: int,
                        feat_idx: int) -> None:
        self.point_obs[point_id].append((kf_id, feat_idx))
        self.keyframes[kf_id].point_ids[feat_idx] = point_id

    def add_keyframe(self, frame_idx: int, pose: np.ndarray,
                     xy: np.ndarray, descriptors: np.ndarray,
                     point_ids: Optional[np.ndarray] = None) -> Keyframe:
        kf = Keyframe(
            kf_id=len(self.keyframes),
            frame_idx=frame_idx,
            pose=np.asarray(pose, np.float64).copy(),
            xy=np.asarray(xy, np.float64),
            descriptors=np.asarray(descriptors, np.uint8),
            point_ids=(np.full(len(xy), -1, np.int64)
                       if point_ids is None else
                       np.asarray(point_ids, np.int64).copy()),
        )
        self.keyframes.append(kf)
        return kf

    def add_edge(self, kf_i: int, kf_j: int, rel_pose7: np.ndarray,
                 weight: float = 1.0) -> None:
        """Pose-graph edge: pose_j ≈ rel ∘ pose_i."""
        self.edges.append((kf_i, kf_j,
                           np.asarray(rel_pose7, np.float64), weight))

    def local_point_ids(self, n_recent_kf: int = 5) -> np.ndarray:
        """Ids of valid points observed by the most recent keyframes,
        ascending."""
        ids: set = set()
        for kf in self.keyframes[-n_recent_kf:]:
            ids.update(int(p) for p in kf.point_ids if p >= 0)
        out = np.asarray(sorted(ids), np.int64)
        if len(out) == 0:
            return out
        return out[self.point_valid[out]]

    def observations_for_ba(
        self, kf_ids: List[int], min_obs: int = 2
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """(obs_cam_local, obs_ptid, obs_uv, used_point_ids) for a BA
        window over ``kf_ids`` (camera indices local to ``kf_ids``): the
        valid points seen at least ``min_obs`` times in the window, by
        ascending id, each point's observations in the order they were
        made."""
        kf_set = {k: i for i, k in enumerate(kf_ids)}
        cams, pts, uvs = [], [], []
        pt_count: Dict[int, int] = {}
        for pid in range(self.n_points):
            if not self.point_valid[pid]:
                continue
            for kf_id, fi in self.point_obs[pid]:
                if kf_id in kf_set:
                    pt_count[pid] = pt_count.get(pid, 0) + 1
        used = sorted(p for p, c in pt_count.items() if c >= min_obs)
        pid_local = {p: i for i, p in enumerate(used)}
        for pid in used:
            for kf_id, fi in self.point_obs[pid]:
                if kf_id in kf_set:
                    cams.append(kf_set[kf_id])
                    pts.append(pid_local[pid])
                    uvs.append(self.keyframes[kf_id].xy[fi])
        return (np.asarray(cams, np.int32), np.asarray(pts, np.int32),
                np.asarray(uvs, np.float64).reshape(-1, 2),
                np.asarray(used, np.int64))
