"""Map checkpointing for preemption recovery (port of
kornia_tpu/slam/checkpoint.py).

The whole SlamMap serialises to one compressed npz (ragged lists become
index-delimited flat arrays), written atomically (a temporary file in the
target's directory, then ``os.replace``). The layout and
``_FORMAT_VERSION`` are the reference's, so a map written by either
package loads in the other. Device state (BA problems) is rebuilt from the
map on resume.
"""

from __future__ import annotations

import os
import tempfile

import numpy as np

from kornia_tpu_torch.slam.map import Keyframe, SlamMap

_FORMAT_VERSION = 1


def save_map(path: str, slam_map: SlamMap) -> None:
    """Atomically write the map state to ``path`` (.npz)."""
    kfs = slam_map.keyframes
    kf_meta = np.asarray(
        [[kf.kf_id, kf.frame_idx, len(kf.xy)] for kf in kfs], np.int64
    ).reshape(-1, 3)
    obs_flat = []
    obs_offsets = [0]
    for obs in slam_map.point_obs:
        obs_flat.extend(obs)
        obs_offsets.append(len(obs_flat))
    edges = slam_map.edges
    payload = {
        "version": np.int64(_FORMAT_VERSION),
        "kf_meta": kf_meta,
        "kf_poses": (np.stack([kf.pose for kf in kfs])
                     if kfs else np.empty((0, 7))),
        "kf_xy": (np.concatenate([kf.xy for kf in kfs])
                  if kfs else np.empty((0, 2))),
        "kf_desc": (np.concatenate([kf.descriptors for kf in kfs])
                    if kfs else np.empty((0, 32), np.uint8)),
        "kf_point_ids": (np.concatenate([kf.point_ids for kf in kfs])
                         if kfs else np.empty(0, np.int64)),
        "point_xyz": slam_map.point_xyz,
        "point_desc": slam_map.point_desc,
        "point_valid": slam_map.point_valid,
        "obs_flat": np.asarray(obs_flat, np.int64).reshape(-1, 2),
        "obs_offsets": np.asarray(obs_offsets, np.int64),
        "edge_ij": np.asarray([[e[0], e[1]] for e in edges],
                              np.int64).reshape(-1, 2),
        "edge_rel": (np.stack([e[2] for e in edges])
                     if edges else np.empty((0, 7))),
        "edge_w": np.asarray([e[3] for e in edges], np.float64),
    }
    d = os.path.dirname(os.path.abspath(path)) or "."
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp.npz")
    os.close(fd)
    try:
        np.savez_compressed(tmp, **payload)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def load_map(path: str) -> SlamMap:
    """Rebuild a SlamMap from a checkpoint."""
    z = np.load(path, allow_pickle=False)
    if int(z["version"]) != _FORMAT_VERSION:
        raise ValueError(f"unsupported checkpoint version {z['version']}")
    m = SlamMap()
    off = 0
    for kf_id, frame_idx, n in z["kf_meta"]:
        m.keyframes.append(Keyframe(
            kf_id=int(kf_id), frame_idx=int(frame_idx),
            pose=z["kf_poses"][len(m.keyframes)].copy(),
            xy=z["kf_xy"][off: off + n].copy(),
            descriptors=z["kf_desc"][off: off + n].copy(),
            point_ids=z["kf_point_ids"][off: off + n].copy(),
        ))
        off += n
    m.point_xyz = z["point_xyz"].copy()
    m.point_desc = z["point_desc"].copy()
    m.point_valid = z["point_valid"].copy()
    offs = z["obs_offsets"]
    flat = z["obs_flat"]
    m.point_obs = [
        [(int(a), int(b)) for a, b in flat[offs[i]: offs[i + 1]]]
        for i in range(len(offs) - 1)
    ]
    for (i, j), rel, w in zip(z["edge_ij"], z["edge_rel"], z["edge_w"]):
        m.edges.append((int(i), int(j), rel.copy(), float(w)))
    return m
