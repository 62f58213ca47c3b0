"""SLAM dataset readers: TUM RGB-D, EuRoC MAV, KITTI odometry (port of
kornia_tpu/io/datasets.py).

All readers are host-side and lazy: they index the on-disk layout up
front and decode frames on access, through the port's
:mod:`kornia_tpu_torch.io.image_io`.

Ground-truth poses are returned as (N, 7) float64 ``[qw qx qy qz tx ty tz]``
world←body, the se3 quaternion layout of
:mod:`kornia_tpu_torch.geometry.liegroup`.
"""

from __future__ import annotations

import csv
import os
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np


class DatasetError(Exception):
    """Raised for missing/malformed dataset layouts."""


def _read_stamped_file_list(path: str) -> Tuple[np.ndarray, List[str]]:
    """Parse TUM-style 'timestamp filename' list files."""
    if not os.path.exists(path):
        raise DatasetError(f"missing list file: {path}")
    stamps, names = [], []
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            tokens = line.split()
            stamps.append(float(tokens[0]))
            names.append(tokens[1])
    return np.asarray(stamps, np.float64), names


def associate_timestamps(
    a: np.ndarray, b: np.ndarray, max_dt: float = 0.02
) -> np.ndarray:
    """Greedy nearest-timestamp association; returns (M, 2) index pairs."""
    pairs = []
    j = 0
    for i, ta in enumerate(a):
        while j + 1 < len(b) and abs(b[j + 1] - ta) <= abs(b[j] - ta):
            j += 1
        if len(b) and abs(b[j] - ta) <= max_dt:
            pairs.append((i, j))
    return np.asarray(pairs, np.int64).reshape(-1, 2)


@dataclass
class Frame:
    """One dataset frame: timestamps + host-side decoded arrays."""

    timestamp: float
    rgb: Optional[np.ndarray] = None     # (H, W, 3) u8
    gray: Optional[np.ndarray] = None    # (H, W) u8
    depth: Optional[np.ndarray] = None   # (H, W) f32 meters


class TumRgbdDataset:
    """TUM RGB-D layout: rgb.txt / depth.txt / groundtruth.txt.

    Depth PNGs are 16-bit with a 5000 ticks/meter scale (TUM convention).
    """

    DEPTH_SCALE = 5000.0

    def __init__(self, root: str, max_dt: float = 0.02):
        from kornia_tpu_torch.io import image_io

        self._image_io = image_io
        self.root = root
        rgb_t, rgb_files = _read_stamped_file_list(
            os.path.join(root, "rgb.txt"))
        depth_path = os.path.join(root, "depth.txt")
        if os.path.exists(depth_path):
            dep_t, dep_files = _read_stamped_file_list(depth_path)
            pairs = associate_timestamps(rgb_t, dep_t, max_dt)
            self.timestamps = rgb_t[pairs[:, 0]]
            self.rgb_files = [rgb_files[i] for i in pairs[:, 0]]
            self.depth_files: Optional[List[str]] = [
                dep_files[j] for j in pairs[:, 1]]
        else:
            self.timestamps = rgb_t
            self.rgb_files = rgb_files
            self.depth_files = None
        self.groundtruth = self._read_groundtruth(
            os.path.join(root, "groundtruth.txt"))

    @staticmethod
    def _read_groundtruth(path: str):
        if not os.path.exists(path):
            return None
        rows = []
        with open(path, "r", encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                t, tx, ty, tz, qx, qy, qz, qw = map(float, line.split()[:8])
                rows.append([t, qw, qx, qy, qz, tx, ty, tz])
        arr = np.asarray(rows, np.float64)
        return {"timestamps": arr[:, 0], "poses": arr[:, 1:8]}

    def __len__(self) -> int:
        return len(self.rgb_files)

    def __getitem__(self, idx: int) -> Frame:
        rgb = self._image_io.read_image_any_rgb8(
            os.path.join(self.root, self.rgb_files[idx]))
        depth = None
        if self.depth_files is not None:
            d16 = self._image_io.read_image_png_gray16(
                os.path.join(self.root, self.depth_files[idx]))[:, :, 0]
            depth = d16.astype(np.float32) / self.DEPTH_SCALE
        return Frame(timestamp=float(self.timestamps[idx]),
                     rgb=rgb, depth=depth)


class EurocDataset:
    """EuRoC MAV ASL layout: mav0/cam0/data.csv + data/, GT csv.

    Timestamps are nanoseconds in the csv; exposed as seconds.
    """

    def __init__(self, root: str, cam: str = "cam0"):
        from kornia_tpu_torch.io import image_io

        self._image_io = image_io
        cam_dir = os.path.join(root, "mav0", cam)
        csv_path = os.path.join(cam_dir, "data.csv")
        if not os.path.exists(csv_path):
            raise DatasetError(f"missing EuRoC csv: {csv_path}")
        self.data_dir = os.path.join(cam_dir, "data")
        stamps, names = [], []
        with open(csv_path, "r", encoding="utf-8") as f:
            for row in csv.reader(f):
                if not row or row[0].startswith("#"):
                    continue
                stamps.append(int(row[0]) * 1e-9)
                names.append(row[1].strip())
        self.timestamps = np.asarray(stamps, np.float64)
        self.files = names
        self.groundtruth = self._read_groundtruth(os.path.join(
            root, "mav0", "state_groundtruth_estimate0", "data.csv"))

    @staticmethod
    def _read_groundtruth(path: str):
        if not os.path.exists(path):
            return None
        ts, poses = [], []
        with open(path, "r", encoding="utf-8") as f:
            for row in csv.reader(f):
                if not row or row[0].startswith("#"):
                    continue
                vals = [float(v) for v in row[:8]]
                ts.append(vals[0] * 1e-9)
                # csv order: t, px py pz, qw qx qy qz
                poses.append([vals[4], vals[5], vals[6], vals[7],
                              vals[1], vals[2], vals[3]])
        return {"timestamps": np.asarray(ts, np.float64),
                "poses": np.asarray(poses, np.float64)}

    def __len__(self) -> int:
        return len(self.files)

    def __getitem__(self, idx: int) -> Frame:
        gray = self._image_io.read_image_any_gray8(
            os.path.join(self.data_dir, self.files[idx]))[:, :, 0]
        return Frame(timestamp=float(self.timestamps[idx]), gray=gray)


class KittiOdometryDataset:
    """KITTI odometry layout: sequences/NN/image_0 + times.txt (+ poses)."""

    def __init__(self, root: str, sequence: str = "00", camera: int = 0):
        from kornia_tpu_torch.io import image_io

        self._image_io = image_io
        seq_dir = os.path.join(root, "sequences", sequence)
        self.image_dir = os.path.join(seq_dir, f"image_{camera}")
        if not os.path.isdir(self.image_dir):
            raise DatasetError(f"missing KITTI image dir: {self.image_dir}")
        self.files = sorted(
            f for f in os.listdir(self.image_dir) if f.endswith(".png"))
        times_path = os.path.join(seq_dir, "times.txt")
        if os.path.exists(times_path):
            self.timestamps = np.loadtxt(times_path, dtype=np.float64,
                                         ndmin=1)
        else:
            self.timestamps = np.arange(len(self.files), dtype=np.float64)
        self.poses = self._read_poses(
            os.path.join(root, "poses", f"{sequence}.txt"))
        self.calib = self._read_calib(os.path.join(seq_dir, "calib.txt"),
                                      camera)

    @staticmethod
    def _read_poses(path: str):
        """poses/NN.txt: each line a 3×4 row-major cam0←world_0 matrix."""
        if not os.path.exists(path):
            return None
        mats = np.loadtxt(path, dtype=np.float64, ndmin=2).reshape(-1, 3, 4)
        n = mats.shape[0]
        out = np.tile(np.eye(4), (n, 1, 1))
        out[:, :3, :] = mats
        return out

    @staticmethod
    def _read_calib(path: str, camera: int):
        if not os.path.exists(path):
            return None
        with open(path, "r", encoding="utf-8") as f:
            for line in f:
                if line.startswith(f"P{camera}:"):
                    p = np.asarray(
                        [float(v) for v in line.split()[1:]],
                        np.float64).reshape(3, 4)
                    return {"P": p, "K": p[:, :3].copy()}
        return None

    def __len__(self) -> int:
        return len(self.files)

    def __getitem__(self, idx: int) -> Frame:
        gray = self._image_io.read_image_any_gray8(
            os.path.join(self.image_dir, self.files[idx]))[:, :, 0]
        return Frame(timestamp=float(self.timestamps[idx]), gray=gray)
