"""COLMAP text model reader (cameras.txt / images.txt / points3D.txt);
port of kornia_tpu/io/colmap.py, host numpy as there.

Capability parity with the reference's kornia-3d/src/io/colmap/text.rs
(read_cameras_txt / read_images_txt / read_points3d_txt) and types.rs.
Kept text-format-compatible so COLMAP reconstructions remain a common
evaluation currency with the reference (SURVEY.md §5.4).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np


class ColmapError(Exception):
    """Raised on malformed COLMAP text models."""


@dataclass
class ColmapCamera:
    """One row of cameras.txt: CAMERA_ID MODEL WIDTH HEIGHT PARAMS[]."""

    camera_id: int
    model: str
    width: int
    height: int
    params: np.ndarray  # model-dependent, e.g. PINHOLE: fx fy cx cy

    def k_matrix(self) -> np.ndarray:
        """3×3 intrinsics for the pinhole-family models."""
        p = self.params
        if self.model in ("PINHOLE", "OPENCV", "OPENCV_FISHEYE", "FULL_OPENCV"):
            fx, fy, cx, cy = p[0], p[1], p[2], p[3]
        elif self.model in ("SIMPLE_PINHOLE", "SIMPLE_RADIAL", "RADIAL"):
            fx, fy, cx, cy = p[0], p[0], p[1], p[2]
        else:
            raise ColmapError(f"no K for camera model {self.model}")
        return np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], np.float64)


@dataclass
class ColmapImage:
    """One image of images.txt: pose (world→cam), name, 2D points."""

    image_id: int
    qvec: np.ndarray      # (4,) w x y z, world→camera rotation
    tvec: np.ndarray      # (3,) world→camera translation
    camera_id: int
    name: str
    xys: np.ndarray       # (N, 2) keypoint pixels
    point3d_ids: np.ndarray  # (N,) int64, -1 = no track

    def rotation_matrix(self) -> np.ndarray:
        w, x, y, z = self.qvec / np.linalg.norm(self.qvec)
        return np.array([
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ], np.float64)

    def camera_center(self) -> np.ndarray:
        return -self.rotation_matrix().T @ self.tvec


@dataclass
class ColmapPoint3d:
    """One row of points3D.txt."""

    point3d_id: int
    xyz: np.ndarray       # (3,)
    rgb: np.ndarray       # (3,) u8
    error: float
    track: List[Tuple[int, int]]  # (image_id, point2d_idx)


def _data_lines(path: str):
    if not os.path.exists(path):
        raise ColmapError(f"missing COLMAP file: {path}")
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if line and not line.startswith("#"):
                yield line


def read_cameras_txt(path: str) -> Dict[int, ColmapCamera]:
    """Parse cameras.txt (reference: text.rs read_cameras_txt)."""
    cameras = {}
    for line in _data_lines(path):
        tokens = line.split()
        if len(tokens) < 5:
            raise ColmapError(f"bad cameras.txt line: {line!r}")
        cam = ColmapCamera(
            camera_id=int(tokens[0]),
            model=tokens[1],
            width=int(tokens[2]),
            height=int(tokens[3]),
            params=np.asarray([float(t) for t in tokens[4:]], np.float64),
        )
        cameras[cam.camera_id] = cam
    return cameras


def read_images_txt(path: str) -> Dict[int, ColmapImage]:
    """Parse images.txt: alternating pose line / 2D-point line."""
    images = {}
    lines = list(_data_lines(path))
    if len(lines) % 2:
        raise ColmapError("images.txt must have an even number of data lines")
    for pose_line, pts_line in zip(lines[0::2], lines[1::2]):
        tokens = pose_line.split()
        if len(tokens) < 10:
            raise ColmapError(f"bad images.txt pose line: {pose_line!r}")
        pts = pts_line.split()
        if len(pts) % 3:
            raise ColmapError("images.txt 2D-point line not a multiple of 3")
        xys = np.asarray(
            [[float(pts[i]), float(pts[i + 1])] for i in range(0, len(pts), 3)],
            np.float64).reshape(-1, 2)
        ids = np.asarray([int(pts[i + 2]) for i in range(0, len(pts), 3)],
                         np.int64)
        img = ColmapImage(
            image_id=int(tokens[0]),
            qvec=np.asarray([float(t) for t in tokens[1:5]], np.float64),
            tvec=np.asarray([float(t) for t in tokens[5:8]], np.float64),
            camera_id=int(tokens[8]),
            name=" ".join(tokens[9:]),
            xys=xys,
            point3d_ids=ids,
        )
        images[img.image_id] = img
    return images


def read_points3d_txt(path: str) -> Dict[int, ColmapPoint3d]:
    """Parse points3D.txt (reference: text.rs read_points3d_txt)."""
    points = {}
    for line in _data_lines(path):
        tokens = line.split()
        if len(tokens) < 8 or (len(tokens) - 8) % 2:
            raise ColmapError(f"bad points3D.txt line: {line!r}")
        track = [(int(tokens[i]), int(tokens[i + 1]))
                 for i in range(8, len(tokens), 2)]
        pt = ColmapPoint3d(
            point3d_id=int(tokens[0]),
            xyz=np.asarray([float(t) for t in tokens[1:4]], np.float64),
            rgb=np.asarray([int(t) for t in tokens[4:7]], np.uint8),
            error=float(tokens[7]),
            track=track,
        )
        points[pt.point3d_id] = pt
    return points


def read_colmap_model(model_dir: str):
    """Read a full COLMAP text model directory.

    Returns (cameras, images, points3d) dicts keyed by their ids.
    """
    return (
        read_cameras_txt(os.path.join(model_dir, "cameras.txt")),
        read_images_txt(os.path.join(model_dir, "images.txt")),
        read_points3d_txt(os.path.join(model_dir, "points3D.txt")),
    )
