"""The seed-made scene the cells render their frames from.

Frozen copy of chip_smoke.py at commit adb6c1a (``_texture``,
``_bilinear``, ``_PLANES``, ``_rot_xyz``, ``_view``, ``scene_textures``,
``render_view``, ``_quat_np``, ``K_EUROC`` and the path of
``slam_sequence``), generalised to any image size and intrinsics: a
'roof' of two textured planes z = 5 ∓ X, ray-cast with numpy. Later edits
of chip_smoke.py do not move it. Imports numpy only.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np

# EuRoC MAV cam0 (Burri et al., IJRR 2016), as chip_smoke.K_EUROC
K_EUROC = np.array([[458.654, 0.0, 367.215], [0.0, 457.296, 248.375],
                    [0.0, 0.0, 1.0]])

_PLANES = [(np.array([1.0, 0.0, 1.0]), 5.0),    # X > 0 side
           (np.array([-1.0, 0.0, 1.0]), 5.0)]   # X < 0 side


def _texture(rng, n: int = 320, up: int = 8) -> np.ndarray:
    """Seeded noise upsampled ×``up`` bilinearly, float64 in [0, 255]."""
    small = rng.random((n + 1, n + 1)) * 255.0
    f = (np.arange(n * up) + 0.5) / up - 0.5
    i0 = np.clip(np.floor(f).astype(int), 0, n - 1)
    a = np.clip(f - i0, 0.0, 1.0)
    rows = small[i0] * (1 - a)[:, None] + small[i0 + 1] * a[:, None]
    return rows[:, i0] * (1 - a)[None] + rows[:, i0 + 1] * a[None]


def _bilinear(tex: np.ndarray, u: np.ndarray, v: np.ndarray) -> np.ndarray:
    n = tex.shape[0]
    u = np.clip(u, 0, n - 1.001)
    v = np.clip(v, 0, n - 1.001)
    u0, v0 = np.floor(u).astype(int), np.floor(v).astype(int)
    du, dv = u - u0, v - v0
    return (tex[v0, u0] * (1 - du) * (1 - dv) + tex[v0, u0 + 1] * du * (1 - dv)
            + tex[v0 + 1, u0] * (1 - du) * dv
            + tex[v0 + 1, u0 + 1] * du * dv)


def _rot_xyz(deg) -> np.ndarray:
    """Rz·Ry·Rx of the three angles in degrees."""
    ang = np.deg2rad(deg)
    cx, cy, cz = np.cos(ang)
    sx, sy, sz = np.sin(ang)
    rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    return rz @ ry @ rx


def _quat_np(rot) -> np.ndarray:
    """wxyz quaternion of a rotation matrix with trace > −1."""
    w = np.sqrt(max(1.0 + np.trace(rot), 1e-12)) / 2.0
    return np.array([w, (rot[2, 1] - rot[1, 2]) / (4 * w),
                     (rot[0, 2] - rot[2, 0]) / (4 * w),
                     (rot[1, 0] - rot[0, 1]) / (4 * w)])


def _view(pix, rot, origin, texs):
    """Ray-cast the two textured planes: ``pix`` (H, W, 3) camera rays,
    camera = rot·(X − origin)."""
    d = pix @ rot          # world ray directions, rows: Rᵀ·dir
    h, w = pix.shape[:2]
    best = np.full((h, w), np.inf)
    img = np.zeros((h, w))
    for (n, off), tex in zip(_PLANES, texs):
        s = (off - origin @ n) / (d @ n)
        s = np.where(s > 0, s, np.inf)
        p = origin + s[..., None] * d
        val = _bilinear(tex, (p[..., 0] + 6.0) * 200.0,
                        (p[..., 1] + 6.0) * 200.0)
        take = s < best
        img = np.where(take, val, img)
        best = np.minimum(best, s)
    return np.clip(np.round(img), 0, 255).astype(np.uint8)


def scene_textures(seed: int):
    rng = np.random.default_rng(seed)
    return [_texture(rng), _texture(rng)]


def camera_rays(hw, k) -> np.ndarray:
    """(H, W, 3) rays K⁻¹·(u, v, 1) of every pixel."""
    h, w = hw
    vv, uu = np.mgrid[0:h, 0:w].astype(np.float64)
    return np.stack([uu, vv, np.ones_like(uu)], -1) @ np.linalg.inv(k).T


def render_view(rot, origin, texs, hw=(480, 752), k=K_EUROC,
                rays=None) -> np.ndarray:
    """One (H, W) u8 view of the scene, camera rot·(X − origin)."""
    return _view(camera_rays(hw, k) if rays is None else rays, rot, origin,
                 texs)


def path_poses(n: int, step: float, y_share: float, yaw_per_frame: float,
               out_and_back: bool):
    """(rotation, centre) of each of ``n`` frames, camera = R·(X − centre):
    the centre moves ``step`` along x and ``step·y_share`` along y a frame,
    for n/2 frames and back again if ``out_and_back`` (frames i and n−1−i
    share a centre, the path of chip_smoke.slam_sequence), else outward
    all the way; the camera turns ``yaw_per_frame`` rad about y every
    frame."""
    out = []
    for i in range(n):
        s = i if (not out_and_back or i < n // 2) else n - 1 - i
        rot = _rot_xyz([0.0, np.degrees(yaw_per_frame * i), 0.0])
        out.append((rot, np.array([step * s, step * y_share * s, 0.0])))
    return out


def render_path(seed: int, poses, hw, k, noise_sigma: float):
    """The frames of ``poses`` as host (H, W) u8 arrays, with Gaussian
    pixel noise of ``noise_sigma`` grey levels (textures from ``seed``,
    noise from ``seed + 1``, as chip_smoke.slam_sequence); returns
    (frames, world→camera poses (n, 7) wxyz + t, centres (n, 3))."""
    rng = np.random.default_rng(seed + 1)
    texs = scene_textures(seed)
    rays = camera_rays(hw, k)
    # the views in threads (numpy lets go of the interpreter lock in its
    # array loops); the noise in frame order from one generator
    with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1)) as ex:
        views = list(ex.map(lambda p: render_view(p[0], p[1], texs,
                                                  rays=rays), poses))
    frames, gt, centres = [], [], []
    for (rot, origin), view in zip(poses, views):
        img = view.astype(np.float64)
        frames.append(np.clip(np.round(img + rng.normal(0, noise_sigma,
                                                        img.shape)),
                              0, 255).astype(np.uint8))
        gt.append(np.concatenate([_quat_np(rot), -rot @ origin]))
        centres.append(origin)
    return frames, np.stack(gt), np.stack(centres)
