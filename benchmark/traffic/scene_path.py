"""The one traffic generator of the frame cells: a camera path through the
seed-made scene (benchmark/scene.py), rendered on the host as u8 frames,
as a camera hands them over.

A workload file gives the path: ``frames``, ``step`` (m a frame along x),
``y_share`` (the y step as a share of it), ``yaw_per_frame`` (rad about
y), ``out_and_back`` (true: out for half the frames and back over the
same centres; false: outward all the way) and ``noise_sigma`` (grey
levels of Gaussian pixel noise); the configuration gives the camera
(``camera``: height, width, fx, fy, cx, cy). The seed draws the textures
and the noise; every seed gets the same path.
"""

from __future__ import annotations

import numpy as np

from benchmark import scene


def camera_k(cam: dict) -> np.ndarray:
    return np.array([[cam["fx"], 0.0, cam["cx"]], [0.0, cam["fy"], cam["cy"]],
                     [0.0, 0.0, 1.0]])


def generate(seed: int, config: dict, traffic: dict) -> dict:
    cam = config["camera"]
    poses = scene.path_poses(traffic["frames"], traffic["step"],
                             traffic["y_share"], traffic["yaw_per_frame"],
                             traffic["out_and_back"])
    frames, gt, centres = scene.render_path(
        seed, poses, (cam["height"], cam["width"]), camera_k(cam),
        traffic["noise_sigma"])
    return {"frames": frames, "gt_poses": gt, "centres": centres,
            "k": camera_k(cam)}
