"""Geometric vision: Lie groups, cameras, epipolar geometry, PnP, RANSAC,
triangulation, ICP (port of kornia_tpu/geometry/)."""

from kornia_tpu_torch.geometry import liegroup
from kornia_tpu_torch.geometry import linalg
from kornia_tpu_torch.geometry import camera
from kornia_tpu_torch.geometry import epipolar
from kornia_tpu_torch.geometry import triangulation
from kornia_tpu_torch.geometry import ransac
from kornia_tpu_torch.geometry import pnp
from kornia_tpu_torch.geometry import twoview
from kornia_tpu_torch.geometry import icp
from kornia_tpu_torch.geometry import stereo

__all__ = [
    "stereo",
    "liegroup",
    "linalg",
    "camera",
    "epipolar",
    "triangulation",
    "ransac",
    "pnp",
    "twoview",
    "icp",
]
