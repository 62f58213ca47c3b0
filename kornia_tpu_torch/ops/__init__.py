"""Dense image ops and the CUDA kernels of the port (port of
kornia_tpu/ops/).

The modules are imported in kornia_tpu/ops/__init__.py's order;
``cuda_kernels`` stands where the reference imports ``pallas_kernels``.
Importing them builds no kernel and not the native library.
"""

from kornia_tpu_torch.ops import color
from kornia_tpu_torch.ops import resize
from kornia_tpu_torch.ops import warp
from kornia_tpu_torch.ops import filters
from kornia_tpu_torch.ops import interpolation
from kornia_tpu_torch.ops import enhance
from kornia_tpu_torch.ops import normalize
from kornia_tpu_torch.ops import threshold
from kornia_tpu_torch.ops import morphology
from kornia_tpu_torch.ops import pyramid
from kornia_tpu_torch.ops import geometry_utils
from kornia_tpu_torch.ops import yuv
from kornia_tpu_torch.ops import metrics
from kornia_tpu_torch.ops import preprocess
from kornia_tpu_torch.ops import histogram
from kornia_tpu_torch.ops import canny
from kornia_tpu_torch.ops import draw
from kornia_tpu_torch.ops import bayer
from kornia_tpu_torch.ops import connected_components
from kornia_tpu_torch.ops import contours
from kornia_tpu_torch.ops import distance_transform
from kornia_tpu_torch.ops import optical_flow
from kornia_tpu_torch.ops import depth
from kornia_tpu_torch.ops import segmentation
from kornia_tpu_torch.ops import cuda_kernels

__all__ = [
    "depth",
    "segmentation",
    "cuda_kernels",
    "bayer",
    "connected_components",
    "contours",
    "distance_transform",
    "optical_flow",
    "color",
    "resize",
    "warp",
    "filters",
    "interpolation",
    "enhance",
    "normalize",
    "threshold",
    "morphology",
    "pyramid",
    "geometry_utils",
    "yuv",
    "metrics",
    "preprocess",
    "histogram",
    "canny",
    "draw",
]
