"""I/O: the depth codec, pointcloud and SfM-model formats and the frame
meter (port of kornia_tpu/io/, the part that needs no image codec).

Host code, as in the reference: the formats read and write numpy arrays.
The image codecs, the MJPEG AVI container, the dataset readers and video
capture (PIL, OpenCV and ``native/capture.cpp`` in the reference) are not
ported yet, so importing this package needs neither PIL nor cv2.
"""

from kornia_tpu_torch.io.rvl import rvl_compress, rvl_decompress
from kornia_tpu_torch.io.ply import read_ply, write_ply
from kornia_tpu_torch.io.pcd import read_pcd, write_pcd
from kornia_tpu_torch.io.colmap import (
    ColmapCamera,
    ColmapImage,
    ColmapPoint3d,
    read_cameras_txt,
    read_images_txt,
    read_points3d_txt,
    read_colmap_model,
)
from kornia_tpu_torch.io.fps_counter import FpsCounter

__all__ = [
    "rvl_compress",
    "rvl_decompress",
    "read_ply",
    "write_ply",
    "read_pcd",
    "write_pcd",
    "ColmapCamera",
    "ColmapImage",
    "ColmapPoint3d",
    "read_cameras_txt",
    "read_images_txt",
    "read_points3d_txt",
    "read_colmap_model",
    "FpsCounter",
]
