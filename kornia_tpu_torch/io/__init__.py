"""I/O subsystem: image codecs, depth codecs, pointcloud and SfM-model
formats, dataset readers, video and capture (port of kornia_tpu/io/).

Host code, as in the reference (kornia-io keeps its codecs on the CPU):
every reader returns numpy arrays and every writer takes them. A caller
moves a decoded frame to the card itself, or hands it to an entry point
with ``device=``, e.g. ``models.preprocess_image(read_image_any_rgb8(p),
512)``. PIL (image codecs, MJPEG), OpenCV (video, cameras) and pyarrow are
imported by the functions that use them, so importing this package needs
none of them. The depth codec and the capture layer run on the port's
native C++ (``kornia_tpu_torch/native/``).
"""

from kornia_tpu_torch.io.image_io import (
    read_image_any_rgb8,
    read_image_any_gray8,
    read_image_jpeg_rgb8,
    read_image_jpeg_gray8,
    read_image_png_rgb8,
    read_image_png_rgba8,
    read_image_png_gray8,
    read_image_png_gray16,
    read_image_tiff,
    read_image_webp_rgb8,
    write_image_jpeg,
    write_image_png,
    write_image_tiff,
    write_image_webp,
    read_exif_orientation,
)
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
from kornia_tpu_torch.io.datasets import (
    TumRgbdDataset,
    EurocDataset,
    KittiOdometryDataset,
)
from kornia_tpu_torch.io.fps_counter import FpsCounter
from kornia_tpu_torch.io.video import (
    CameraCapture,
    NativeCapture,
    VideoError,
    VideoReader,
    VideoWriter,
)
from kornia_tpu_torch.io.mjpeg_avi import MjpegReader, MjpegWriter

__all__ = [
    "read_image_any_rgb8",
    "read_image_any_gray8",
    "read_image_jpeg_rgb8",
    "read_image_jpeg_gray8",
    "read_image_png_rgb8",
    "read_image_png_rgba8",
    "read_image_png_gray8",
    "read_image_png_gray16",
    "read_image_tiff",
    "read_image_webp_rgb8",
    "write_image_jpeg",
    "write_image_png",
    "write_image_tiff",
    "write_image_webp",
    "read_exif_orientation",
    "rvl_compress",
    "rvl_decompress",
    "read_ply",
    "write_ply",
    "read_pcd",
    "write_pcd",
    "ColmapCamera",
    "CameraCapture",
    "NativeCapture",
    "VideoError",
    "VideoReader",
    "VideoWriter",
    "MjpegReader",
    "MjpegWriter",
    "ColmapImage",
    "ColmapPoint3d",
    "read_cameras_txt",
    "read_images_txt",
    "read_points3d_txt",
    "read_colmap_model",
    "TumRgbdDataset",
    "EurocDataset",
    "KittiOdometryDataset",
    "FpsCounter",
]
