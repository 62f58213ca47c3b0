"""Image type and metadata (port of kornia_tpu/image.py).

An :class:`Image` is a pixel tensor plus static metadata: its colour space
and the layout of its channel axis. Images are plain tensors everywhere
else in the package; this wrapper carries the tags and the conversions of
the reference's ``Image``. The reference registers ``Image`` as a jax
pytree so that it can cross ``jax.jit`` with its metadata in the trace
signature; PyTorch has no such tracing boundary, so there is no
counterpart of that registration here.

``to_torch``/``from_torch`` are the identity (the data is a torch tensor
already); they keep the reference's names so that user code ports
unchanged. DLPack goes both ways, zero-copy, on the producer's device.
Arrow goes both ways in the reference's wire schema (``to_arrow`` /
``from_arrow``; pyarrow is imported inside them), so an image exported by
either package imports into the other.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any, Tuple

import numpy as np
import torch

from kornia_tpu_torch import resolve_device


class ColorSpace(enum.Enum):
    """Static colour-space tag."""

    UNKNOWN = "unknown"
    GRAY = "gray"
    RGB = "rgb"
    BGR = "bgr"
    RGBA = "rgba"
    BGRA = "bgra"
    HSV = "hsv"
    HLS = "hls"
    LAB = "lab"
    LUV = "luv"
    XYZ = "xyz"
    YUV = "yuv"
    # packed / planar video formats (host-side containers; converted to RGB
    # on the device by kornia_tpu_torch.ops.yuv)
    YUYV = "yuyv"
    UYVY = "uyvy"
    NV12 = "nv12"
    NV21 = "nv21"
    I420 = "i420"
    YV12 = "yv12"


class PixelFormat(enum.Enum):
    U8 = "u8"
    U16 = "u16"
    F32 = "f32"
    F64 = "f64"


class ImageLayout(enum.Enum):
    """Memory layout of the channel axis."""

    HWC = "hwc"
    CHW = "chw"


class InterpolationMode(enum.Enum):
    NEAREST = "nearest"
    BILINEAR = "bilinear"
    BICUBIC = "bicubic"
    LANCZOS = "lanczos"
    AREA = "area"


@dataclasses.dataclass(frozen=True)
class ImageSize:
    """(width, height) pair."""

    width: int
    height: int

    def __iter__(self):
        return iter((self.width, self.height))

    @property
    def wh(self) -> Tuple[int, int]:
        return (self.width, self.height)

    @property
    def hw(self) -> Tuple[int, int]:
        return (self.height, self.width)


_PIXEL_FORMATS = {torch.uint8: PixelFormat.U8, torch.uint16: PixelFormat.U16,
                  torch.float32: PixelFormat.F32,
                  torch.float64: PixelFormat.F64}


def _dtype_to_pixel_format(dtype: torch.dtype) -> PixelFormat:
    if dtype not in _PIXEL_FORMATS:
        raise ValueError(f"unsupported image dtype: {dtype}")
    return _PIXEL_FORMATS[dtype]


@dataclasses.dataclass(frozen=True)
class Image:
    """A pixel tensor plus static metadata.

    ``data`` is (H, W, C) for HWC layout or (C, H, W) for CHW; leading
    batch dimensions are allowed ((..., H, W, C))."""

    data: torch.Tensor
    color_space: ColorSpace = ColorSpace.UNKNOWN
    layout: ImageLayout = ImageLayout.HWC

    # -- construction ----------------------------------------------------
    @classmethod
    def from_numpy(cls, array: np.ndarray,
                   color_space: ColorSpace = ColorSpace.RGB,
                   layout: ImageLayout = ImageLayout.HWC,
                   device="cuda") -> "Image":
        """A copy of ``array`` on ``device``."""
        dev = resolve_device(device)
        return cls(torch.as_tensor(np.asarray(array)).to(dev), color_space,
                   layout)

    @classmethod
    def from_size_val(cls, size: ImageSize, val, channels: int = 3,
                      dtype: torch.dtype = torch.uint8,
                      color_space: ColorSpace = ColorSpace.RGB,
                      device="cuda") -> "Image":
        """An HWC image of ``size`` filled with ``val``."""
        dev = resolve_device(device)
        data = torch.full((size.height, size.width, channels), val,
                          dtype=dtype, device=dev)
        return cls(data, color_space, ImageLayout.HWC)

    # -- accessors -------------------------------------------------------
    @property
    def shape(self):
        return tuple(self.data.shape)

    @property
    def dtype(self) -> torch.dtype:
        return self.data.dtype

    @property
    def pixel_format(self) -> PixelFormat:
        return _dtype_to_pixel_format(self.data.dtype)

    @property
    def height(self) -> int:
        return (self.data.shape[-3] if self.layout is ImageLayout.HWC
                else self.data.shape[-2])

    @property
    def width(self) -> int:
        return (self.data.shape[-2] if self.layout is ImageLayout.HWC
                else self.data.shape[-1])

    @property
    def channels(self) -> int:
        return (self.data.shape[-1] if self.layout is ImageLayout.HWC
                else self.data.shape[-3])

    @property
    def size(self) -> ImageSize:
        return ImageSize(self.width, self.height)

    # -- conversions -----------------------------------------------------
    def cast(self, dtype: torch.dtype) -> "Image":
        return dataclasses.replace(self, data=self.data.to(dtype))

    def cast_and_scale(self, dtype: torch.dtype, scale: float) -> "Image":
        """Cast, then multiply by ``scale`` in ``dtype`` (u8 → f32 style)."""
        s = torch.tensor(scale, dtype=dtype)
        return dataclasses.replace(self, data=self.data.to(dtype) * s)

    def scale_and_cast(self, dtype: torch.dtype, scale: float) -> "Image":
        """Multiply by ``scale`` in float32, then cast; to an integer type
        it rounds half to even and clamps to the type's range (f32 → u8
        style)."""
        scaled = self.data.to(torch.float32) * scale
        if dtype in (torch.uint8, torch.uint16):
            info = torch.iinfo(dtype)
            scaled = torch.clamp(torch.round(scaled), info.min, info.max)
        return dataclasses.replace(self, data=scaled.to(dtype))

    def to_chw(self) -> "Image":
        if self.layout is ImageLayout.CHW:
            return self
        return Image(torch.movedim(self.data, -1, -3), self.color_space,
                     ImageLayout.CHW)

    def to_hwc(self) -> "Image":
        if self.layout is ImageLayout.HWC:
            return self
        return Image(torch.movedim(self.data, -3, -1), self.color_space,
                     ImageLayout.HWC)

    def channel(self, i: int) -> torch.Tensor:
        """One channel as (..., H, W)."""
        if self.layout is ImageLayout.HWC:
            return self.data[..., i]
        return self.data[..., i, :, :]

    def split_channels(self):
        axis = -1 if self.layout is ImageLayout.HWC else -3
        return list(torch.unbind(self.data, dim=axis))

    def map(self, fn) -> "Image":
        return dataclasses.replace(self, data=fn(self.data))

    def numpy(self) -> np.ndarray:
        return self.data.detach().cpu().numpy()

    # -- DLPack ----------------------------------------------------------
    def __dlpack__(self, stream: Any = None):
        return self.data.__dlpack__(stream=stream)

    def __dlpack_device__(self):
        return self.data.__dlpack_device__()

    @classmethod
    def from_dlpack(cls, ext_tensor, color_space=None) -> "Image":
        """Zero-copy import of any ``__dlpack__`` producer (numpy, torch,
        jax, cupy, ...), on the producer's device."""
        return cls(data=torch.from_dlpack(ext_tensor),
                   color_space=color_space or ColorSpace.UNKNOWN)

    def to_torch(self) -> torch.Tensor:
        """The data tensor itself (the identity: kept for the reference's
        name)."""
        return self.data

    @classmethod
    def from_torch(cls, tensor: torch.Tensor, color_space=None) -> "Image":
        """Wrap ``tensor`` as it is (the identity: kept for the reference's
        name)."""
        return cls(data=tensor, color_space=color_space or ColorSpace.UNKNOWN)

    # -- Arrow (reference kornia-image/src/arrow.rs IntoArrow/TryFromArrow:
    # a StructArray {width, height, channels: u32[1], data: binary[1]}) --
    def to_arrow(self):
        """Export as an Arrow StructArray (arrow.rs:40 ``into_arrow``).
        (H, W, C) u8 in HWC only, as in the reference; the pixels are
        copied to the host once and wrapped without a second copy."""
        import pyarrow as pa

        if self.layout is not ImageLayout.HWC:
            raise ValueError("to_arrow requires HWC layout")
        host = np.ascontiguousarray(self.numpy())
        if host.dtype != np.uint8 or host.ndim != 3:
            raise ValueError(
                "to_arrow supports (H, W, C) u8 images (reference "
                "arrow.rs implements Image<u8, C> only)")
        h, w, c = host.shape
        offsets = np.asarray([0, host.size], np.int32)
        data_arr = pa.Array.from_buffers(
            pa.binary(), 1,
            [None, pa.py_buffer(offsets), pa.py_buffer(host)])
        return pa.StructArray.from_arrays(
            [pa.array([w], pa.uint32()), pa.array([h], pa.uint32()),
             pa.array([c], pa.uint32()), data_arr],
            names=["width", "height", "channels", "data"])

    @classmethod
    def from_arrow(cls, array, color_space=None, device="cuda") -> "Image":
        """Import the reference's Arrow image encoding (arrow.rs:67
        ``try_from_arrow``) onto ``device``."""
        import pyarrow as pa

        if isinstance(array, pa.ChunkedArray):
            array = array.combine_chunks()
        if not pa.types.is_struct(array.type):
            raise ValueError("expected a StructArray image encoding")
        w = array.field("width")[0].as_py()
        h = array.field("height")[0].as_py()
        c = array.field("channels")[0].as_py()
        buf = np.frombuffer(array.field("data")[0].as_py(), np.uint8)
        if buf.size != h * w * c:
            raise ValueError(f"data length {buf.size} != {h}x{w}x{c}")
        return cls.from_numpy(buf.reshape(h, w, c).copy(),
                              color_space=color_space or ColorSpace.UNKNOWN,
                              device=device)


def as_array(img) -> torch.Tensor:
    """An Image's data tensor, a tensor as it is, or anything else as a
    tensor (``torch.as_tensor``, on the CPU)."""
    if isinstance(img, Image):
        return img.data
    return torch.as_tensor(img)
