"""Host-side image codecs (JPEG / PNG / TIFF / WebP) with EXIF handling
(port of kornia_tpu/io/image_io.py).

Decoding stays on the host, as in the reference: the card sees decoded
arrays only, moved there by the caller (``torch.as_tensor(img,
device=...)`` or an entry point's ``device=``). PIL is the codec; it is
imported inside the functions that use it, so importing this module needs
no PIL. Everything returns contiguous numpy arrays in HWC. The same PIL
encodes and decodes for both packages, so a file written by one reads
back identically through the other.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np


class IoError(Exception):
    """Raised for unreadable files / unsupported formats / bad shapes."""


def _open(path: str):
    from PIL import Image as PILImage

    if not os.path.exists(path):
        raise IoError(f"file does not exist: {path}")
    try:
        return PILImage.open(path)
    except Exception as e:  # noqa: BLE001 - map codec errors to IoError
        raise IoError(f"cannot decode {path}: {e}") from e


def _check_suffix(path: str, suffixes: tuple, kind: str) -> None:
    if not path.lower().endswith(suffixes):
        raise IoError(f"invalid {kind} file extension: {path}")


def read_exif_orientation(path: str) -> int:
    """Return the EXIF orientation tag (1..8; 1 if absent).

    Reference: kornia-io metadata.rs:10-16.
    """
    with _open(path) as im:
        exif = im.getexif()
        return int(exif.get(0x0112, 1))


def _decoded(im, mode: str, apply_exif: bool) -> np.ndarray:
    if apply_exif:
        from PIL import ImageOps

        im = ImageOps.exif_transpose(im)
    if im.mode != mode:
        im = im.convert(mode)
    arr = np.asarray(im)
    if arr.ndim == 2:
        arr = arr[:, :, None]
    return np.ascontiguousarray(arr)


def read_image_any_rgb8(path: str, apply_exif: bool = True) -> np.ndarray:
    """Decode any supported format to (H, W, 3) u8 RGB.

    Reference: read_image_any_rgb8, kornia-io/src/functional.rs:42.
    EXIF auto-orientation is applied by default (metadata.rs).
    """
    with _open(path) as im:
        return _decoded(im, "RGB", apply_exif)


def read_image_any_gray8(path: str, apply_exif: bool = True) -> np.ndarray:
    """Decode any supported format to (H, W, 1) u8 grayscale."""
    with _open(path) as im:
        return _decoded(im, "L", apply_exif)


def read_image_jpeg_rgb8(path: str) -> np.ndarray:
    """Decode a JPEG to (H, W, 3) u8 RGB (kornia-io jpeg.rs)."""
    _check_suffix(path, (".jpg", ".jpeg"), "jpeg")
    with _open(path) as im:
        return _decoded(im, "RGB", apply_exif=False)


def read_image_jpeg_gray8(path: str) -> np.ndarray:
    """Decode a JPEG to (H, W, 1) u8 grayscale."""
    _check_suffix(path, (".jpg", ".jpeg"), "jpeg")
    with _open(path) as im:
        return _decoded(im, "L", apply_exif=False)


def read_image_png_rgb8(path: str) -> np.ndarray:
    """Decode a PNG to (H, W, 3) u8 RGB (kornia-io png.rs)."""
    _check_suffix(path, (".png",), "png")
    with _open(path) as im:
        return _decoded(im, "RGB", apply_exif=False)


def read_image_png_rgba8(path: str) -> np.ndarray:
    """Decode a PNG to (H, W, 4) u8 RGBA."""
    _check_suffix(path, (".png",), "png")
    with _open(path) as im:
        return _decoded(im, "RGBA", apply_exif=False)


def read_image_png_gray8(path: str) -> np.ndarray:
    """Decode a PNG to (H, W, 1) u8 grayscale."""
    _check_suffix(path, (".png",), "png")
    with _open(path) as im:
        return _decoded(im, "L", apply_exif=False)


def read_image_png_gray16(path: str) -> np.ndarray:
    """Decode a 16-bit PNG to (H, W, 1) u16 (depth maps; TUM/kinect style).

    Reference: kornia-io png.rs u16 path.
    """
    _check_suffix(path, (".png",), "png")
    with _open(path) as im:
        if im.mode not in ("I", "I;16", "I;16B", "I;16L"):
            im = im.convert("I")
        arr = np.asarray(im)
        if arr.dtype != np.uint16:
            arr = np.clip(arr, 0, 65535).astype(np.uint16)
        return np.ascontiguousarray(arr[:, :, None])


def read_image_tiff(path: str) -> np.ndarray:
    """Decode a TIFF preserving dtype (u8/u16/f32), (H, W, C).

    Reference: kornia-io tiff.rs (u8/u16/f32 support).
    """
    _check_suffix(path, (".tif", ".tiff"), "tiff")
    with _open(path) as im:
        arr = np.asarray(im)
        if arr.ndim == 2:
            arr = arr[:, :, None]
        return np.ascontiguousarray(arr)


def read_image_webp_rgb8(path: str) -> np.ndarray:
    """Decode a WebP to (H, W, 3) u8 RGB."""
    _check_suffix(path, (".webp",), "webp")
    with _open(path) as im:
        return _decoded(im, "RGB", apply_exif=False)


def _to_pil(img: np.ndarray):
    from PIL import Image as PILImage

    img = np.asarray(img)
    if img.ndim == 3 and img.shape[2] == 1:
        img = img[:, :, 0]
    if img.ndim == 2 and img.dtype == np.uint16:
        im = PILImage.new("I;16", (img.shape[1], img.shape[0]))
        im.frombytes(np.ascontiguousarray(img).tobytes())
        return im
    return PILImage.fromarray(img)


def write_image_jpeg(path: str, img: np.ndarray, quality: int = 95) -> None:
    """Encode (H, W, {1,3}) u8 to JPEG (kornia-io jpeg.rs write path)."""
    _check_suffix(path, (".jpg", ".jpeg"), "jpeg")
    if img.dtype != np.uint8:
        raise IoError(f"jpeg expects u8, got {img.dtype}")
    _to_pil(img).save(path, quality=quality)


def write_image_png(path: str, img: np.ndarray) -> None:
    """Encode u8/u16 (H, W, {1,3,4}) to PNG."""
    _check_suffix(path, (".png",), "png")
    if img.dtype not in (np.uint8, np.uint16):
        raise IoError(f"png expects u8/u16, got {img.dtype}")
    _to_pil(img).save(path)


def write_image_tiff(path: str, img: np.ndarray) -> None:
    """Encode u8/u16/f32 to TIFF."""
    _check_suffix(path, (".tif", ".tiff"), "tiff")
    _to_pil(img).save(path)


def write_image_webp(path: str, img: np.ndarray, quality: int = 90,
                     lossless: bool = False) -> None:
    """Encode (H, W, {3,4}) u8 to WebP."""
    _check_suffix(path, (".webp",), "webp")
    _to_pil(img).save(path, quality=quality, lossless=lossless)
