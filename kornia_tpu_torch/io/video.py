"""Video + camera capture (port of kornia_tpu/io/video.py; reference:
kornia-io gstreamer/{video,capture,rtsp}.rs and v4l/).

Host code, frames are numpy HWC u8 RGB. ``VideoReader``, ``VideoWriter``
and ``CameraCapture`` use OpenCV where the reference does; cv2 is imported
when one of them is made, not with this module. Without cv2 the reader and
writer take the built-in MJPEG/AVI container (:mod:`.mjpeg_avi`), as the
reference's do: that is the API's contract for a machine without OpenCV.
``NativeCapture`` runs on the port's native library (``native/capture.cpp``:
V4L2, or a directory of PNM frames); a library that does not build raises.
"""

from __future__ import annotations

from typing import Iterator, Optional, Tuple

import numpy as np


class VideoError(Exception):
    """Raised when a stream cannot be opened/read/written."""


def _cv2_or_none():
    """The cv2 module, or None where OpenCV is not installed."""
    try:
        import cv2
    except ImportError:
        return None
    return cv2


def _require_cv2():
    cv2 = _cv2_or_none()
    if cv2 is None:
        raise VideoError("video support requires OpenCV (cv2)")
    return cv2


class VideoReader:
    """Frame iterator over a video file (reference VideoReader,
    gstreamer/video.rs:230)."""

    def __init__(self, path: str):
        cv2 = self._cv2 = _cv2_or_none()
        if cv2 is None:
            # without OpenCV: the built-in MJPEG/AVI demuxer
            from kornia_tpu_torch.io.mjpeg_avi import MjpegReader, is_mjpeg_avi

            if not is_mjpeg_avi(path):
                raise VideoError(
                    f"cannot open video without cv2 (only MJPEG/AVI is "
                    f"supported natively): {path}")
            self._mjpeg = MjpegReader(path)
            self._cap = None
            return
        self._mjpeg = None
        self._cap = cv2.VideoCapture(path)
        if not self._cap.isOpened():
            raise VideoError(f"cannot open video: {path}")

    @property
    def fps(self) -> float:
        if self._mjpeg is not None:
            return self._mjpeg.fps
        return float(self._cap.get(self._cv2.CAP_PROP_FPS))

    @property
    def size(self) -> Tuple[int, int]:
        """(h, w)"""
        if self._mjpeg is not None:
            return self._mjpeg.size
        cv2 = self._cv2
        return (int(self._cap.get(cv2.CAP_PROP_FRAME_HEIGHT)),
                int(self._cap.get(cv2.CAP_PROP_FRAME_WIDTH)))

    @property
    def n_frames(self) -> int:
        if self._mjpeg is not None:
            return self._mjpeg.n_frames
        return int(self._cap.get(self._cv2.CAP_PROP_FRAME_COUNT))

    def read(self) -> Optional[np.ndarray]:
        """Next frame as (H, W, 3) u8 RGB, or None at EOS."""
        if self._mjpeg is not None:
            return self._mjpeg.read()
        ok, frame = self._cap.read()
        if not ok:
            return None
        return self._cv2.cvtColor(frame, self._cv2.COLOR_BGR2RGB)

    def __iter__(self) -> Iterator[np.ndarray]:
        while True:
            f = self.read()
            if f is None:
                return
            yield f

    def seek_frame(self, idx: int) -> None:
        if self._mjpeg is not None:
            self._mjpeg.seek_frame(idx)
            return
        self._cap.set(self._cv2.CAP_PROP_POS_FRAMES, idx)

    def release(self) -> None:
        if self._mjpeg is not None:
            self._mjpeg.release()
            return
        self._cap.release()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.release()


class VideoWriter:
    """RGB frame sink (reference VideoWriter, gstreamer/video.rs:25)."""

    def __init__(self, path: str, fps: float, size_hw: Tuple[int, int],
                 codec: str = "mp4v"):
        h, w = size_hw
        cv2 = self._cv2 = _cv2_or_none()
        if codec.lower() == "mjpg" or cv2 is None:
            # the built-in MJPEG/AVI muxer (cv2/ffmpeg-readable)
            from kornia_tpu_torch.io.mjpeg_avi import MjpegWriter

            self._mjpeg = MjpegWriter(path, fps, (h, w))
            self._writer = None
            self._size = (h, w)
            return
        self._mjpeg = None
        self._writer = cv2.VideoWriter(
            path, cv2.VideoWriter_fourcc(*codec), fps, (w, h))
        if not self._writer.isOpened():
            raise VideoError(f"cannot open writer: {path}")
        self._size = (h, w)

    def write(self, frame_rgb: np.ndarray) -> None:
        if frame_rgb.shape[:2] != self._size:
            raise VideoError(
                f"frame size {frame_rgb.shape[:2]} != {self._size}")
        if self._mjpeg is not None:
            self._mjpeg.write(frame_rgb)
            return
        cv2 = self._cv2
        self._writer.write(cv2.cvtColor(frame_rgb, cv2.COLOR_RGB2BGR))

    def release(self) -> None:
        if self._mjpeg is not None:
            self._mjpeg.release()
            return
        self._writer.release()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.release()


class CameraCapture:
    """Live camera (reference V4lVideoCapture, v4l/mod.rs:184 /
    StreamCapture, gstreamer/capture.rs:137)."""

    def __init__(self, index: int = 0, size_hw: Optional[Tuple[int, int]] = None,
                 fps: Optional[float] = None):
        cv2 = self._cv2 = _require_cv2()
        self._cap = cv2.VideoCapture(index)
        if not self._cap.isOpened():
            raise VideoError(f"cannot open camera {index}")
        if size_hw is not None:
            self._cap.set(cv2.CAP_PROP_FRAME_HEIGHT, size_hw[0])
            self._cap.set(cv2.CAP_PROP_FRAME_WIDTH, size_hw[1])
        if fps is not None:
            self._cap.set(cv2.CAP_PROP_FPS, fps)

    def grab_frame(self) -> np.ndarray:
        """(H, W, 3) u8 RGB (reference grab_frame, v4l/mod.rs:287)."""
        ok, frame = self._cap.read()
        if not ok:
            raise VideoError("camera read failed")
        return self._cv2.cvtColor(frame, self._cv2.COLOR_BGR2RGB)

    def release(self) -> None:
        self._cap.release()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.release()


class NativeCapture:
    """Native (C++) capture on the port's library: real V4L2 mmap
    streaming or a directory-backed virtual camera, no OpenCV involved.

    Reference: V4lVideoCapture (v4l/mod.rs:184) — mmap ring, pixel
    format negotiation (YUYV → RGB24 → GREY), BT.601 YUYV→RGB.
    ``uri`` is ``"v4l2:/dev/video0"`` (or a bare /dev path) for
    hardware, ``"dir:/path"`` (or a bare directory) to loop the
    .ppm/.pgm frames in a directory through the identical grab API —
    the testable stand-in for a camera in headless environments.

    >>> with NativeCapture("dir:frames/") as cap:
    ...     rgb = cap.grab_frame()        # (H, W, 3) u8 RGB
    """

    def __init__(self, uri: str, size_hw: Optional[Tuple[int, int]] = None):
        import ctypes

        from kornia_tpu_torch.native import load_native_library

        try:
            lib = load_native_library()
        except RuntimeError as e:
            raise VideoError(f"native capture library unavailable: {e}") \
                from e
        lib.kornia_capture_open.restype = ctypes.c_void_p
        lib.kornia_capture_open.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64]
        lib.kornia_capture_grab.restype = ctypes.c_int64
        lib.kornia_capture_grab.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_int64, ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64)]
        lib.kornia_capture_close.restype = None
        lib.kornia_capture_close.argtypes = [ctypes.c_void_p]
        lib.kornia_capture_error.restype = ctypes.c_char_p
        self._lib = lib
        self._ct = ctypes
        h, w = size_hw if size_hw is not None else (0, 0)
        self._cap = lib.kornia_capture_open(uri.encode(), w, h)
        if not self._cap:
            raise VideoError(
                f"cannot open {uri}: "
                f"{lib.kornia_capture_error().decode()}")
        self._buf = np.empty(0, np.uint8)

    def grab_frame(self) -> np.ndarray:
        """(H, W, 3) u8 RGB (reference grab_frame, v4l/mod.rs:287)."""
        ct = self._ct
        oh = ct.c_int64()
        ow = ct.c_int64()
        for _ in range(2):
            rc = self._lib.kornia_capture_grab(
                self._cap,
                self._buf.ctypes.data_as(ct.POINTER(ct.c_uint8)),
                self._buf.size, ct.byref(oh), ct.byref(ow))
            if rc == 0:
                return (self._buf[: oh.value * ow.value * 3]
                        .reshape(oh.value, ow.value, 3).copy())
            if rc == -2:       # grow to the reported frame size
                self._buf = np.empty(oh.value * ow.value * 3, np.uint8)
                continue
            raise VideoError(
                f"grab failed: {self._lib.kornia_capture_error().decode()}")
        raise VideoError("grab failed: buffer negotiation loop")

    def release(self) -> None:
        if self._cap:
            self._lib.kornia_capture_close(self._cap)
            self._cap = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.release()
