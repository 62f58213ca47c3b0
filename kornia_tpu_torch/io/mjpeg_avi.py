"""Self-contained MJPEG/AVI video muxer + demuxer (port of
kornia_tpu/io/mjpeg_avi.py, byte for byte the same container).

Reference capability: kornia-io's ``VideoWriter``/``VideoReader``
(gstreamer/video.rs:25,230). Motion-JPEG in a RIFF/AVI container, written
and parsed directly, the JPEG codec through PIL (imported inside the
codec functions). For the same frames and quality the writer gives the
same bytes as the JAX package's; cv2/ffmpeg read its files and it reads
theirs (tests/test_torch_io_codecs.py).

Layout written (the classic AVI 1.0 shape, one 'vids' stream):

    RIFF 'AVI '
      LIST 'hdrl'
        'avih'  MainAVIHeader   (56 bytes)
        LIST 'strl'
          'strh' AVIStreamHeader (56 bytes, fcc 'vids'/'MJPG')
          'strf' BITMAPINFOHEADER(40 bytes, biCompression 'MJPG')
      LIST 'movi'
        '00dc' <jpeg>  (chunks padded to even length)
        ...
      'idx1'  16-byte entries, offsets relative to the 'movi' fourcc

Sizes aren't known until close, so the writer back-patches the RIFF
size, frame counts, and buffer sizes on ``release()``.
"""

from __future__ import annotations

import io as _io
import struct
from typing import Iterator, List, Optional, Tuple

import numpy as np

AVIF_HASINDEX = 0x00000010
AVIIF_KEYFRAME = 0x00000010


def _jpeg_encode(frame: np.ndarray, quality: int) -> bytes:
    from PIL import Image as PILImage

    mode = "L" if frame.ndim == 2 else "RGB"
    buf = _io.BytesIO()
    PILImage.fromarray(frame, mode=mode).save(
        buf, format="JPEG", quality=quality)
    return buf.getvalue()


def _jpeg_decode(data: bytes, gray: bool) -> np.ndarray:
    from PIL import Image as PILImage

    img = PILImage.open(_io.BytesIO(data))
    return np.asarray(img.convert("L" if gray else "RGB"))


class MjpegWriter:
    """Streaming MJPEG/AVI writer.

    ``size_hw`` fixes the frame shape; ``pixel_format`` is ``"rgb8"``
    or ``"mono8"`` (the reference's ImageFormat, video.rs:17).
    """

    def __init__(self, path: str, fps: float, size_hw: Tuple[int, int],
                 pixel_format: str = "rgb8", quality: int = 92):
        if pixel_format not in ("rgb8", "mono8"):
            raise ValueError("pixel_format must be rgb8 or mono8")
        if fps <= 0:
            raise ValueError("fps must be positive")
        self._size = (int(size_hw[0]), int(size_hw[1]))
        self._fps = float(fps)
        self._gray = pixel_format == "mono8"
        self._quality = int(quality)
        self._frames = 0
        self._max_chunk = 0
        self._index: List[Tuple[int, int]] = []  # (offset, size)
        self._f = open(path, "wb")
        self._write_headers()

    # ------------------------------------------------------------ plumbing
    def _write_headers(self) -> None:
        h, w = self._size
        f = self._f
        f.write(b"RIFF")
        self._riff_size_pos = f.tell()
        f.write(struct.pack("<I", 0))
        f.write(b"AVI ")

        # LIST hdrl
        f.write(b"LIST")
        hdrl_size_pos = f.tell()
        f.write(struct.pack("<I", 0))
        hdrl_start = f.tell()
        f.write(b"hdrl")

        f.write(b"avih" + struct.pack("<I", 56))
        self._avih_pos = f.tell()
        self._micro = int(round(1e6 / self._fps))
        f.write(struct.pack(
            "<14I",
            self._micro,                  # dwMicroSecPerFrame
            0,                            # dwMaxBytesPerSec (patched)
            0,                            # dwPaddingGranularity
            AVIF_HASINDEX,                # dwFlags
            0,                            # dwTotalFrames (patched)
            0,                            # dwInitialFrames
            1,                            # dwStreams
            0,                            # dwSuggestedBufferSize (patched)
            w, h, 0, 0, 0, 0))

        f.write(b"LIST")
        strl_size_pos = f.tell()
        f.write(struct.pack("<I", 0))
        strl_start = f.tell()
        f.write(b"strl")

        # dwScale/dwRate encode fps as a rational; 1000-denominator
        # covers the common non-integer rates (29.97 etc.).
        scale, rate = 1000, int(round(self._fps * 1000))
        f.write(b"strh" + struct.pack("<I", 56))
        self._strh_pos = f.tell()
        f.write(b"vids" + b"MJPG")
        f.write(struct.pack(
            "<IHHIIIIIIiI4h",
            0, 0, 0,            # dwFlags, wPriority, wLanguage
            0,                  # dwInitialFrames
            scale, rate,        # dwScale, dwRate
            0,                  # dwStart
            0,                  # dwLength (frames; patched)
            0,                  # dwSuggestedBufferSize (patched)
            -1,                 # dwQuality (default)
            0,                  # dwSampleSize
            0, 0, int(w), int(h)))    # rcFrame

        f.write(b"strf" + struct.pack("<I", 40))
        f.write(struct.pack(
            "<IiiHH4sIiiII",
            40, w, h, 1, 24, b"MJPG", w * h * 3, 0, 0, 0, 0))

        end = f.tell()
        f.seek(strl_size_pos)
        f.write(struct.pack("<I", end - strl_start))
        f.seek(hdrl_size_pos)
        f.write(struct.pack("<I", end - hdrl_start))
        f.seek(end)

        # LIST movi
        f.write(b"LIST")
        self._movi_size_pos = f.tell()
        f.write(struct.pack("<I", 0))
        self._movi_start = f.tell()   # position of the 'movi' fourcc
        f.write(b"movi")

    # -------------------------------------------------------------- public
    def write(self, frame: np.ndarray) -> None:
        """Append one (H, W, 3) RGB u8 or (H, W) gray u8 frame."""
        frame = np.asarray(frame)
        expect = self._size if self._gray else (*self._size, 3)
        if frame.shape != expect:
            raise ValueError(
                f"frame shape {frame.shape} != expected {expect}")
        if self._f is None:
            raise ValueError("writer is closed (release() was called)")
        data = _jpeg_encode(frame.astype(np.uint8), self._quality)
        f = self._f
        off = f.tell() - self._movi_start
        f.write(b"00dc" + struct.pack("<I", len(data)))
        f.write(data)
        if len(data) % 2:
            f.write(b"\x00")
        self._index.append((off, len(data)))
        self._frames += 1
        self._max_chunk = max(self._max_chunk, len(data))

    def release(self) -> None:
        if self._f is None:
            return
        f = self._f
        movi_end = f.tell()
        # idx1
        f.write(b"idx1" + struct.pack("<I", 16 * len(self._index)))
        for off, size in self._index:
            f.write(b"00dc" + struct.pack("<III", AVIIF_KEYFRAME, off,
                                          size))
        riff_end = f.tell()

        f.seek(self._movi_size_pos)
        f.write(struct.pack("<I", movi_end - self._movi_start))
        f.seek(self._riff_size_pos)
        f.write(struct.pack("<I", riff_end - self._riff_size_pos - 4))
        bps = int(self._max_chunk * self._fps)
        f.seek(self._avih_pos)
        f.write(struct.pack("<4I", self._micro, bps, 0, AVIF_HASINDEX))
        f.write(struct.pack("<I", self._frames))
        f.seek(self._avih_pos + 7 * 4)
        f.write(struct.pack("<I", self._max_chunk))
        f.seek(self._strh_pos + 8 + 4 + 2 + 2 + 4 + 4 + 4 + 4)
        f.write(struct.pack("<II", self._frames, self._max_chunk))
        f.close()
        self._f = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.release()


class MjpegReader:
    """MJPEG/AVI demuxer; yields (H, W, 3) RGB u8 (or gray) frames.

    Parses the chunk stream directly (the idx1 index is used when
    present, else the 'movi' list is scanned), so it reads MJPG AVIs
    from any muxer — cv2/ffmpeg output included.
    """

    def __init__(self, path: str, pixel_format: str = "rgb8"):
        self._gray = pixel_format == "mono8"
        self._f = open(path, "rb")
        try:
            data = self._f.read()
            if (len(data) < 12 or data[:4] != b"RIFF"
                    or data[8:12] != b"AVI "):
                raise ValueError(f"not a RIFF/AVI file: {path}")
            self._fps = 0.0
            self._size = (0, 0)
            self._n_declared = 0
            self._offsets: List[Tuple[int, int]] = []  # (abs off, size)
            self._parse(data)
        except Exception:
            self._f.close()
            raise
        # the parse buffer is NOT retained: frames are read on demand
        # through the file handle (a long clip would otherwise pin its
        # whole compressed size in host RAM for the reader's lifetime)
        del data
        self._pos = 0

    def _parse(self, data: bytes) -> None:
        movi_start = None
        idx1 = None

        def need(start: int, n: int, what: str) -> bytes:
            if start + n > len(data):
                raise ValueError(f"corrupted AVI: truncated {what}")
            return data[start:start + n]

        def walk(start: int, end: int) -> None:
            nonlocal movi_start, idx1
            pos = start
            while pos + 8 <= end:
                ckid = data[pos:pos + 4]
                (size,) = struct.unpack("<I", data[pos + 4:pos + 8])
                body = pos + 8
                if ckid in (b"RIFF", b"LIST"):
                    fourcc = need(body, 4, "LIST fourcc")
                    if fourcc == b"movi":
                        movi_start = body
                    walk(body + 4, min(body + size, end))
                elif ckid == b"avih":
                    vals = struct.unpack("<14I", need(body, 56, "avih"))
                    if vals[0]:
                        self._fps = self._fps or 1e6 / vals[0]
                    self._n_declared = vals[4]
                    self._size = (vals[9], vals[8])
                elif ckid == b"strh":
                    fcc = need(body, 4, "strh")
                    if fcc == b"vids":
                        scale, rate = struct.unpack(
                            "<II", need(body + 20, 8, "strh rates"))
                        if scale:
                            self._fps = rate / scale
                elif ckid == b"idx1":
                    idx1 = (body, min(size, len(data) - body))
                pos = body + size + (size % 2)

        walk(0, len(data))
        if movi_start is None:
            raise ValueError("no 'movi' list found")

        def chunk_at(p: int, ckid: bytes) -> bool:
            return data[p:p + 4] == ckid

        if idx1 is not None:
            body, size = idx1
            entries = []
            for e in range(body, body + size - 15, 16):
                ckid = data[e:e + 4]
                if ckid[2:4] in (b"dc", b"db"):
                    _, off, csz = struct.unpack("<III", data[e + 4:e + 16])
                    entries.append((ckid, off, csz))
            # offsets are relative to the 'movi' fourcc in most files,
            # absolute in some. Pick ONE base from the first entry (the
            # chunk header at the target must equal the entry's own
            # ckid) and require it to hold for every entry — a lucky
            # ckid-lookalike inside a JPEG payload can't flip the base
            # mid-file.
            if entries:
                ckid0, off0, _ = entries[0]
                base = next((bb for bb in (movi_start, 0)
                             if chunk_at(bb + off0, ckid0)), None)
                if base is not None and all(
                        chunk_at(base + off, ckid)
                        for ckid, off, _ in entries):
                    self._offsets = [(base + off + 8, csz)
                                     for _, off, csz in entries]
        if not self._offsets:
            # no (usable) index: scan the movi list
            pos = movi_start + 4
            end = len(data)
            while pos + 8 <= end:
                ckid = data[pos:pos + 4]
                if ckid == b"idx1":
                    break
                (size,) = struct.unpack("<I", data[pos + 4:pos + 8])
                if ckid[2:4] in (b"dc", b"db"):
                    self._offsets.append((pos + 8, size))
                elif ckid == b"LIST":  # 'rec ' groups
                    pos += 12
                    continue
                pos += 8 + size + (size % 2)

    # -------------------------------------------------------------- public
    @property
    def fps(self) -> float:
        return self._fps

    @property
    def size(self) -> Tuple[int, int]:
        """(h, w) from the container header."""
        return self._size

    @property
    def n_frames(self) -> int:
        return len(self._offsets)

    def read(self) -> Optional[np.ndarray]:
        if self._pos >= len(self._offsets) or self._f is None:
            return None
        off, size = self._offsets[self._pos]
        self._pos += 1
        self._f.seek(off)
        return _jpeg_decode(self._f.read(size), self._gray)

    def seek_frame(self, idx: int) -> None:
        self._pos = max(0, min(int(idx), len(self._offsets)))

    def __iter__(self) -> Iterator[np.ndarray]:
        while True:
            f = self.read()
            if f is None:
                return
            yield f

    def release(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None
        self._pos = len(self._offsets)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.release()


def is_mjpeg_avi(path: str) -> bool:
    """True if ``path`` is a RIFF/AVI container (cheap header sniff)."""
    try:
        with open(path, "rb") as f:
            head = f.read(12)
    except OSError:
        return False
    return len(head) == 12 and head[:4] == b"RIFF" and head[8:12] == b"AVI "
