"""RVL depth-map codec (Wilson, CVPR'17), RVL1 wire format (port of
kornia_tpu/io/rvl.py).

Zero-run + zigzag-delta nibble-VLQ compression of u16 depth images, an
``RVL1`` header with the image size, and an untrusted-header allocation
bound of 8192×8192. The codec is the port's native C++
(``native/rvl.cpp``) through ctypes; a failed build raises. The
pure-Python codec (``_compress_py``/``_decompress_py``) stays beside it
as a second route that the tests compare with.
"""

from __future__ import annotations

import ctypes
import struct

import numpy as np

from kornia_tpu_torch.native import load_native_library

_MAGIC = b"RVL1"
_MAX_DIM = 8192  # untrusted-header allocation bound (reference rvl.rs:26-31)


class RvlError(Exception):
    """Raised on malformed RVL streams or invalid inputs."""


# ---------------------------------------------------------------- pure-python
def _compress_py(flat: np.ndarray) -> bytes:
    nibbles = []

    def put_vlq(value: int) -> None:
        while value >= 8:
            nibbles.append((value & 7) | 8)
            value >>= 3
        nibbles.append(value)

    n = flat.size
    i = 0
    prev = 0
    # Find run boundaries vectorised: indices where zero-ness changes.
    nonzero = flat != 0
    while i < n:
        j = i
        while j < n and not nonzero[j]:
            j += 1
        put_vlq(j - i)
        i = j
        while j < n and nonzero[j]:
            j += 1
        put_vlq(j - i)
        for k in range(i, j):
            cur = int(flat[k])
            d = cur - prev
            put_vlq((d << 1) ^ (d >> 31) if d >= 0 else ((-d) << 1) - 1)
            prev = cur
        i = j
    if len(nibbles) % 2:
        nibbles.append(0)
    arr = np.asarray(nibbles, np.uint8)
    return ((arr[0::2] << 4) | arr[1::2]).tobytes()


def _decompress_py(payload: bytes, n: int) -> np.ndarray:
    data = np.frombuffer(payload, np.uint8)
    nibbles = np.empty(data.size * 2, np.uint8)
    nibbles[0::2] = data >> 4
    nibbles[1::2] = data & 0xF
    out = np.zeros(n, np.uint16)
    pos = 0
    total = nibbles.size

    def get_vlq() -> int:
        nonlocal pos
        value = 0
        shift = 0
        while True:
            if pos >= total:
                raise RvlError("truncated RVL stream")
            nib = int(nibbles[pos])
            pos += 1
            value |= (nib & 7) << shift
            if not nib & 8:
                return value
            shift += 3
            if shift > 30:
                raise RvlError("malformed RVL VLQ")

    i = 0
    prev = 0
    while i < n:
        zeros = get_vlq()
        if i + zeros > n:
            raise RvlError("RVL zero-run exceeds image size")
        i += zeros
        nonzeros = get_vlq()
        if i + nonzeros > n:
            raise RvlError("RVL value-run exceeds image size")
        for _ in range(nonzeros):
            z = get_vlq()
            prev += (z >> 1) ^ -(z & 1)
            out[i] = prev & 0xFFFF
            i += 1
    return out


# -------------------------------------------------------------------- native
def _native_fns():
    lib = load_native_library()
    comp = lib.kornia_rvl_compress
    comp.restype = ctypes.c_int64
    comp.argtypes = [
        ctypes.POINTER(ctypes.c_uint16), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
    ]
    decomp = lib.kornia_rvl_decompress
    decomp.restype = ctypes.c_int64
    decomp.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_uint16), ctypes.c_int64,
    ]
    return comp, decomp


# ----------------------------------------------------------------- public API
def rvl_compress(depth: np.ndarray) -> bytes:
    """Compress a (H, W) or (H, W, 1) u16 depth image to RVL1 bytes."""
    depth = np.asarray(depth)
    if depth.ndim == 3 and depth.shape[2] == 1:
        depth = depth[:, :, 0]
    if depth.ndim != 2 or depth.dtype != np.uint16:
        raise RvlError(f"expected (H, W) u16, got {depth.shape} {depth.dtype}")
    h, w = depth.shape
    if h > _MAX_DIM or w > _MAX_DIM:
        raise RvlError(f"image too large: {h}x{w} (max {_MAX_DIM})")
    header = _MAGIC + struct.pack("<II", w, h)
    flat = np.ascontiguousarray(depth).reshape(-1)

    comp, _ = _native_fns()
    # the worst case: every pixel nonzero with 6-nibble deltas, plus runs
    cap = 4 * flat.size + 16
    out = np.empty(cap, np.uint8)
    nbytes = comp(
        flat.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)), flat.size,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), cap,
    )
    if nbytes < 0:
        raise RvlError(f"RVL output over {cap} bytes")
    return header + out[:nbytes].tobytes()


def rvl_decompress(data: bytes) -> np.ndarray:
    """Decompress RVL1 bytes to a (H, W) u16 depth image."""
    if len(data) < 12 or data[:4] != _MAGIC:
        raise RvlError("not an RVL1 stream")
    w, h = struct.unpack("<II", data[4:12])
    if w == 0 or h == 0 or w > _MAX_DIM or h > _MAX_DIM:
        raise RvlError(f"bad RVL1 header size {w}x{h}")
    payload = data[12:]
    n = h * w

    _, decomp = _native_fns()
    out = np.empty(n, np.uint16)
    buf = np.frombuffer(payload, np.uint8)
    rc = decomp(
        buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), buf.size,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)), n,
    )
    if rc != 0:
        raise RvlError(f"corrupt RVL stream (rc={rc})")
    return out.reshape(h, w)
