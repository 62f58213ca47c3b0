"""g++ build at first use and the ctypes loader for the host C++ sources.

The sources beside this file are byte-for-byte copies of the JAX
package's (``ccl.cpp``, ``apriltag_mid.cpp``, ``rvl.cpp``, ``image_io.cpp``
and ``capture.cpp``, which calls ``image_io.cpp``'s PNM reader). They compile
into one shared library under ``kornia_tpu_torch/_build/``, named by the
hash of the sources and the flags, as ``ops/cuda_kernels.py`` names its
``nvcc`` outputs. The build writes a temporary file and renames it into
place under a file lock, so processes that start together build once.

A failed build raises with the compiler's output: there is no numpy
fallback behind a missing library. The numpy routes stay as functions a
caller or a test picks by name.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import threading

_DIR = os.path.dirname(os.path.abspath(__file__))
SOURCES = ("ccl.cpp", "apriltag_mid.cpp", "rvl.cpp", "image_io.cpp",
           "capture.cpp")
FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
CXX = "g++"
BUILD_DIR = os.path.join(os.path.dirname(_DIR), "_build")

_lock = threading.Lock()
_lib: "ctypes.CDLL | None" = None


def lib_path() -> str:
    """Where the library of the current sources and flags lives."""
    digest = hashlib.sha256(" ".join(FLAGS).encode())
    for name in SOURCES:
        with open(os.path.join(_DIR, name), "rb") as f:
            digest.update(f.read())
    return os.path.join(BUILD_DIR,
                        f"libkornia_native_{digest.hexdigest()[:16]}.so")


def _build(out: str) -> None:
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [CXX, *FLAGS, "-o", tmp,
           *(os.path.join(_DIR, s) for s in SOURCES)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"native build: cannot run {CXX!r}: {e}") from e
    if proc.returncode != 0:
        raise RuntimeError(f"native build failed (rc {proc.returncode}): "
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)


def load_native_library() -> ctypes.CDLL:
    """Build the library if it is missing, load it once per process and
    return it. Raises RuntimeError if the build fails."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is not None:
            return _lib
        out = lib_path()
        if not os.path.exists(out):
            os.makedirs(os.path.dirname(out), exist_ok=True)
            with open(out + ".lock", "w") as lock:
                fcntl.flock(lock, fcntl.LOCK_EX)
                try:
                    if not os.path.exists(out):
                        _build(out)
                finally:
                    fcntl.flock(lock, fcntl.LOCK_UN)
        _lib = ctypes.CDLL(out)
        return _lib


def native_available() -> bool:
    """Whether the library builds and loads here. A caller that needs it
    calls :func:`load_native_library`, which raises with the compiler's
    output instead."""
    try:
        load_native_library()
    except (RuntimeError, OSError):
        return False
    return True
