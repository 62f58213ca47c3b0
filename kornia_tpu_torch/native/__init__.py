"""The port's host C++ (port of kornia_tpu/native/): union-find CCL, the
AprilTag mid-pipeline, the RVL codec, binary PNM images and video capture
(V4L2 or a directory of frames), loaded with ctypes. The sources are
copies of the reference's; :mod:`.build` compiles them with g++ at first
use into ``kornia_tpu_torch/_build/`` and raises if it cannot.

``include/`` holds the C API (``kornia_tpu_native.h``) and the
header-only C++ wrapper (``kornia_tpu.hpp``) for C++ consumers of that
library; ``CMakeLists.txt`` builds and installs it as the CMake package
``kornia_tpu_torch`` (target ``kornia_tpu_torch::native``), and
``tests/test_native.cpp`` is the C++ consumer the tests compile."""

from kornia_tpu_torch.native.build import (load_native_library,
                                           native_available)

__all__ = ["load_native_library", "native_available"]
