"""The port's host C++ (port of kornia_tpu/native/): union-find CCL, the
AprilTag mid-pipeline and the RVL codec, loaded with ctypes. The sources
are copies of the reference's; :mod:`.build` compiles them with g++ at
first use into ``kornia_tpu_torch/_build/`` and raises if it cannot."""

from kornia_tpu_torch.native.build import load_native_library

__all__ = ["load_native_library"]
