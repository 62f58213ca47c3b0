"""kornia_tpu_torch — the PyTorch/CUDA port of ``kornia_tpu``.

The package mirrors ``kornia_tpu`` module for module
(``kornia_tpu_torch/features/orb.py`` ↔ ``kornia_tpu/features/orb.py``)
and is held to it by the ``tests/test_torch_*.py`` parity tests. Plain
tensor code is PyTorch; every Pallas kernel of the JAX package on a
ported path is a hand-written CUDA kernel for Hopper (sm_90a) under
``ops/csrc/``, built at first use by :mod:`kornia_tpu_torch.ops.cuda_kernels`.

Entry points take ``device=`` (default ``"cuda"``) and move numpy or
tensor inputs there. Without a card they fail unless the caller asks for
``device="cpu"``, where each kernel wrapper runs its plain PyTorch
version.

This package never imports ``jax`` or ``kornia_tpu``.
"""

__version__ = "0.1.0"

import functools as _functools

import numpy as _np
import torch as _torch

# Numerics contract, the counterpart of kornia_tpu/__init__.py:34
# (float32 matmuls at full float32 precision): no TF32 anywhere.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
_torch.set_float32_matmul_precision("highest")


def resolve_device(device) -> _torch.device:
    """``device`` as a torch.device; a CUDA device without a card raises
    (the entry points never fall back to the CPU on their own)."""
    dev = _torch.device(device)
    if dev.type == "cuda" and not _torch.cuda.is_available():
        raise RuntimeError(
            "kornia_tpu_torch: CUDA device requested but "
            "torch.cuda.is_available() is False; pass device='cpu' to "
            "run the plain PyTorch versions")
    return dev


def to_device(x, device: _torch.device, dtype=None) -> _torch.Tensor:
    """numpy array / tensor / sequence → tensor on ``device``."""
    if isinstance(x, _torch.Tensor):
        return x.to(device=device, dtype=dtype or x.dtype)
    return _torch.tensor(x, dtype=dtype, device=device)


def upload(x, device: _torch.device, dtype=None) -> _torch.Tensor:
    """``x`` (numpy, a sequence or a tensor) as a tensor on ``device``.
    Host data bound for the card goes through pinned memory and a copy
    that does not block, so that the upload does not wait for the device
    (no host sync)."""
    t = x if isinstance(x, _torch.Tensor) else _torch.from_numpy(
        _np.array(x))
    if dtype is not None and t.device.type == "cpu":
        t = t.to(dtype)
    if device.type == "cuda" and t.device.type == "cpu":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device=device, dtype=dtype or t.dtype)


def _moved(x, device: _torch.device):
    if isinstance(x, (_torch.Tensor, _np.ndarray)):
        return to_device(x, device)
    return x


def entry(fn):
    """Make ``fn`` an entry point: it gains ``device=`` (default
    ``"cuda"``, through :func:`resolve_device`), and every numpy array or
    tensor among its arguments is moved there first. Other arguments
    (sizes, thresholds, colours) pass as they are."""

    @_functools.wraps(fn)
    def on_device(*args, device="cuda", **kwargs):
        dev = resolve_device(device)
        return fn(*[_moved(a, dev) for a in args],
                  **{k: _moved(v, dev) for k, v in kwargs.items()})

    return on_device


# The subpackages, in kornia_tpu/__init__.py's order (all of them are
# ported). They import ``entry`` and
# ``resolve_device`` from here, so they come after them. Nothing here
# builds a kernel or the native library: that happens at first use.
from kornia_tpu_torch import image  # noqa: E402
from kornia_tpu_torch import ops  # noqa: E402
from kornia_tpu_torch import features  # noqa: E402
from kornia_tpu_torch import geometry  # noqa: E402
from kornia_tpu_torch import optim  # noqa: E402
from kornia_tpu_torch import io  # noqa: E402
from kornia_tpu_torch import utils  # noqa: E402
from kornia_tpu_torch import augmentations  # noqa: E402
from kornia_tpu_torch import apriltag  # noqa: E402
from kornia_tpu_torch import bow  # noqa: E402
from kornia_tpu_torch import parallel  # noqa: E402
from kornia_tpu_torch import slam  # noqa: E402
from kornia_tpu_torch import models  # noqa: E402

__all__ = [
    "image",
    "ops",
    "features",
    "geometry",
    "optim",
    "io",
    "utils",
    "augmentations",
    "apriltag",
    "bow",
    "parallel",
    "slam",
    "models",
    "__version__",
]
