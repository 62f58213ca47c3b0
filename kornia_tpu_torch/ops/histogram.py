"""Histograms (port of kornia_tpu/ops/histogram.py).

Exact int32 counts by a scatter-add into a fixed-size buffer. The
reference's 16×16 digit one-hot matrix product (histogram.py:25-40) exists
because the TPU scatters at scalar rate; the H100 scatters at memory rate.
``torch.bincount`` is not used: on CUDA it sizes its output from the data,
which waits for the device.
"""

from __future__ import annotations

import torch

from kornia_tpu_torch import entry
from kornia_tpu_torch.ops.filters import div_scalar


def _counts(idx: torch.Tensor, nbins: int) -> torch.Tensor:
    """(nbins,) int32 counts of the int64 bin indices ``idx`` (all in
    [0, nbins))."""
    out = torch.zeros(nbins, dtype=torch.int32, device=idx.device)
    ones = torch.ones((), dtype=torch.int32, device=idx.device).expand(
        idx.numel())
    return out.index_add_(0, idx.reshape(-1), ones)


@entry
def histogram_u8(img: torch.Tensor, nbins: int = 256) -> torch.Tensor:
    """Intensity histogram of u8 data, int32 counts; ``nbins`` < 256
    merges ``(v·nbins) // 256``."""
    flat = img.reshape(-1).to(torch.int64)
    if nbins != 256:
        flat = (flat * nbins) // 256
    return _counts(flat, nbins)


@entry
def histogram(img: torch.Tensor, nbins: int, lo: float = 0.0,
              hi: float = 1.0) -> torch.Tensor:
    """Float histogram over [lo, hi), values outside clipped into the end
    bins, int32 counts; any ``nbins``."""
    x = img.reshape(-1).to(torch.float32)
    idx = torch.clamp((div_scalar(x - lo, hi - lo) * nbins).to(torch.int32),
                      0, nbins - 1)
    return _counts(idx.to(torch.int64), nbins)
