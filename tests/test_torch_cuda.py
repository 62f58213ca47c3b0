"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Every test is marked ``cuda`` and skips without one (the kernels have
no CPU mode). This file imports neither jax nor kornia_tpu, so on a GPU
machine without JAX it runs without the repo's conftest:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest
"""

import numpy as np
import pytest
import torch

from kornia_tpu_torch import convert
from kornia_tpu_torch.ops import cuda_kernels as ck

_SHAPES = [(60, 80), (50, 67), (42, 56)]


@pytest.fixture
def cuda_dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _img(seed, shape):
    return np.random.default_rng(seed).integers(0, 256, shape, np.uint8)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(480, 752), (134, 210), (37, 45),
                                   (5, 7)])
def test_cuda_fast_harris_bit_equal(cuda_dev, shape):
    """Score, NMS and Harris maps bit-equal to the plain version, borders
    included (the kernel keeps the reference padding and op order)."""
    img = convert.tensor(_img(10, shape), cuda_dev)
    ck.reset_launch_counts()
    s_k, h_k = ck.fast_harris(img, 7.0)
    s_p, h_p = ck._fast_harris_plain(img, 7.0)
    torch.cuda.synchronize()
    assert ck.LAUNCHES["fast_harris"] == 1
    assert torch.equal(s_k, s_p) and torch.equal(h_k, h_p)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [16, 15])
def test_cuda_windows_and_taps_bit_equal(cuda_dev, k):
    """Paired windows (odd K, border keypoints, pairs across levels) and
    BRIEF taps bit-equal to the plain versions."""
    rng = np.random.default_rng(11)
    frames = [convert.tensor(_img(12 + i, s).astype(np.float32), cuda_dev)
              for i, s in enumerate(_SHAPES)]
    canvas, starts = ck.prepare_window_canvas(frames)
    xys = []
    for (h, w), s, n in zip(_SHAPES, starts, (k - 9, 5, 4)):
        xy = np.stack([rng.integers(0, w, n), rng.integers(0, h, n)], 1)
        xy[0] = (0, 0)
        xy[1] = (w - 1, h - 1)
        xys.append(xy + np.array([0, s]))
    xy = convert.tensor(np.concatenate(xys).astype(np.int32), cuda_dev)
    w_k = ck.windows_paired(canvas, xy, 80)
    assert torch.equal(w_k, ck._windows_paired_plain(canvas, xy, 80))
    rows = convert.tensor(rng.integers(0, 40, (w_k.shape[0], 1024))
                          .astype(np.int32), cuda_dev)
    cols = convert.tensor(rng.integers(0, 128, (w_k.shape[0], 1024))
                          .astype(np.int32), cuda_dev)
    assert torch.equal(ck.brief_sample(w_k, rows, cols),
                       ck._brief_sample_plain(w_k, rows, cols))


@pytest.mark.cuda
def test_cuda_wrappers_reject_bad_input(cuda_dev):
    img = convert.tensor(_img(13, (32, 32)), cuda_dev)
    with pytest.raises(ValueError):
        ck.fast_harris(img.to(torch.float32), 7.0)
    with pytest.raises(ValueError):
        ck.fast_harris(img.t(), 7.0)       # not contiguous
    win = torch.zeros((2, 40, 128), device=cuda_dev)
    idx = torch.zeros((2, 1024), dtype=torch.int64, device=cuda_dev)
    with pytest.raises(ValueError):
        ck.brief_sample(win, idx, idx)
