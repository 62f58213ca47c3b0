"""Segmentation-mask utilities: COCO-style RLE encode/decode (port of
kornia_tpu/ops/segmentation.py).

Host numpy in the reference, and here a copy of it (the port imports
nothing of the JAX package): COCO run-length encoding over column-major
masks, and the IoU of two masks. Tensors are taken as numpy arrays (a
CUDA tensor is copied to the host first).
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch


def _host(x) -> np.ndarray:
    """A numpy array of ``x`` (a tensor on any device, an array, a list)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def rle_to_mask(rle: Sequence[int], height: int, width: int) -> np.ndarray:
    """Decode COCO RLE counts to an (H, W) u8 {0,1} mask.

    COCO convention: counts alternate runs of 0s and 1s (starting with
    0s) over the mask flattened in COLUMN-major order.
    """
    counts = _host(rle).astype(np.int64)
    total = height * width
    if counts.sum() != total:
        raise ValueError(
            f"RLE counts sum {counts.sum()} != mask size {total}")
    flat = np.zeros(total, np.uint8)
    ends = np.cumsum(counts)
    starts = np.concatenate([[0], ends[:-1]])
    for i in range(1, len(counts), 2):
        flat[starts[i]: ends[i]] = 1
    return flat.reshape(width, height).T.copy()


def mask_to_rle(mask: np.ndarray) -> List[int]:
    """Encode an (H, W) {0,1} mask to COCO RLE counts (column-major)."""
    mask = _host(mask)
    if mask.ndim != 2:
        raise ValueError(f"mask must be (H, W), got {mask.shape}")
    flat = (mask.T.reshape(-1) != 0).astype(np.uint8)
    # run boundaries
    change = np.nonzero(np.diff(flat))[0] + 1
    bounds = np.concatenate([[0], change, [flat.size]])
    counts = np.diff(bounds).tolist()
    if flat.size and flat[0] == 1:
        counts = [0] + counts  # COCO runs start with a 0-run
    return counts


def masks_iou(a: np.ndarray, b: np.ndarray) -> float:
    """IoU between two binary masks."""
    a = _host(a) != 0
    b = _host(b) != 0
    union = np.logical_or(a, b).sum()
    if union == 0:
        return 0.0
    return float(np.logical_and(a, b).sum() / union)
