"""VLM image and text preprocessing (port of
kornia_tpu/models/processor.py; reference: kornia-vlm smolvlm
preprocessor.rs and the smolvlm2 image/video processors).

The image work runs where ``device=`` says (the card by default) through
the port's :func:`kornia_tpu_torch.ops.resize.resize`, the plain band
matmul the reference uses here too.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from kornia_tpu_torch import resolve_device, upload
from kornia_tpu_torch.ops import resize as resize_mod
from kornia_tpu_torch.ops.filters import const_on, div_scalar


def normalize_batch(frames_u8: torch.Tensor, image_size: int,
                    mean: Tuple[float, ...],
                    std: Tuple[float, ...]) -> torch.Tensor:
    """(..., H, W, 3) u8 → (..., S, S, 3) float32: one stretch resize,
    then ``(x / 255 − mean) / std``, where the frames lie."""
    x = resize_mod.resize(frames_u8, (image_size, image_size), "bilinear")
    x = div_scalar(x.to(torch.float32), 255.0)
    dev = frames_u8.device
    return (x - const_on(tuple(mean), dev)) / const_on(tuple(std), dev)


def preprocess_image(
    img_u8, image_size: int = 384,
    mean: Tuple[float, ...] = (0.5, 0.5, 0.5),
    std: Tuple[float, ...] = (0.5, 0.5, 0.5),
    device="cuda",
) -> torch.Tensor:
    """(H, W, 3) u8 (numpy or tensor) → (1, S, S, 3) float32 on
    ``device``, normalised (SigLIP convention: [-1, 1] with mean = std =
    0.5). Aspect is handled by a stretch resize, as SmolVLM's base-image
    path does."""
    x = upload(img_u8, resolve_device(device))
    return normalize_batch(x, image_size, mean, std)[None]


def split_into_tiles(img_u8, tile: int = 384, max_tiles: int = 4,
                     device="cuda") -> np.ndarray:
    """High-res path: up to ``max_tiles`` tiles plus the global thumbnail
    (SmolVLM's image-splitting strategy), each resized on ``device``.
    Returns (N, tile, tile, 3) u8 on the host, as the reference does."""
    img = upload(img_u8, resolve_device(device))
    h, w = img.shape[:2]
    rows = min(max(1, round(h / tile)), int(np.sqrt(max_tiles)))
    cols = min(max(1, round(w / tile)), max(1, max_tiles // rows))
    out = []
    for r in range(rows):
        for c in range(cols):
            y0, y1 = r * h // rows, (r + 1) * h // rows
            x0, x1 = c * w // cols, (c + 1) * w // cols
            out.append(resize_mod.resize(img[y0:y1, x0:x1], (tile, tile),
                                         "bilinear"))
    # global view last (thumbnail token group)
    out.append(resize_mod.resize(img, (tile, tile), "bilinear"))
    return torch.stack(out).cpu().numpy()


def build_prompt_tokens(
    prompt_ids: List[int], n_image_tokens: int, image_token_id: int,
    bos_token_id: int = 1,
) -> np.ndarray:
    """``<bos> <image>*N prompt`` — the token-level core of the SmolVLM
    chat layout (the tokenizer is the caller's: ids from any tokenizer)."""
    return np.asarray(
        [bos_token_id] + [image_token_id] * n_image_tokens
        + list(prompt_ids), np.int32)
