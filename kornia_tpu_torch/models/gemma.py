"""Gemma-style causal decoder, the PaliGemma text backbone (port of
kornia_tpu/models/gemma.py).

Where Gemma differs from the llama family (:mod:`.llm`): RMSNorm scales by
``(1 + w)`` and runs in float32 throughout, the token embedding is
multiplied by ``sqrt(hidden)`` at the model input, the head dim is a
config field (256 for Gemma-2B, not hidden/heads; one KV head makes it
MQA), and the MLP is GeGLU with the tanh GELU. ``forward`` takes an
optional ``prefix_len``: keys and queries inside the prefix see each other
both ways (PaliGemma's image + prompt prefix), the rest is causal. The
cache, its in-place writes and the attention are :mod:`.llm`'s.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from kornia_tpu_torch.models.llm import CausalLM, DecoderBlock, KVCache


@dataclasses.dataclass(frozen=True)
class GemmaConfig:
    vocab_size: int = 257216        # PaliGemma vocab (Gemma + loc/seg)
    hidden_size: int = 2048
    intermediate_size: int = 16384
    num_layers: int = 18
    num_heads: int = 8
    num_kv_heads: int = 1           # Gemma-2B is MQA
    head_dim: int = 256             # explicit — NOT hidden/heads
    max_seq_len: int = 1024
    rope_theta: float = 10000.0
    rms_eps: float = 1e-6
    dtype: torch.dtype = torch.float32


class GemmaRMSNorm(nn.Module):
    """RMSNorm with Gemma's zero-centred ``(1 + w)`` scale, in float32 end
    to end (gemma.py:44-56)."""

    def __init__(self, dim: int, eps: float, dtype: torch.dtype):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.zeros(dim, dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # (x · rsqrt(mean(x²) + eps)) · (1 + w), all float32: F.rms_norm
        # with the weight 1 + w (one fused launch on the card)
        xf = x.to(torch.float32)
        w = 1.0 + self.weight.to(torch.float32)
        return F.rms_norm(xf, (xf.shape[-1],), w, self.eps).to(x.dtype)


class GemmaBlock(DecoderBlock):
    """DecoderBlock with GemmaRMSNorm and the GeGLU gate (gemma.py:98)."""

    norm_cls = GemmaRMSNorm

    @staticmethod
    def act(x: torch.Tensor) -> torch.Tensor:
        return F.gelu(x, approximate="tanh")


class GemmaLM(CausalLM):
    """Gemma decoder over embeddings. ``forward`` takes RAW (unscaled)
    embeddings and applies the ``sqrt(hidden)`` input normaliser itself,
    as HF's GemmaModel does, so that VLM callers splice image features at
    the unscaled level, as PaliGemma's merge step does."""

    block_cls = GemmaBlock

    def forward(self, embeds: torch.Tensor, cache: KVCache,
                prefix_len: Optional[int] = None
                ) -> Tuple[torch.Tensor, KVCache]:
        """embeds: (B, T, H) raw embeddings starting at ``cache.length``;
        ``prefix_len``: an int, or None for a pure causal mask."""
        # the normaliser in the embeddings' dtype (gemma.py:144-145)
        x = embeds * torch.full((), self.cfg.hidden_size ** 0.5,
                                dtype=embeds.dtype, device=embeds.device)
        return self.decode(x, cache, prefix_len)
