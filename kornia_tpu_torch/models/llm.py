"""Llama-style causal decoder, the SmolVLM/SmolLM2 text backbone (port of
kornia_tpu/models/llm.py).

RMSNorm, rotary embeddings (halves rotated, not interleaved pairs),
grouped-query attention and a SwiGLU MLP, as ``nn.Module``s whose
submodules carry the reference's flax names (``layer_3.q``,
``final_norm``, ...), so that :func:`kornia_tpu_torch.models.vlm.load_params`
maps the reference's parameters onto them by name.

The KV cache has the reference's layout, ``(L, B, max_seq_len, kv_heads,
head_dim)``, but it is written in place and its ``length`` is a host
integer, so that no step reads the device. A forward at ``length`` writes
positions ``[length, length + T)`` before any query reads them, and
attends over the filled keys ``[0, length + T)`` only: the reference masks
the empty rest with ``-1e30``, whose softmax weight is exactly 0 in
float32, so the function is the same. A caller that runs twice from the
same cache gets the same answers, since every position a run reads was
written by that run. Attention is the reference's product: matmul, mask,
float32 softmax, matmul, with the query heads grouped by their KV head
(``(B, kv_heads, rep·T, D)``) instead of repeating the cache.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from kornia_tpu_torch import resolve_device
from kornia_tpu_torch.ops.filters import div_scalar


@dataclasses.dataclass(frozen=True)
class LLMConfig:
    vocab_size: int = 49280
    hidden_size: int = 576
    intermediate_size: int = 1536
    num_layers: int = 8
    num_heads: int = 9
    num_kv_heads: int = 3
    max_seq_len: int = 1024
    rope_theta: float = 10000.0
    rms_eps: float = 1e-5
    dtype: torch.dtype = torch.float32

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


class KVCache(NamedTuple):
    """Per-layer cache ``(L, B, max_seq_len, kv_heads, head_dim)``, written
    in place; ``length`` (a host int) counts the filled positions."""

    k: torch.Tensor
    v: torch.Tensor
    length: int = 0

    @classmethod
    def zeros(cls, cfg, batch: int, device="cuda") -> "KVCache":
        """An empty cache for ``cfg`` (an LLMConfig or GemmaConfig)."""
        shape = (cfg.num_layers, batch, cfg.max_seq_len, cfg.num_kv_heads,
                 cfg.head_dim)
        dev = resolve_device(device)
        return cls(k=torch.zeros(shape, dtype=cfg.dtype, device=dev),
                   v=torch.zeros(shape, dtype=cfg.dtype, device=dev),
                   length=0)


class Dense(nn.Linear):
    """``nn.Linear`` standing for a flax ``Dense``/``DenseGeneral`` whose
    kernel has the shape ``in_shape + out_shape`` (the input axes first);
    the weight is that kernel flattened to (in, out) and transposed."""

    def __init__(self, in_shape, out_shape, bias: bool,
                 dtype: torch.dtype = torch.float32):
        in_shape, out_shape = tuple(in_shape), tuple(out_shape)
        super().__init__(math.prod(in_shape), math.prod(out_shape),
                         bias=bias, dtype=dtype)
        self.kernel_shape = in_shape + out_shape
        self.out_shape = out_shape


def _rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """llm.py:56-58: ``x · rsqrt(mean(x²) + eps) · w``, the mean in float32.
    In float32 this is ``F.rms_norm`` (one fused launch on the card); in
    bfloat16 ``F.rms_norm`` rounds once where the reference rounds after
    each product, so the formula is kept (exact against the reference)."""
    if x.dtype == torch.float32:
        return F.rms_norm(x, (x.shape[-1],), w, eps)
    var = torch.mean(torch.square(x.to(torch.float32)), -1, keepdim=True)
    return (x * torch.rsqrt(var + eps).to(x.dtype)) * w


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float, dtype: torch.dtype):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim, dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _rms_norm(x, self.weight.to(x.dtype), self.eps)


def rope_tables(d: int, positions: torch.Tensor, theta: float):
    """(cos, sin), each (1, T, 1, d) float32, of the rotary angles at
    ``positions`` (T,) (llm.py:72-76), both halves, the sine's first half
    negated: ``apply_rope`` is then one product pair over the whole head."""
    inv_freq = 1.0 / (theta ** div_scalar(torch.arange(
        0, d, 2, dtype=torch.float32, device=positions.device), d))
    ang = positions[:, None].to(torch.float32) * inv_freq[None, :]
    cos, sin = torch.cos(ang), torch.sin(ang)
    return (torch.cat([cos, cos], -1)[None, :, None, :],
            torch.cat([-sin, sin], -1)[None, :, None, :])


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """``[x1·cos − x2·sin, x2·cos + x1·sin]`` as ``x·cos + [x2, x1]·sin``
    with the sine's first half negated: the same products and sums, in
    IEEE arithmetic the same values."""
    d = x.shape[-1]
    swapped = torch.cat([x[..., d // 2:], x[..., : d // 2]], dim=-1)
    return (x * cos + swapped * sin).to(x.dtype)


def _rope(x: torch.Tensor, positions: torch.Tensor,
          theta: float) -> torch.Tensor:
    """Rotary embedding (llm.py:70-80). x: (B, T, H, D); positions: (T,)."""
    cos, sin = rope_tables(x.shape[-1], positions, theta)
    return apply_rope(x, cos, sin)


def positions_of(length: int, t: int, device) -> torch.Tensor:
    """The global positions ``length + arange(t)`` of a forward's tokens."""
    return torch.arange(length, length + t, device=device)


def causal_mask(length: int, t: int, device,
                prefix_len: Optional[int] = None) -> Optional[torch.Tensor]:
    """(t, length + t) bool: key j visible to query i iff j ≤ length + i,
    or, with ``prefix_len``, both lie in the prefix. None where every
    query sees every filled key (a single-token step)."""
    if t == 1:
        return None
    keys = torch.arange(length + t, device=device)
    q_pos = positions_of(length, t, device)
    mask = keys[None, :] <= q_pos[:, None]
    if prefix_len is not None:
        mask = mask | ((keys[None, :] < prefix_len)
                       & (q_pos[:, None] < prefix_len))
    return mask


def cached_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     cache_k: torch.Tensor, cache_v: torch.Tensor,
                     length: int, mask: Optional[torch.Tensor]
                     ) -> torch.Tensor:
    """Write ``k``, ``v`` (B, T, kv_heads, D) into one layer's cache at
    ``[length, length + T)`` and attend ``q`` (B, T, H, D) over the filled
    keys; returns (B, T, H·D). The softmax is float32 (llm.py:108-114)."""
    b, t, h, d = q.shape
    kvh = k.shape[2]
    rep = h // kvh
    n = length + t
    cache_k[:, length:n] = k
    cache_v[:, length:n] = v
    qg = (q * d ** -0.5).view(b, t, kvh, rep, d).permute(0, 2, 3, 1, 4)
    qg = qg.reshape(b, kvh, rep * t, d)
    scores = torch.matmul(qg, cache_k[:, :n].permute(0, 2, 3, 1))
    if mask is not None:
        scores = scores.view(b, kvh, rep, t, n).masked_fill(
            ~mask, -1e30).view(b, kvh, rep * t, n)
    attn = torch.softmax(scores.to(torch.float32), -1).to(q.dtype)
    out = torch.matmul(attn, cache_v[:, :n].permute(0, 2, 1, 3))
    out = out.view(b, kvh, rep, t, d).permute(0, 3, 1, 2, 4)
    return out.reshape(b, t, h * d)


class DecoderBlock(nn.Module):
    """Pre-norm attention and gated MLP (llm.py:83-127). GemmaBlock
    changes the norm and the gate's activation."""

    norm_cls = RMSNorm

    @staticmethod
    def act(x: torch.Tensor) -> torch.Tensor:
        return F.silu(x)

    def __init__(self, cfg):
        super().__init__()
        c = cfg
        hd, dt = c.head_dim, c.dtype
        self.attn_norm = self.norm_cls(c.hidden_size, c.rms_eps, dt)
        self.q = Dense((c.hidden_size,), (c.num_heads, hd), False, dt)
        self.k = Dense((c.hidden_size,), (c.num_kv_heads, hd), False, dt)
        self.v = Dense((c.hidden_size,), (c.num_kv_heads, hd), False, dt)
        self.o = Dense((c.num_heads, hd), (c.hidden_size,), False, dt)
        self.mlp_norm = self.norm_cls(c.hidden_size, c.rms_eps, dt)
        self.gate = Dense((c.hidden_size,), (c.intermediate_size,), False, dt)
        self.up = Dense((c.hidden_size,), (c.intermediate_size,), False, dt)
        self.down = Dense((c.intermediate_size,), (c.hidden_size,), False, dt)

    def forward(self, x, rope, cache_k, cache_v, length: int, mask):
        b, t, _ = x.shape
        hd = cache_k.shape[-1]
        h = self.attn_norm(x)
        q = apply_rope(self.q(h).view(b, t, -1, hd), *rope)
        k = apply_rope(self.k(h).view(b, t, -1, hd), *rope)
        v = self.v(h).view(b, t, -1, hd)
        x = x + self.o(cached_attention(q, k, v, cache_k, cache_v, length,
                                        mask))
        h = self.mlp_norm(x)
        return x + self.down(self.act(self.gate(h)) * self.up(h))


class CausalLM(nn.Module):
    """Decoder-only LM over embeddings: the token embedding lives here, but
    ``forward`` takes embeddings, so that VLMs can splice image tokens.
    GemmaLM changes the block, the norm and the input scale."""

    block_cls = DecoderBlock

    def __init__(self, cfg):
        super().__init__()
        self.cfg = cfg
        self.tok_embed = nn.Embedding(cfg.vocab_size, cfg.hidden_size,
                                      dtype=cfg.dtype)
        for i in range(cfg.num_layers):
            self.add_module(f"layer_{i}", self.block_cls(cfg))
        self.final_norm = self.block_cls.norm_cls(cfg.hidden_size,
                                                  cfg.rms_eps, cfg.dtype)

    @property
    def blocks(self):
        return [getattr(self, f"layer_{i}")
                for i in range(self.cfg.num_layers)]

    def embed_tokens(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.tok_embed(tokens)

    def decode(self, x: torch.Tensor, cache: KVCache,
               prefix_len: Optional[int] = None
               ) -> Tuple[torch.Tensor, KVCache]:
        """The blocks, the final norm and the tied-embedding logits over
        ``x`` (B, T, H) at ``cache.length``; ``prefix_len`` makes keys and
        queries below it see each other both ways."""
        c = self.cfg
        t = x.shape[1]
        dev = x.device
        rope = rope_tables(c.head_dim, positions_of(cache.length, t, dev),
                           c.rope_theta)
        mask = causal_mask(cache.length, t, dev, prefix_len)
        for i, blk in enumerate(self.blocks):
            x = blk(x, rope, cache.k[i], cache.v[i], cache.length, mask)
        # flax's Embed.attend in the config's dtype (llm.py:167)
        logits = F.linear(self.final_norm(x).to(c.dtype),
                          self.tok_embed.weight)
        return logits, cache._replace(length=cache.length + t)

    def forward(self, embeds: torch.Tensor, cache: KVCache
                ) -> Tuple[torch.Tensor, KVCache]:
        """embeds: (B, T, H) starting at ``cache.length``. Returns logits
        (B, T, vocab) and the cache advanced by T (its tensors written in
        place)."""
        return self.decode(embeds, cache)
