"""SigLIP-style vision transformer, the SmolVLM and PaliGemma vision
tower (port of kornia_tpu/models/vit.py).

A ``VALID`` stride-p convolution patchifies NHWC images (the kernel is
stored OIHW; the reference's is HWIO), a learned positional embedding is
sliced to the patch count, then pre-norm blocks of full attention (one
``qkv`` projection with bias standing for the reference's
``DenseGeneral((3, H, hd))``) and a tanh-GELU MLP, and a final LayerNorm.

:class:`LayerNorm` is ``F.layer_norm`` in float32 (the two-pass
variance). flax's ``LayerNorm`` takes ``max(0, E[x²] − E[x]²)`` by default
(``use_fast_variance=True``). On inputs centred near 0, as the residual
stream is, the two agree to float32 rounding (4.8e-7 at |y| ≤ 6); on
inputs with a large mean the fast form cancels, and flax's two forms
part by as much as the port and flax do (3e-4 at mean 20, 5e-3 at mean
100): writing the fast form by hand, in another summation order, comes no
closer (tests/test_torch_models.py).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from kornia_tpu_torch.models.llm import Dense


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    image_size: int = 384
    patch_size: int = 14
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_layers: int = 12
    num_heads: int = 12
    layer_norm_eps: float = 1e-6
    dtype: torch.dtype = torch.float32

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm``'s parameters (``scale`` as ``weight``, ``bias``)
    over ``F.layer_norm`` with float32 statistics."""

    def __init__(self, dim: int, eps: float, dtype: torch.dtype):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim, dtype=dtype))
        self.bias = nn.Parameter(torch.zeros(dim, dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        f32 = torch.float32
        return F.layer_norm(x.to(f32), self.weight.shape, self.weight.to(f32),
                            self.bias.to(f32), self.eps).to(x.dtype)


class ViTAttention(nn.Module):
    def __init__(self, cfg: ViTConfig):
        super().__init__()
        c = cfg
        hd = c.hidden_size // c.num_heads
        self.num_heads = c.num_heads
        self.qkv = Dense((c.hidden_size,), (3, c.num_heads, hd), True,
                         c.dtype)
        self.proj = Dense((c.num_heads, hd), (c.hidden_size,), True, c.dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, _ = x.shape
        h = self.num_heads
        qkv = self.qkv(x).view(b, n, 3, h, -1)
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
        attn = torch.matmul(q * q.shape[-1] ** -0.5, k.transpose(-1, -2))
        attn = torch.softmax(attn.to(torch.float32), -1).to(x.dtype)
        out = torch.matmul(attn, v).transpose(1, 2).reshape(b, n, -1)
        return self.proj(out)


class ViTBlock(nn.Module):
    def __init__(self, cfg: ViTConfig):
        super().__init__()
        c = cfg
        self.ln1 = LayerNorm(c.hidden_size, c.layer_norm_eps, c.dtype)
        self.attn = ViTAttention(c)
        self.ln2 = LayerNorm(c.hidden_size, c.layer_norm_eps, c.dtype)
        self.fc1 = Dense((c.hidden_size,), (c.intermediate_size,), True,
                         c.dtype)
        self.fc2 = Dense((c.intermediate_size,), (c.hidden_size,), True,
                         c.dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.ln1(x))
        h = F.gelu(self.fc1(self.ln2(x)), approximate="tanh")
        return x + self.fc2(h)


class VisionTransformer(nn.Module):
    """Patchify → transformer encoder → (B, N_patches, hidden)."""

    def __init__(self, cfg: ViTConfig):
        super().__init__()
        c = cfg
        self.cfg = cfg
        self.patch_embed = nn.Conv2d(3, c.hidden_size, c.patch_size,
                                     stride=c.patch_size, dtype=c.dtype)
        self.pos_embed = nn.Parameter(torch.zeros(
            1, c.num_patches, c.hidden_size, dtype=c.dtype))
        for i in range(c.num_layers):
            self.add_module(f"block_{i}", ViTBlock(c))
        self.ln_post = LayerNorm(c.hidden_size, c.layer_norm_eps, c.dtype)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """images: (B, H, W, 3) float in [-1, 1] (SigLIP normalisation)."""
        c = self.cfg
        x = self.patch_embed(images.to(c.dtype).permute(0, 3, 1, 2))
        x = x.flatten(2).transpose(1, 2)                # (B, N, hidden)
        x = x + self.pos_embed[:, : x.shape[1]]
        for i in range(c.num_layers):
            x = getattr(self, f"block_{i}")(x)
        return self.ln_post(x)
