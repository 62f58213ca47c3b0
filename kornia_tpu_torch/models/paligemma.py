"""PaliGemma vision-language model: SigLIP tower + Gemma decoder (port of
kornia_tpu/models/paligemma.py).

image → SigLIP tower (no pooling head) → linear projector (with bias) →
features / sqrt(text_hidden) → spliced over the ``<image>`` tokens of the
UNSCALED token embeddings → GemmaLM (which applies the sqrt(hidden) input
normaliser), bidirectional over the image + prompt prefix and causal for
generated tokens. :func:`kornia_tpu_torch.models.vlm.generate` serves it:
the prefill passes ``prefix_len = length + T``, decode steps are causal
and still see the cached prefix.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
from torch import nn

from kornia_tpu_torch.models.gemma import GemmaConfig, GemmaLM
from kornia_tpu_torch.models.llm import Dense, KVCache
from kornia_tpu_torch.models.vit import ViTConfig, VisionTransformer
from kornia_tpu_torch.models.vlm import build_model, splice_image_features
from kornia_tpu_torch.ops.filters import div_scalar


@dataclasses.dataclass(frozen=True)
class PaliGemmaConfig:
    vision: ViTConfig = ViTConfig(
        image_size=224, patch_size=14, hidden_size=1152,
        intermediate_size=4304, num_layers=27, num_heads=16)
    text: GemmaConfig = GemmaConfig()
    image_token_id: int = 257152

    @property
    def tokens_per_image(self) -> int:
        return self.vision.num_patches


class PaliGemma(nn.Module):
    """SigLIP tower + linear projector + Gemma decoder."""

    def __init__(self, cfg: PaliGemmaConfig):
        super().__init__()
        self.cfg = cfg
        self.vision = VisionTransformer(cfg.vision)
        self.text = GemmaLM(cfg.text)
        # HF multi_modal_projector.linear carries a bias
        self.projector = Dense((cfg.vision.hidden_size,),
                               (cfg.text.hidden_size,), True, torch.float32)

    def encode_images(self, images: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) in [-1, 1] → (B, N_patches, text_hidden), divided
        by sqrt(text_hidden) (HF's merge-step scaling, which cancels the
        decoder's input normaliser at image positions)."""
        feats = self.projector(self.vision(images).to(torch.float32))
        return div_scalar(feats, self.cfg.text.hidden_size ** 0.5)

    def embed_multimodal(self, tokens: torch.Tensor,
                         image_feats: Optional[torch.Tensor]) -> torch.Tensor:
        return splice_image_features(self.text.embed_tokens(tokens), tokens,
                                     image_feats, self.cfg.image_token_id)

    def forward(self, tokens: torch.Tensor, images: Optional[torch.Tensor],
                cache: KVCache) -> Tuple[torch.Tensor, KVCache]:
        """Prefill: the whole (image tokens + prompt) block is the
        bidirectional prefix (HF PaliGemma's token_type semantics)."""
        feats = self.encode_images(images) if images is not None else None
        emb = self.embed_multimodal(tokens, feats).to(self.cfg.text.dtype)
        return self.text(emb, cache,
                         prefix_len=cache.length + tokens.shape[1])

    def decode_step(self, token: torch.Tensor, cache: KVCache
                    ) -> Tuple[torch.Tensor, KVCache]:
        logits, cache = self.text(self.text.embed_tokens(token), cache)
        return logits[:, -1], cache


def build_paligemma(cfg: PaliGemmaConfig = PaliGemmaConfig(),
                    seed: int = 0, device="cuda") -> PaliGemma:
    """A PaliGemma with random weights from ``seed`` on ``device``."""
    return build_model(PaliGemma, cfg, seed, device)
