"""SmolVLM-style vision-language model and its generation loop (port of
kornia_tpu/models/vlm.py).

SigLIP vision tower → pixel-shuffle connector → llama-style decoder; image
features replace the ``<image>`` placeholder tokens in the embedding
sequence. :func:`generate` serves SmolVLM and PaliGemma alike.

The reference compiles one program per (model, shapes, knobs) and runs
the decode as a ``lax.scan``. The port runs a Python loop of eager steps
against the in-place KV cache: nothing is compiled, so nothing is cached,
and no step reads the device (the cache length is a host integer, ``done``
stays on the device). The one read is the stream callback's, after the
loop, as in the reference.

Weights are random, drawn from a seeded ``torch.Generator`` with the
scales of flax's initialisers (not its draws). Real weights arrive through
:func:`load_params` / :func:`load_params_npz` under the reference's
``'/'``-joined flax names and layouts (``params/vision/block_0/attn/qkv/
kernel``), so a file written by either package loads into the other, and
:mod:`.hf_convert`'s output loads unchanged.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Iterator, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch import nn

from kornia_tpu_torch import resolve_device, upload
from kornia_tpu_torch.convert import model_params
from kornia_tpu_torch.models.gemma import GemmaRMSNorm
from kornia_tpu_torch.models.llm import (CausalLM, Dense, KVCache, LLMConfig,
                                         RMSNorm)
from kornia_tpu_torch.models.vit import LayerNorm, ViTConfig, \
    VisionTransformer
from kornia_tpu_torch.ops.filters import div_scalar


@dataclasses.dataclass(frozen=True)
class VLMConfig:
    vision: ViTConfig = ViTConfig(
        image_size=384, patch_size=14, hidden_size=384,
        intermediate_size=1536, num_layers=6, num_heads=6)
    text: LLMConfig = LLMConfig(
        vocab_size=49280, hidden_size=576, intermediate_size=1536,
        num_layers=6, num_heads=9, num_kv_heads=3, max_seq_len=1024)
    pixel_shuffle_factor: int = 3
    image_token_id: int = 49190

    @property
    def tokens_per_image(self) -> int:
        side = self.vision.image_size // self.vision.patch_size
        side = side // self.pixel_shuffle_factor
        return side * side


def smolvlm_256m() -> VLMConfig:
    """SmolVLM(2)-256M-Instruct architecture preset: SigLIP-base-p16/512
    tower, SmolLM2-135M decoder, pixel-shuffle 4 (64 tokens/image)."""
    return VLMConfig(
        vision=ViTConfig(image_size=512, patch_size=16, hidden_size=768,
                         intermediate_size=3072, num_layers=12,
                         num_heads=12),
        text=LLMConfig(vocab_size=49280, hidden_size=576,
                       intermediate_size=1536, num_layers=30,
                       num_heads=9, num_kv_heads=3, max_seq_len=8192),
        pixel_shuffle_factor=4,
        image_token_id=49190)


def smolvlm_500m() -> VLMConfig:
    """SmolVLM(2)-500M-Instruct preset: SigLIP-base-p16/512 tower,
    SmolLM2-360M decoder, pixel-shuffle 4."""
    return VLMConfig(
        vision=ViTConfig(image_size=512, patch_size=16, hidden_size=768,
                         intermediate_size=3072, num_layers=12,
                         num_heads=12),
        text=LLMConfig(vocab_size=49280, hidden_size=960,
                       intermediate_size=2560, num_layers=32,
                       num_heads=15, num_kv_heads=5, max_seq_len=8192),
        pixel_shuffle_factor=4,
        image_token_id=49190)


def smolvlm_2_2b() -> VLMConfig:
    """SmolVLM(2)-2.2B-Instruct preset: SigLIP-SO400M-p14/384 tower,
    SmolLM2-1.7B decoder, pixel-shuffle 3 (81 tokens/image)."""
    return VLMConfig(
        vision=ViTConfig(image_size=384, patch_size=14, hidden_size=1152,
                         intermediate_size=4304, num_layers=27,
                         num_heads=16),
        text=LLMConfig(vocab_size=49280, hidden_size=2048,
                       intermediate_size=8192, num_layers=24,
                       num_heads=32, num_kv_heads=32, max_seq_len=8192),
        pixel_shuffle_factor=3,
        image_token_id=49190)


def splice_image_features(emb: torch.Tensor, tokens: torch.Tensor,
                          image_feats: Optional[torch.Tensor],
                          image_token_id: int) -> torch.Tensor:
    """``emb`` (B, T, H) with the k-th ``<image>`` token of each row
    replaced by ``image_feats[:, k]`` (vlm.py:120-133: a cumsum index,
    clipped to range)."""
    if image_feats is None:
        return emb
    is_img = tokens == image_token_id
    idx = torch.cumsum(is_img, dim=1) - 1
    idx = idx.clamp(0, image_feats.shape[1] - 1)
    gathered = torch.gather(
        image_feats, 1, idx[:, :, None].expand(-1, -1, image_feats.shape[2]))
    return torch.where(is_img[:, :, None], gathered, emb)


class SmolVLM(nn.Module):
    """Vision tower + connector + decoder (SmolVLM architecture)."""

    def __init__(self, cfg: VLMConfig):
        super().__init__()
        self.cfg = cfg
        self.vision = VisionTransformer(cfg.vision)
        self.text = CausalLM(cfg.text)
        r2 = cfg.pixel_shuffle_factor ** 2
        self.connector = Dense((cfg.vision.hidden_size * r2,),
                               (cfg.text.hidden_size,), False,
                               torch.float32)

    def _pixel_shuffle(self, x: torch.Tensor) -> torch.Tensor:
        """(B, N, D) → (B, N/r², D·r²): trade tokens for channels
        (vlm.py:103-112)."""
        r = self.cfg.pixel_shuffle_factor
        b, n, d = x.shape
        side = int(round(n ** 0.5))
        x = x.reshape(b, side // r, r, side // r, r, d)
        x = x.permute(0, 1, 3, 2, 4, 5)
        return x.reshape(b, (side // r) ** 2, d * r * r)

    def encode_images(self, images: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) in [-1, 1] → (B, tokens_per_image, text_hidden)."""
        feats = self._pixel_shuffle(self.vision(images))
        return self.connector(feats.to(self.connector.weight.dtype))

    def embed_multimodal(self, tokens: torch.Tensor,
                         image_feats: Optional[torch.Tensor]) -> torch.Tensor:
        """Token embeddings with the ``<image>`` positions replaced by the
        image features, in order. tokens: (B, T); image_feats (B, Ni, H)."""
        return splice_image_features(self.text.embed_tokens(tokens), tokens,
                                     image_feats, self.cfg.image_token_id)

    def forward(self, tokens: torch.Tensor, images: Optional[torch.Tensor],
                cache: KVCache) -> Tuple[torch.Tensor, KVCache]:
        feats = self.encode_images(images) if images is not None else None
        emb = self.embed_multimodal(tokens, feats)
        return self.text(emb.to(self.cfg.text.dtype), cache)

    def decode_step(self, token: torch.Tensor, cache: KVCache
                    ) -> Tuple[torch.Tensor, KVCache]:
        """One decode step: (B, 1) token → (B, vocab) logits."""
        logits, cache = self.text(self.text.embed_tokens(token), cache)
        return logits[:, -1], cache


class GenerationResult(NamedTuple):
    tokens: torch.Tensor       # (B, max_new) generated ids (eos-padded)
    n_generated: torch.Tensor  # (B,) count before eos


# --------------------------------------------------------------------------
# parameters: random init, and the reference's flax names and layouts
# --------------------------------------------------------------------------


def init_params(model: nn.Module, generator: torch.Generator) -> None:
    """Fill every parameter of ``model`` from ``generator`` with the
    scales of the reference's flax initialisers: kernels normal with
    variance 1/fan_in (lecun), embeddings 1/hidden, the positional
    embedding σ 0.02, biases and Gemma's norm weights 0, the other norm
    weights 1."""
    for mod in model.modules():
        if isinstance(mod, (Dense, nn.Conv2d, nn.Embedding)):
            # fan-in: a Linear's input width, a conv's kh·kw·cin, and for
            # the embedding (flax's fan-in over its feature axis) hidden
            fan_in = mod.weight[0].numel()
            mod.weight.normal_(0.0, fan_in ** -0.5, generator=generator)
            if getattr(mod, "bias", None) is not None:
                mod.bias.zero_()
        elif isinstance(mod, LayerNorm):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
        elif isinstance(mod, RMSNorm):
            mod.weight.fill_(1.0)
        elif isinstance(mod, GemmaRMSNorm):
            mod.weight.zero_()
        elif isinstance(mod, VisionTransformer):
            mod.pos_embed.normal_(0.0, 0.02, generator=generator)


def build_model(cls, cfg, seed: int, device) -> nn.Module:
    """``cls(cfg)`` on ``device`` in eval mode without gradients, its
    weights drawn from a generator on that device seeded with ``seed``
    (on ``"meta"``: shapes only)."""
    dev = resolve_device(device)
    with torch.device("meta"):
        model = cls(cfg)
    model.requires_grad_(False).eval()
    if dev.type == "meta":
        return model
    model.to_empty(device=dev)
    with torch.no_grad():
        init_params(model, torch.Generator(device=dev).manual_seed(seed))
    return model


def build_vlm(cfg: VLMConfig = VLMConfig(), seed: int = 0,
              device="cuda") -> SmolVLM:
    """A SmolVLM with random weights from ``seed`` on ``device``."""
    return build_model(SmolVLM, cfg, seed, device)


def _flax_entries(model: nn.Module) -> Iterator[Tuple[str, torch.Tensor,
                                                      Tuple[int, ...]]]:
    """(flax name, the port's parameter, its flax shape) of every
    parameter, in ``named_parameters`` order."""
    for mname, mod in model.named_modules():
        base = "params/" + mname.replace(".", "/") + ("/" if mname else "")
        for pname, p in mod.named_parameters(recurse=False):
            if isinstance(mod, Dense):
                shape = (mod.kernel_shape if pname == "weight"
                         else mod.out_shape)
                name = "kernel" if pname == "weight" else "bias"
            elif isinstance(mod, nn.Conv2d):
                shape = (tuple(p.shape[2:]) + (p.shape[1], p.shape[0])
                         if pname == "weight" else tuple(p.shape))
                name = "kernel" if pname == "weight" else "bias"
            elif isinstance(mod, nn.Embedding):
                shape, name = tuple(p.shape), "embedding"
            elif isinstance(mod, LayerNorm):
                shape = tuple(p.shape)
                name = "scale" if pname == "weight" else "bias"
            else:
                shape, name = tuple(p.shape), pname
            yield base + name, p, shape


def flax_shapes(model: nn.Module) -> Dict[str, Tuple[int, ...]]:
    """Every parameter's flax name → its shape in the reference."""
    return {k: shape for k, _, shape in _flax_entries(model)}


def _to_flax(p: torch.Tensor, shape, name: str) -> np.ndarray:
    a = p.detach().to("cpu", torch.float32).numpy()
    if name.endswith("/kernel") and a.ndim == 4:     # OIHW → HWIO
        return a.transpose(2, 3, 1, 0)
    if name.endswith("/kernel"):                      # (out, in) → flax
        return np.ascontiguousarray(a.T).reshape(shape)
    return a.reshape(shape)


def flax_params(model: nn.Module) -> Dict[str, np.ndarray]:
    """The model's parameters as the reference's flattened flax params:
    float32 numpy arrays in flax layout under ``'/'``-joined names."""
    return {k: _to_flax(p, shape, k) for k, p, shape in _flax_entries(model)}


@torch.no_grad()
def load_params(model: nn.Module, flat_updates: Dict[str, np.ndarray]
                ) -> nn.Module:
    """Overlay converted weights (flax name → array in flax layout) onto
    ``model``, in place; returns it. An unknown name raises KeyError, a
    shape that differs from the reference's ValueError."""
    shapes = flax_shapes(model)
    for k, v in flat_updates.items():
        if k not in shapes:
            raise KeyError(f"unknown parameter {k}")
        if tuple(np.shape(v)) != shapes[k]:
            raise ValueError(
                f"shape mismatch for {k}: {shapes[k]} vs {np.shape(v)}")
    params = dict(model.named_parameters())
    for name, arr in model_params(flat_updates).items():
        p = params[name]
        p.copy_(torch.tensor(arr, dtype=p.dtype))
    return model


def save_params_npz(path: str, model: nn.Module) -> None:
    """Write the model's parameters to one compressed npz under the
    reference's flax names and layouts (its ``load_params_npz`` reads it)."""
    np.savez_compressed(path, **flax_params(model))


def load_params_npz(path: str, model: nn.Module) -> nn.Module:
    """Load a file written by either package's ``save_params_npz`` into
    ``model`` (in place; returned). Every parameter must be there with the
    reference's shape."""
    shapes = flax_shapes(model)
    with np.load(path) as z:
        flat = {}
        for k, shape in shapes.items():
            if k not in z:
                raise KeyError(f"checkpoint missing parameter {k}")
            flat[k] = z[k]
    return load_params(model, flat)


# --------------------------------------------------------------------------
# generation
# --------------------------------------------------------------------------


def _gumbel(shape, generator: torch.Generator, device) -> torch.Tensor:
    """Standard Gumbel noise as ``jax.random.gumbel`` makes it:
    −log(−log(u)), u uniform in [tiny, 1)."""
    u = torch.rand(shape, generator=generator, device=device)
    u = u.clamp_min(torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


@torch.inference_mode()
def generate(
    model: nn.Module, tokens, images=None,
    max_new_tokens: int = 32,
    eos_token_id: int = 2,
    temperature: float = 0.0,
    seed: int = 0,
    stream_callback: Optional[Callable[[int], None]] = None,
    *,
    gumbel: Optional[torch.Tensor] = None,
    device="cuda",
) -> GenerationResult:
    """Prefill, then always ``max_new_tokens − 1`` decode steps (vlm.py:
    186-261). Greedy when ``temperature == 0``; else each token is
    ``argmax(gumbel + logits / temperature)`` (``jax.random.categorical``),
    the noise drawn from a generator on ``device`` seeded with ``seed``
    or, for the reference's draws, taken from ``gumbel``
    (max_new_tokens, B, vocab). Once a row emits ``eos_token_id`` it emits
    it to the end; ``n_generated`` counts the tokens before the first.
    ``stream_callback`` receives row 0's tokens up to and with the first
    eos, after the loop. ``model`` (a SmolVLM or PaliGemma) must be on
    ``device``; tokens (T,) or (B, T) and images (B, H, W, 3) may be numpy
    or tensors. Returns tensors on ``device``."""
    dev = resolve_device(device)
    if next(model.parameters()).device.type != dev.type:
        raise ValueError(f"generate: the model is on "
                         f"{next(model.parameters()).device}, not {dev}")
    cfg = model.cfg
    tokens = upload(tokens, dev, torch.int64)
    if tokens.ndim == 1:
        tokens = tokens[None]
    b = tokens.shape[0]
    if tokens.shape[1] + max_new_tokens - 1 > cfg.text.max_seq_len:
        raise ValueError(
            f"generate: {tokens.shape[1]} prompt tokens and {max_new_tokens} "
            f"new ones exceed max_seq_len {cfg.text.max_seq_len}")
    imgs = None if images is None else upload(images, dev, torch.float32)
    sampled = temperature > 0
    generator = (torch.Generator(device=dev).manual_seed(seed)
                 if sampled and gumbel is None else None)

    def sample(lg: torch.Tensor, step: int) -> torch.Tensor:
        if not sampled:
            return torch.argmax(lg, -1)
        g = (gumbel[step].to(dev, lg.dtype) if gumbel is not None
             else _gumbel(lg.shape, generator, dev))
        return torch.argmax(g + div_scalar(lg, temperature), -1)

    cache = KVCache.zeros(cfg.text, b, device=dev)
    logits, cache = model(tokens, imgs, cache)
    tok = sample(logits[:, -1], 0)
    done = tok == eos_token_id
    out = [tok]
    for step in range(1, max_new_tokens):
        logits, cache = model.text(model.text.embed_tokens(tok[:, None]),
                                   cache)
        nxt = sample(logits[:, -1], step)
        nxt = torch.where(done, eos_token_id, nxt)
        done = done | (nxt == eos_token_id)
        out.append(nxt)
        tok = nxt
    out = torch.stack(out, dim=1).to(torch.int32)
    n_gen = torch.sum(torch.cumsum(out == eos_token_id, dim=1) == 0,
                      dim=1).to(torch.int32)
    if stream_callback is not None:
        host = torch.cat([out[0], n_gen[:1]]).cpu().numpy()
        for t in host[: int(host[-1]) + 1][: out.shape[1]]:
            stream_callback(int(t))
    return GenerationResult(tokens=out, n_generated=n_gen)


def sample_video_frames(n_frames: int, n_samples: int) -> np.ndarray:
    """Uniform frame-index sampling (reference: kornia-vlm video.rs)."""
    if n_frames <= 0:
        return np.empty(0, np.int64)
    n_samples = min(n_samples, n_frames)
    return np.linspace(0, n_frames - 1, n_samples).round().astype(np.int64)
