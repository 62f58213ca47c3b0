"""Model zoo (port of kornia_tpu/models/): the SmolVLM-class VLM and
PaliGemma as ``nn.Module``s — SigLIP vision tower, llama-style and Gemma
decoders with an in-place KV cache, pixel-shuffle connector — and the
generation loop, the processor and video sampling. ``build_vlm``,
``build_paligemma``, ``generate``, ``preprocess_image`` and
``preprocess_video`` take ``device=`` (the card by default). No weights
ship with the repository: models are built with random weights from a
seed, and real ones load from the reference's flax names
(``load_params``, ``load_params_npz``, :mod:`.hf_convert`)."""

from kornia_tpu_torch.models.vit import ViTConfig, VisionTransformer
from kornia_tpu_torch.models.llm import CausalLM, KVCache, LLMConfig
from kornia_tpu_torch.models.vlm import (
    GenerationResult,
    SmolVLM,
    VLMConfig,
    build_vlm,
    generate,
    load_params,
    load_params_npz,
    save_params_npz,
    sample_video_frames,
    smolvlm_256m,
    smolvlm_500m,
    smolvlm_2_2b,
)
from kornia_tpu_torch.models.video import (
    VideoMetadata,
    VideoSample,
    preprocess_video,
    sample_video,
)
from kornia_tpu_torch.models.gemma import GemmaConfig, GemmaLM
from kornia_tpu_torch.models.paligemma import (
    PaliGemma,
    PaliGemmaConfig,
    build_paligemma,
)
from kornia_tpu_torch.models.processor import (
    build_prompt_tokens,
    preprocess_image,
    split_into_tiles,
)

__all__ = [
    "ViTConfig",
    "VisionTransformer",
    "CausalLM",
    "KVCache",
    "LLMConfig",
    "SmolVLM",
    "VLMConfig",
    "GenerationResult",
    "build_vlm",
    "generate",
    "load_params",
    "load_params_npz",
    "save_params_npz",
    "sample_video_frames",
    "smolvlm_256m",
    "smolvlm_500m",
    "smolvlm_2_2b",
    "VideoMetadata",
    "VideoSample",
    "preprocess_video",
    "sample_video",
    "GemmaConfig",
    "GemmaLM",
    "PaliGemma",
    "PaliGemmaConfig",
    "build_paligemma",
    "preprocess_image",
    "split_into_tiles",
    "build_prompt_tokens",
]
