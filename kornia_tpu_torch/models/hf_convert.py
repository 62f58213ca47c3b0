"""HuggingFace checkpoint → model-zoo weight conversion (port of
kornia_tpu/models/hf_convert.py; a numpy copy, the same four converters).

Conversion works on LOCAL state dicts (torch ``state_dict()`` or
safetensors files read by the caller): nothing is downloaded. The output
is the reference's flattened flax params ('/'-joined names, flax
layouts), which :func:`kornia_tpu_torch.models.load_params` loads into the
port's modules unchanged (and the reference's ``load_params`` into its
own).

Layout rules (torch stores Linear as (out, in); flax Dense kernels are
(in, out); DenseGeneral splits the head axes):
  q_proj  (H*hd, hidden)  -> q.kernel  (hidden, H, hd)
  o_proj  (hidden, H*hd)  -> o.kernel  (H, hd, hidden)
  SigLIP's separate q/k/v projections fuse into one qkv DenseGeneral
  (hidden, 3, H, hd) with biases (3, H, hd).
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def _t(w) -> np.ndarray:
    return np.asarray(w, np.float32).T


def convert_llama_state_dict(sd: Dict[str, "np.ndarray"],
                             num_layers: int,
                             num_heads: int,
                             num_kv_heads: int,
                             prefix: str = "model.",
                             out_prefix: str = "params/") -> Dict[str, np.ndarray]:
    """HF LlamaForCausalLM (tied embeddings) → CausalLM flat params.

    sd values may be torch tensors or numpy arrays. Returns '/'-joined
    paths for :func:`kornia_tpu_torch.models.vlm.load_params`.
    """
    sd = {k: np.asarray(getattr(v, "detach", lambda: v)().cpu()
                        if hasattr(v, "detach") else v, np.float32)
          for k, v in sd.items()}
    hidden = sd[f"{prefix}embed_tokens.weight"].shape[1]
    hd = hidden // num_heads
    out = {
        f"{out_prefix}tok_embed/embedding":
            sd[f"{prefix}embed_tokens.weight"],
        f"{out_prefix}final_norm/weight": sd[f"{prefix}norm.weight"],
    }
    for i in range(num_layers):
        lp = f"{prefix}layers.{i}."
        op = f"{out_prefix}layer_{i}/"
        out[f"{op}attn_norm/weight"] = sd[f"{lp}input_layernorm.weight"]
        out[f"{op}mlp_norm/weight"] = \
            sd[f"{lp}post_attention_layernorm.weight"]
        out[f"{op}q/kernel"] = _t(sd[f"{lp}self_attn.q_proj.weight"]
                                  ).reshape(hidden, num_heads, hd)
        out[f"{op}k/kernel"] = _t(sd[f"{lp}self_attn.k_proj.weight"]
                                  ).reshape(hidden, num_kv_heads, hd)
        out[f"{op}v/kernel"] = _t(sd[f"{lp}self_attn.v_proj.weight"]
                                  ).reshape(hidden, num_kv_heads, hd)
        out[f"{op}o/kernel"] = _t(sd[f"{lp}self_attn.o_proj.weight"]
                                  ).reshape(num_heads, hd, hidden)
        out[f"{op}gate/kernel"] = _t(sd[f"{lp}mlp.gate_proj.weight"])
        out[f"{op}up/kernel"] = _t(sd[f"{lp}mlp.up_proj.weight"])
        out[f"{op}down/kernel"] = _t(sd[f"{lp}mlp.down_proj.weight"])
    return out


def convert_siglip_state_dict(sd: Dict[str, "np.ndarray"],
                              num_layers: int,
                              num_heads: int,
                              prefix: str = "vision_model.",
                              out_prefix: str = "params/"
                              ) -> Dict[str, np.ndarray]:
    """HF SiglipVisionModel → VisionTransformer flat params."""
    sd = {k: np.asarray(getattr(v, "detach", lambda: v)().cpu()
                        if hasattr(v, "detach") else v, np.float32)
          for k, v in sd.items()}
    pe_w = sd[f"{prefix}embeddings.patch_embedding.weight"]
    hidden = pe_w.shape[0]
    hd = hidden // num_heads
    out = {
        # torch conv (out, in, kh, kw) -> flax (kh, kw, in, out)
        f"{out_prefix}patch_embed/kernel":
            pe_w.transpose(2, 3, 1, 0),
        f"{out_prefix}patch_embed/bias":
            sd[f"{prefix}embeddings.patch_embedding.bias"],
        f"{out_prefix}pos_embed":
            sd[f"{prefix}embeddings.position_embedding.weight"][None],
        f"{out_prefix}ln_post/scale":
            sd[f"{prefix}post_layernorm.weight"],
        f"{out_prefix}ln_post/bias": sd[f"{prefix}post_layernorm.bias"],
    }
    for i in range(num_layers):
        lp = f"{prefix}encoder.layers.{i}."
        op = f"{out_prefix}block_{i}/"
        out[f"{op}ln1/scale"] = sd[f"{lp}layer_norm1.weight"]
        out[f"{op}ln1/bias"] = sd[f"{lp}layer_norm1.bias"]
        out[f"{op}ln2/scale"] = sd[f"{lp}layer_norm2.weight"]
        out[f"{op}ln2/bias"] = sd[f"{lp}layer_norm2.bias"]
        qkv_w = np.stack([
            _t(sd[f"{lp}self_attn.q_proj.weight"]
               ).reshape(hidden, num_heads, hd),
            _t(sd[f"{lp}self_attn.k_proj.weight"]
               ).reshape(hidden, num_heads, hd),
            _t(sd[f"{lp}self_attn.v_proj.weight"]
               ).reshape(hidden, num_heads, hd),
        ], axis=1)                        # (hidden, 3, H, hd)
        qkv_b = np.stack([
            sd[f"{lp}self_attn.q_proj.bias"].reshape(num_heads, hd),
            sd[f"{lp}self_attn.k_proj.bias"].reshape(num_heads, hd),
            sd[f"{lp}self_attn.v_proj.bias"].reshape(num_heads, hd),
        ], axis=0)                        # (3, H, hd)
        out[f"{op}attn/qkv/kernel"] = qkv_w
        out[f"{op}attn/qkv/bias"] = qkv_b
        out[f"{op}attn/proj/kernel"] = _t(
            sd[f"{lp}self_attn.out_proj.weight"]
        ).reshape(num_heads, hd, hidden)
        out[f"{op}attn/proj/bias"] = sd[f"{lp}self_attn.out_proj.bias"]
        out[f"{op}fc1/kernel"] = _t(sd[f"{lp}mlp.fc1.weight"])
        out[f"{op}fc1/bias"] = sd[f"{lp}mlp.fc1.bias"]
        out[f"{op}fc2/kernel"] = _t(sd[f"{lp}mlp.fc2.weight"])
        out[f"{op}fc2/bias"] = sd[f"{lp}mlp.fc2.bias"]
    return out


def convert_gemma_state_dict(sd: Dict[str, "np.ndarray"],
                             num_layers: int,
                             num_heads: int,
                             num_kv_heads: int,
                             head_dim: int,
                             prefix: str = "model.",
                             out_prefix: str = "params/"
                             ) -> Dict[str, np.ndarray]:
    """HF GemmaForCausalLM (tied embeddings) → GemmaLM flat params.

    Gemma's head_dim is an explicit config field (256 for 2B), so it is
    a parameter here rather than derived from hidden/heads.
    Reference capability: crates/kornia-vlm/src/paligemma (candle
    VarBuilder over the same HF layout).
    """
    sd = {k: np.asarray(getattr(v, "detach", lambda: v)().cpu()
                        if hasattr(v, "detach") else v, np.float32)
          for k, v in sd.items()}
    hidden = sd[f"{prefix}embed_tokens.weight"].shape[1]
    hd = head_dim
    out = {
        f"{out_prefix}tok_embed/embedding":
            sd[f"{prefix}embed_tokens.weight"],
        f"{out_prefix}final_norm/weight": sd[f"{prefix}norm.weight"],
    }
    for i in range(num_layers):
        lp = f"{prefix}layers.{i}."
        op = f"{out_prefix}layer_{i}/"
        out[f"{op}attn_norm/weight"] = sd[f"{lp}input_layernorm.weight"]
        out[f"{op}mlp_norm/weight"] = \
            sd[f"{lp}post_attention_layernorm.weight"]
        out[f"{op}q/kernel"] = _t(sd[f"{lp}self_attn.q_proj.weight"]
                                  ).reshape(hidden, num_heads, hd)
        out[f"{op}k/kernel"] = _t(sd[f"{lp}self_attn.k_proj.weight"]
                                  ).reshape(hidden, num_kv_heads, hd)
        out[f"{op}v/kernel"] = _t(sd[f"{lp}self_attn.v_proj.weight"]
                                  ).reshape(hidden, num_kv_heads, hd)
        out[f"{op}o/kernel"] = _t(sd[f"{lp}self_attn.o_proj.weight"]
                                  ).reshape(num_heads, hd, hidden)
        out[f"{op}gate/kernel"] = _t(sd[f"{lp}mlp.gate_proj.weight"])
        out[f"{op}up/kernel"] = _t(sd[f"{lp}mlp.up_proj.weight"])
        out[f"{op}down/kernel"] = _t(sd[f"{lp}mlp.down_proj.weight"])
    return out


def convert_paligemma_state_dict(sd: Dict[str, "np.ndarray"],
                                 num_layers: int,
                                 num_heads: int,
                                 num_kv_heads: int,
                                 head_dim: int,
                                 vision_layers: int,
                                 vision_heads: int,
                                 prefix: str = "model.",
                                 ) -> Dict[str, np.ndarray]:
    """HF PaliGemmaForConditionalGeneration → PaliGemma flat params.

    Covers the three submodules: SigLIP tower
    (``model.vision_tower.vision_model.*``), the biased linear
    projector (``model.multi_modal_projector.linear.*``), and the
    Gemma decoder (``model.language_model.*``)."""
    out = convert_gemma_state_dict(
        sd, num_layers, num_heads, num_kv_heads, head_dim,
        prefix=f"{prefix}language_model.", out_prefix="params/text/")
    out.update(convert_siglip_state_dict(
        sd, vision_layers, vision_heads,
        prefix=f"{prefix}vision_tower.vision_model.",
        out_prefix="params/vision/"))
    def _np(v):
        return np.asarray(v.detach().cpu() if hasattr(v, "detach") else v,
                          np.float32)

    out["params/projector/kernel"] = _np(
        sd[f"{prefix}multi_modal_projector.linear.weight"]).T
    out["params/projector/bias"] = _np(
        sd[f"{prefix}multi_modal_projector.linear.bias"])
    return out
