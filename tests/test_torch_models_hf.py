"""The port's ``hf_convert`` (kornia_tpu_torch/models/hf_convert.py)
against the JAX package's, on tiny Hugging Face models built locally
(``transformers``; nothing is downloaded).

The four converters' outputs equal the reference's, array for array, on
the same state dicts; loaded into the port's modules, they give logits
within the reference's own tolerances (tests/test_models.py: 2e-4 /
2e-3, Gemma and PaliGemma 3e-4 / 2e-3) of the Hugging Face models'.
"""

import numpy as np
import pytest
import torch

from kornia_tpu.models import hf_convert as jhf

from kornia_tpu_torch import models as T
from kornia_tpu_torch.models import gemma as tgemma
from kornia_tpu_torch.models import hf_convert as thf
from kornia_tpu_torch.models import llm as tllm
from kornia_tpu_torch.models import vit as tvit

torch.set_num_threads(1)

CPU = "cpu"


def _hf_models():
    transformers = pytest.importorskip("transformers")
    torch.manual_seed(0)
    llama = transformers.LlamaForCausalLM(transformers.LlamaConfig(
        vocab_size=128, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=64, rope_theta=10000.0, rms_norm_eps=1e-5,
        tie_word_embeddings=True, attention_bias=False)).eval()
    siglip = transformers.SiglipVisionModel(transformers.SiglipVisionConfig(
        hidden_size=64, intermediate_size=128, num_hidden_layers=2,
        num_attention_heads=4, image_size=28, patch_size=14,
        layer_norm_eps=1e-6, hidden_act="gelu_pytorch_tanh")).eval()
    gemma = transformers.GemmaForCausalLM(transformers.GemmaConfig(
        vocab_size=128, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        head_dim=16, max_position_embeddings=64, rope_theta=10000.0,
        rms_norm_eps=1e-6, tie_word_embeddings=True, attention_bias=False,
        hidden_activation="gelu_pytorch_tanh")).eval()
    pali = transformers.PaliGemmaForConditionalGeneration(
        transformers.PaliGemmaConfig(
            vision_config=dict(hidden_size=48, intermediate_size=96,
                               num_hidden_layers=2, num_attention_heads=4,
                               image_size=28, patch_size=14,
                               hidden_act="gelu_pytorch_tanh"),
            text_config=dict(vocab_size=260, hidden_size=64,
                             intermediate_size=128, num_hidden_layers=2,
                             num_attention_heads=4, num_key_value_heads=2,
                             head_dim=16, max_position_embeddings=64,
                             rope_theta=10000.0, rms_norm_eps=1e-6,
                             tie_word_embeddings=True, attention_bias=False,
                             hidden_activation="gelu_pytorch_tanh"),
            image_token_index=250, projection_dim=64)).eval()
    # the port's and reference's converters, and their arguments
    return {
        "llama": (llama, "convert_llama_state_dict",
                  dict(num_layers=2, num_heads=4, num_kv_heads=2)),
        "siglip": (siglip, "convert_siglip_state_dict",
                   dict(num_layers=2, num_heads=4)),
        "gemma": (gemma, "convert_gemma_state_dict",
                  dict(num_layers=2, num_heads=4, num_kv_heads=2,
                       head_dim=16)),
        "paligemma": (pali, "convert_paligemma_state_dict",
                      dict(num_layers=2, num_heads=4, num_kv_heads=2,
                           head_dim=16, vision_layers=2, vision_heads=4)),
    }


@pytest.fixture(scope="module")
def hf():
    return _hf_models()


@pytest.mark.parametrize("kind", ["llama", "siglip", "gemma", "paligemma"])
def test_hf_convert_equals_reference(hf, kind):
    model, fn, kw = hf[kind]
    sd = model.state_dict()
    ref = getattr(jhf, fn)(sd, **kw)
    got = getattr(thf, fn)(sd, **kw)
    assert set(got) == set(ref)
    for k in ref:
        assert got[k].dtype == ref[k].dtype
        np.testing.assert_array_equal(got[k], ref[k])


def test_hf_llama_and_gemma_logits(hf):
    """Tiny HF Llama and Gemma, converted and loaded into the port: logits
    within the reference's own tolerances (2e-4 / 2e-3, Gemma 3e-4)."""
    tokens = np.array([[3, 17, 99, 5, 42, 7, 0, 11]], np.int64)
    for kind, port, tol in (
            ("llama", tllm.CausalLM(T.LLMConfig(
                vocab_size=128, hidden_size=64, intermediate_size=128,
                num_layers=2, num_heads=4, num_kv_heads=2,
                max_seq_len=16)), 2e-4),
            ("gemma", tgemma.GemmaLM(T.GemmaConfig(
                vocab_size=128, hidden_size=64, intermediate_size=128,
                num_layers=2, num_heads=4, num_kv_heads=2, head_dim=16,
                max_seq_len=16)), 3e-4)):
        model, fn, kw = hf[kind]
        port.requires_grad_(False)
        flat = getattr(thf, fn)(model.state_dict(), **kw)
        T.load_params(port, flat)
        with torch.no_grad():
            ref = model(torch.from_numpy(tokens)).logits.numpy()
            got, _ = port(port.embed_tokens(torch.from_numpy(tokens)),
                          tllm.KVCache.zeros(port.cfg, 1, device=CPU))
        np.testing.assert_allclose(got.numpy(), ref, atol=tol, rtol=2e-3)


def test_hf_siglip_and_paligemma_logits(hf):
    """Tiny HF SigLIP tower and PaliGemma (prefix-LM prefill): within the
    reference's tolerances (2e-4 / 2e-3, PaliGemma 3e-4)."""
    rng = np.random.default_rng(0)
    img = rng.normal(0, 1, (1, 28, 28, 3)).astype(np.float32)
    model, fn, kw = hf["siglip"]
    tower = tvit.VisionTransformer(T.ViTConfig(
        image_size=28, patch_size=14, hidden_size=64, intermediate_size=128,
        num_layers=2, num_heads=4)).requires_grad_(False)
    T.load_params(tower, getattr(thf, fn)(model.state_dict(), **kw))
    with torch.no_grad():
        ref = model(torch.from_numpy(img.transpose(0, 3, 1, 2))
                    ).last_hidden_state.numpy()
    np.testing.assert_allclose(tower(torch.from_numpy(img)).numpy(), ref,
                               atol=2e-4, rtol=2e-3)

    model, fn, kw = hf["paligemma"]
    cfg = T.PaliGemmaConfig(
        vision=T.ViTConfig(image_size=28, patch_size=14, hidden_size=48,
                           intermediate_size=96, num_layers=2, num_heads=4),
        text=T.GemmaConfig(vocab_size=260, hidden_size=64,
                           intermediate_size=128, num_layers=2, num_heads=4,
                           num_kv_heads=2, head_dim=16, max_seq_len=16),
        image_token_id=250)
    port = T.build_paligemma(cfg, device=CPU)
    T.load_params(port, getattr(thf, fn)(model.state_dict(), **kw))
    img = rng.normal(0, 0.5, (1, 28, 28, 3)).astype(np.float32)
    tokens = np.array([[250, 250, 250, 250, 2, 17, 42, 9]], np.int64)
    with torch.no_grad():
        ref = model(input_ids=torch.from_numpy(tokens),
                    pixel_values=torch.from_numpy(img.transpose(0, 3, 1, 2))
                    ).logits.numpy()
        got, _ = port(torch.from_numpy(tokens), torch.from_numpy(img),
                      tllm.KVCache.zeros(cfg.text, 1, device=CPU))
    np.testing.assert_allclose(got.numpy(), ref, atol=3e-4, rtol=2e-3)
