"""The port's model zoo (kornia_tpu_torch/models/) against the JAX
package's on the CPU, on the tiny configurations of tests/test_models.py.

The reference's flax params are carried across by name
(``models.load_params`` / ``convert.model_params``), so both packages run
the same weights. Tolerances, each stated where it is checked, with the
value measured on the CPU beside it:

- exact: the pixel shuffle, the image-token splice, ``build_prompt_tokens``,
  ``VideoSample``, npz files both ways, greedy
  and seam-fed sampled tokens, ``n_generated`` and the stream;
- ``_rope`` 1e-6 (measured 4.8e-7), RMSNorm and GemmaRMSNorm 1e-6
  relative (1.9e-6 at |y| ≈ 10: the float32 mean's summation order;
  RMSNorm in bfloat16 exact, a bfloat16 decoder's logits 2^-5 of the
  largest, measured 2^-6), the
  ViT 1e-5 (2.4e-6), the decoders and whole models 1e-4 (4.9e-6; their
  logits are O(1)); LayerNorm against flax's fast variance as its test
  says;
- the processor within one u8 LSB of the resize, scaled by 1/127.5 (the
  pyramid rule of ROADMAP queue 3: two float32 summation orders of the
  band matmul round to u8 one apart);
- ``hf_convert`` is held in tests/test_torch_models_hf.py.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import flax.traverse_util as tu

from kornia_tpu import models as J
from kornia_tpu.models import gemma as jgemma
from kornia_tpu.models import llm as jllm

from kornia_tpu_torch import convert
from kornia_tpu_torch import models as T
from kornia_tpu_torch.models import gemma as tgemma
from kornia_tpu_torch.models import llm as tllm
from kornia_tpu_torch.models import vit as tvit
from kornia_tpu_torch.models import vlm as tvlm

torch.set_num_threads(1)

CPU = "cpu"
LOGIT_TOL = 1e-4
VIT_TOL = 1e-5


def _vlm_cfgs(pkg):
    return pkg.VLMConfig(
        vision=pkg.ViTConfig(image_size=56, patch_size=14, hidden_size=32,
                             intermediate_size=64, num_layers=2,
                             num_heads=2),
        text=pkg.LLMConfig(vocab_size=128, hidden_size=48,
                           intermediate_size=96, num_layers=2, num_heads=4,
                           num_kv_heads=2, max_seq_len=64),
        pixel_shuffle_factor=2, image_token_id=100)


def _pali_cfgs(pkg, gemma_cfg):
    return pkg.PaliGemmaConfig(
        vision=pkg.ViTConfig(image_size=28, patch_size=14, hidden_size=32,
                             intermediate_size=64, num_layers=2,
                             num_heads=2),
        text=gemma_cfg(vocab_size=64, hidden_size=32, intermediate_size=64,
                       num_layers=2, num_heads=2, num_kv_heads=1,
                       head_dim=16, max_seq_len=32),
        image_token_id=60)


def _flat(params):
    return {k: np.asarray(v)
            for k, v in tu.flatten_dict(params, sep="/").items()}


def _jit_build(model):
    """The reference's build_vlm / build_paligemma (seed 0), its init
    jitted: one compile instead of op-by-op eager dispatch."""
    cfg = model.cfg
    s = cfg.vision.image_size
    params = jax.jit(model.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32),
        jnp.zeros((1, s, s, 3)), jllm.KVCache.zeros(cfg.text, 1))
    return model, params


@pytest.fixture(scope="module")
def smol():
    """(reference model, params, flat params, port model) of the tiny
    SmolVLM, the port's weights loaded from the reference's."""
    model, params = _jit_build(J.SmolVLM(_vlm_cfgs(J)))
    flat = _flat(params)
    port = T.build_vlm(_vlm_cfgs(T), seed=1, device=CPU)
    T.load_params(port, flat)
    return model, params, flat, port


@pytest.fixture(scope="module")
def pali():
    model, params = _jit_build(J.PaliGemma(_pali_cfgs(J, J.GemmaConfig)))
    flat = _flat(params)
    port = T.build_paligemma(_pali_cfgs(T, T.GemmaConfig), seed=1,
                             device=CPU)
    T.load_params(port, flat)
    return model, params, flat, port


def _prompt(cfg, rng, b, n_text=3):
    rows = [[1] + [cfg.image_token_id] * cfg.tokens_per_image
            + rng.integers(3, 60, n_text).tolist() for _ in range(b)]
    return np.asarray(rows, np.int32)


def _images(cfg, rng, b):
    s = cfg.vision.image_size
    return rng.standard_normal((b, s, s, 3)).astype(np.float32)


def _err(a, b):
    return float(np.abs(np.asarray(a, np.float64)
                        - np.asarray(b, np.float64)).max())


# --------------------------------------------------------------------------
# building blocks
# --------------------------------------------------------------------------


@pytest.mark.parametrize("d,start", [(12, 0), (64, 0), (64, 8000),
                                     (256, 1000)])
def test_rope_matches_reference(d, start):
    """Halves rotated, float32 angles at start + arange(T): within 1e-6
    (measured 4.8e-7)."""
    rng = np.random.default_rng(d + start)
    x = rng.standard_normal((2, 7, 3, d)).astype(np.float32)
    pos = np.arange(start, start + 7)
    ref = np.asarray(jllm._rope(jnp.asarray(x), jnp.asarray(pos), 10000.0))
    got = tllm._rope(torch.from_numpy(x), torch.from_numpy(pos), 10000.0)
    assert _err(ref, got) <= 1e-6


def test_rms_norms_match_reference():
    """llm's RMSNorm and Gemma's (1 + w) form, within 1e-6 relative of
    the reference (measured 1.9e-6 absolute at |y| ≈ 10: the float32
    mean's summation order)."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 48)).astype(np.float32) * 3
    w = rng.standard_normal(48).astype(np.float32)
    ref = np.asarray(jllm._rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5))
    port = tllm.RMSNorm(48, 1e-5, torch.float32)
    port.weight.data = torch.from_numpy(w)
    assert _err(ref, port(torch.from_numpy(x)).detach()) <= \
        1e-6 * np.abs(ref).max()
    gref = np.asarray(jgemma.GemmaRMSNorm(1e-6).apply(
        {"params": {"weight": jnp.asarray(w)}}, jnp.asarray(x)))
    gport = tgemma.GemmaRMSNorm(48, 1e-6, torch.float32)
    gport.weight.data = torch.from_numpy(w)
    assert _err(gref, gport(torch.from_numpy(x)).detach()) <= \
        1e-6 * np.abs(gref).max()


def test_rms_norm_bfloat16_exact():
    """In bfloat16 the port's RMSNorm rounds as the reference's does (the
    product by the rounded reciprocal, then by the weight): exact
    (measured 0; ``F.rms_norm``, which rounds once, differs by one ULP on
    a third of the values, so the port keeps it for float32 only)."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((4, 7, 48)).astype(np.float32) * 3
    w = rng.standard_normal(48).astype(np.float32)
    ref = jllm._rms_norm(jnp.asarray(x, jnp.bfloat16),
                         jnp.asarray(w, jnp.bfloat16), 1e-5)
    port = tllm.RMSNorm(48, 1e-5, torch.bfloat16)
    port.weight.data = torch.from_numpy(w).to(torch.bfloat16)
    got = port(torch.from_numpy(x).to(torch.bfloat16)).detach()
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(np.asarray(ref.astype(jnp.float32)),
                                  got.float().numpy())


def test_causal_lm_bfloat16_against_reference():
    """A tiny Llama decoder in bfloat16 (the reference's float32 params,
    rounded at use as flax's ``dtype`` does): prefill and three cached
    steps give bfloat16 logits within 2^-5 of the largest |logit| (four
    ULPs at its binade's floor; measured 2^-6: the two libraries round
    the SiLU, attention and residual sums at different points)."""
    kw = dict(vocab_size=128, hidden_size=48, intermediate_size=96,
              num_layers=2, num_heads=4, num_kv_heads=2, max_seq_len=64)
    cfg_j = J.LLMConfig(dtype=jnp.bfloat16, **kw)
    cfg_t = T.LLMConfig(dtype=torch.bfloat16, **kw)
    ref, port = J.CausalLM(cfg_j), tllm.CausalLM(cfg_t)
    cache0 = jllm.KVCache.zeros(cfg_j, 2)
    params = jax.jit(ref.init)(jax.random.PRNGKey(7),
                               jnp.zeros((2, 1, 48), jnp.bfloat16), cache0)
    port.requires_grad_(False)
    T.load_params(port, _flat(params))
    toks = np.random.default_rng(9).integers(0, 128, (2, 13)).astype(
        np.int32)
    apply = jax.jit(ref.apply)
    emb_j = ref.apply(params, jnp.asarray(toks),
                      method=type(ref).embed_tokens)
    cj, ct = cache0, tllm.KVCache.zeros(cfg_t, 2, device=CPU)
    for lo, hi in ((0, 10), (10, 11), (11, 12), (12, 13)):
        lj, cj = apply(params, emb_j[:, lo:hi], cj)
        lt, ct = port(port.embed_tokens(
            torch.from_numpy(toks[:, lo:hi]).long()), ct)
        assert lt.dtype == torch.bfloat16 and ct.k.dtype == torch.bfloat16
        lj = np.asarray(lj.astype(jnp.float32))
        assert _err(lj, lt.float()) <= 2.0 ** -5 * np.abs(lj).max()


@pytest.mark.parametrize("mean", [0.0, 20.0])
def test_layer_norm_against_flax(mean):
    """flax's LayerNorm takes the fast variance E[x²] − E[x]², the port
    F.layer_norm's two-pass one. Centred inputs: within 1e-6 (measured
    4.8e-7). Mean 20, where the fast form cancels: within 1.5× the gap
    between flax's own two forms (3.1e-4), of either (measured 3.1e-4)."""
    import flax.linen as fnn

    rng = np.random.default_rng(1)
    x = (rng.standard_normal((3, 4, 32)) + mean).astype(np.float32)
    p = {"params": {"scale": rng.standard_normal(32).astype(np.float32),
                    "bias": rng.standard_normal(32).astype(np.float32)}}
    ref = np.asarray(fnn.LayerNorm(epsilon=1e-6).apply(p, jnp.asarray(x)))
    two_pass = np.asarray(fnn.LayerNorm(epsilon=1e-6, use_fast_variance=False
                                        ).apply(p, jnp.asarray(x)))
    ln = tvit.LayerNorm(32, 1e-6, torch.float32)
    ln.weight.data = torch.from_numpy(p["params"]["scale"])
    ln.bias.data = torch.from_numpy(p["params"]["bias"])
    got = ln(torch.from_numpy(x)).detach()
    tol = 1e-6 if mean == 0 else _err(ref, two_pass) * 1.5 + 1e-6
    assert _err(ref, got) <= tol
    assert _err(two_pass, got) <= tol


def test_pixel_shuffle_exact(smol):
    model, params, _, port = smol
    x = np.random.default_rng(2).standard_normal((2, 16, 32)).astype(
        np.float32)
    ref = model.apply(params, jnp.asarray(x),
                      method=lambda m, v: m._pixel_shuffle(v))
    np.testing.assert_array_equal(
        np.asarray(ref), port._pixel_shuffle(torch.from_numpy(x)).numpy())


def test_image_token_splice_exact(smol):
    """The k-th <image> token of each row takes feature k, in rows where
    the image tokens are scattered, fewer or more than the features."""
    model, params, _, port = smol
    rng = np.random.default_rng(3)
    toks = rng.integers(0, 99, (3, 12)).astype(np.int32)
    toks[0, [1, 4, 5, 9]] = 100
    toks[1, :] = 100                         # more tokens than features
    feats = rng.standard_normal((3, 4, 48)).astype(np.float32)
    ref = model.apply(params, jnp.asarray(toks), jnp.asarray(feats),
                      method=lambda m, t, f: m.embed_multimodal(t, f))
    got = port.embed_multimodal(torch.from_numpy(toks).long(),
                                torch.from_numpy(feats))
    np.testing.assert_array_equal(np.asarray(ref), got.numpy())


def test_vit_matches_reference(smol):
    model, params, _, port = smol
    imgs = _images(model.cfg, np.random.default_rng(4), 2)
    ref = model.apply(params, jnp.asarray(imgs),
                      method=lambda m, x: m.vision(x))
    got = port.vision(torch.from_numpy(imgs))
    assert got.shape == (2, 16, 32)
    assert _err(ref, got) <= VIT_TOL


# --------------------------------------------------------------------------
# the decoders: prefill and cache-fed decode
# --------------------------------------------------------------------------


def _decoder_pair(kind):
    if kind == "llama":
        cfg_j = J.LLMConfig(vocab_size=128, hidden_size=48,
                            intermediate_size=96, num_layers=2, num_heads=4,
                            num_kv_heads=2, max_seq_len=64)
        cfg_t = T.LLMConfig(**{k: getattr(cfg_j, k) for k in (
            "vocab_size", "hidden_size", "intermediate_size", "num_layers",
            "num_heads", "num_kv_heads", "max_seq_len")})
        ref, port = J.CausalLM(cfg_j), tllm.CausalLM(cfg_t)
    else:
        kw = dict(vocab_size=96, hidden_size=32, intermediate_size=64,
                  num_layers=2, num_heads=4, num_kv_heads=1, head_dim=16,
                  max_seq_len=64)
        cfg_j, cfg_t = J.GemmaConfig(**kw), T.GemmaConfig(**kw)
        ref, port = J.GemmaLM(cfg_j), tgemma.GemmaLM(cfg_t)
    cache0 = jllm.KVCache.zeros(cfg_j, 2)
    params = jax.jit(ref.init)(jax.random.PRNGKey(7),
                               jnp.zeros((2, 1, cfg_j.hidden_size)), cache0)
    # the reference's gemma norms start at zero: give them values
    flat = _flat(params)
    rng = np.random.default_rng(8)
    for k in flat:
        if k.endswith("norm/weight"):
            flat[k] = rng.standard_normal(flat[k].shape).astype(np.float32)
    params = tu.unflatten_dict(flat, sep="/")
    port.requires_grad_(False)
    T.load_params(port, flat)
    return ref, params, cache0, port, cfg_t


@pytest.mark.parametrize("kind,prefix", [("llama", None), ("gemma", None),
                                         ("gemma", 6), ("gemma", 10)])
def test_decoder_prefill_and_cached_decode(kind, prefix):
    """Prefill of 10 tokens (Gemma: causal, or bidirectional below
    ``prefix_len``), then 3 single-token steps fed by the cache: logits
    within 1e-4 (measured 4.9e-6) at every step; a second prefill from the
    same cache (written in place by the first) gives the same logits."""
    ref, params, cache0, port, cfg = _decoder_pair(kind)
    rng = np.random.default_rng(9)
    toks = rng.integers(0, cfg.vocab_size, (2, 13)).astype(np.int32)
    apply = jax.jit(ref.apply)
    emb_j = ref.apply(params, jnp.asarray(toks),
                      method=type(ref).embed_tokens)
    kw = {} if prefix is None else {"prefix_len": jnp.int32(prefix)}
    lj, cj = apply(params, emb_j[:, :10], cache0, **kw)
    tcache0 = tllm.KVCache.zeros(cfg, 2, device=CPU)
    emb_t = port.embed_tokens(torch.from_numpy(toks[:, :10]).long())
    tkw = {} if prefix is None else {"prefix_len": prefix}
    lt, ct = port(emb_t, tcache0, **tkw)
    assert ct.length == 10
    assert _err(lj, lt) <= LOGIT_TOL
    lt2, ct = port(emb_t, tcache0, **tkw)          # the same cache again
    np.testing.assert_array_equal(lt.numpy(), lt2.numpy())
    for i in range(10, 13):
        lj, cj = apply(params, emb_j[:, i:i + 1], cj)
        lt, ct = port(port.embed_tokens(
            torch.from_numpy(toks[:, i:i + 1]).long()), ct)
        assert _err(lj, lt) <= LOGIT_TOL
    assert ct.length == int(cj.length) == 13
    np.testing.assert_allclose(ct.k[:, :, :13].numpy(),
                               np.asarray(cj.k)[:, :, :13], atol=1e-5)


def test_causal_and_prefix_masks():
    """Changing the last token leaves causal logits before it unchanged;
    inside a bidirectional prefix it changes them."""
    _, _, _, port, cfg = _decoder_pair("gemma")
    toks = np.arange(8)[None].repeat(2, 0) % cfg.vocab_size
    toks2 = toks.copy()
    toks2[:, -1] += 1

    def run(t, prefix):
        c = tllm.KVCache.zeros(cfg, 2, device=CPU)
        return port(port.embed_tokens(torch.from_numpy(t)), c,
                    prefix_len=prefix)[0]

    a, b = run(toks, None), run(toks2, None)
    assert torch.equal(a[:, :-1], b[:, :-1])
    a, b = run(toks, 8), run(toks2, 8)
    assert float((a[:, 0] - b[:, 0]).abs().max()) > 1e-4


# --------------------------------------------------------------------------
# whole models and generation
# --------------------------------------------------------------------------


@pytest.mark.parametrize("which", ["smol", "pali"])
def test_model_forward_matches_reference(which, smol, pali):
    """SmolVLM and PaliGemma prefill, images spliced: logits within 1e-4
    (measured 3.8e-6)."""
    model, params, _, port = {"smol": smol, "pali": pali}[which]
    rng = np.random.default_rng(10)
    toks, imgs = _prompt(model.cfg, rng, 2), _images(model.cfg, rng, 2)
    lj, _ = jax.jit(model.apply)(params, jnp.asarray(toks),
                                 jnp.asarray(imgs),
                                 jllm.KVCache.zeros(model.cfg.text, 2))
    lt, _ = port(torch.from_numpy(toks).long(), torch.from_numpy(imgs),
                 tllm.KVCache.zeros(port.cfg.text, 2, device=CPU))
    assert _err(lj, lt) <= LOGIT_TOL


def _greedy_eos(model, params, toks, imgs, n):
    """An eos id that greedy decoding emits at step 3, so that the eos
    path (forced eos afterwards, n_generated 2) is exercised."""
    out = np.asarray(J.generate(model, params, toks, imgs,
                                max_new_tokens=n, eos_token_id=-1).tokens)
    return int(out[0, 2])


@pytest.mark.parametrize("which,with_images,early_eos", [
    ("smol", True, False), ("smol", True, True), ("smol", False, False),
    ("pali", True, True)])
def test_generate_greedy_matches_reference(which, with_images, early_eos,
                                           smol, pali):
    """Greedy tokens, n_generated and the stream callback equal the
    reference's, with an eos that stops row 0 early or none."""
    model, params, _, port = {"smol": smol, "pali": pali}[which]
    rng = np.random.default_rng(11)
    toks = _prompt(model.cfg, rng, 2)
    imgs = _images(model.cfg, rng, 2) if with_images else None
    if not with_images:
        toks = toks[:, -4:]
    eos = _greedy_eos(model, params, toks, imgs, 8) if early_eos else 2
    seen_j, seen_t = [], []
    rj = J.generate(model, params, toks, imgs, max_new_tokens=8,
                    eos_token_id=eos, stream_callback=seen_j.append)
    rt = T.generate(port, toks, imgs, max_new_tokens=8, eos_token_id=eos,
                    stream_callback=seen_t.append, device=CPU)
    np.testing.assert_array_equal(np.asarray(rj.tokens), rt.tokens.numpy())
    np.testing.assert_array_equal(np.asarray(rj.n_generated),
                                  rt.n_generated.numpy())
    assert seen_t == seen_j
    if early_eos:
        n = int(rt.n_generated[0])
        assert n <= 2 and bool((rt.tokens[0, n:] == eos).all())


def _reference_gumbel(seed, n, shape):
    """The reference's draws in ``generate``: categorical(key) for the
    first token, then key, sub = split(key) and categorical(sub) a step."""
    key = jax.random.PRNGKey(seed)
    out = [jax.random.gumbel(key, shape, jnp.float32)]
    for _ in range(n - 1):
        key, sub = jax.random.split(key)
        out.append(jax.random.gumbel(sub, shape, jnp.float32))
    return torch.from_numpy(np.array(jnp.stack(out)))


@pytest.mark.parametrize("which", ["smol", "pali"])
def test_generate_sampled_on_reference_draws(which, smol, pali):
    """Temperature 0.8: given the reference's gumbel draws through
    ``gumbel=``, the tokens equal the reference's."""
    model, params, _, port = {"smol": smol, "pali": pali}[which]
    rng = np.random.default_rng(12)
    toks, imgs = _prompt(model.cfg, rng, 2), _images(model.cfg, rng, 2)
    rj = J.generate(model, params, toks, imgs, max_new_tokens=8,
                    eos_token_id=-1, temperature=0.8, seed=5)
    g = _reference_gumbel(5, 8, (2, model.cfg.text.vocab_size))
    rt = T.generate(port, toks, imgs, max_new_tokens=8, eos_token_id=-1,
                    temperature=0.8, gumbel=g, device=CPU)
    np.testing.assert_array_equal(np.asarray(rj.tokens), rt.tokens.numpy())


def test_generate_own_draws_are_seeded(smol):
    """The port's own draws come from a generator seeded with ``seed``:
    one seed gives one answer, and the draws differ from greedy."""
    port = smol[3]
    rng = np.random.default_rng(13)
    toks, imgs = _prompt(port.cfg, rng, 1), _images(port.cfg, rng, 1)
    run = functools.partial(T.generate, port, toks, imgs, max_new_tokens=12,
                            eos_token_id=-1, temperature=5.0, device=CPU)
    a, b, c = run(seed=3), run(seed=3), run(seed=4)
    assert torch.equal(a.tokens, b.tokens)
    assert not torch.equal(a.tokens, c.tokens)


def test_generate_defaults_to_the_card(smol):
    """``generate`` and the build functions default to device="cuda":
    without a card they raise, and a model on another device than
    ``device`` is refused (no silent CPU route)."""
    port = smol[3]
    toks = np.asarray([[1, 5, 6]], np.int32)
    with pytest.raises((RuntimeError, ValueError)):
        T.generate(port, toks)
    with pytest.raises(ValueError, match="max_seq_len"):      # 3 + 62 > 64
        T.generate(port, toks, max_new_tokens=63, device=CPU)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            T.build_vlm(_vlm_cfgs(T))
        with pytest.raises(RuntimeError, match="CUDA"):
            T.preprocess_image(np.zeros((8, 8, 3), np.uint8), 4)


# --------------------------------------------------------------------------
# parameters across the packages
# --------------------------------------------------------------------------


@pytest.mark.parametrize("which", ["smol", "pali"])
def test_npz_files_load_both_ways(which, smol, pali, tmp_path):
    """A file written by either package loads into the other with every
    array equal; the port's flax view of its weights is the reference's."""
    model, params, flat, port = {"smol": smol, "pali": pali}[which]
    mine = tvlm.flax_params(port)
    assert set(mine) == set(flat)
    for k in flat:
        np.testing.assert_array_equal(mine[k], flat[k])
    p_ref, p_port = str(tmp_path / "ref.npz"), str(tmp_path / "port.npz")
    J.save_params_npz(p_ref, params)
    T.save_params_npz(p_port, port)
    fresh = (T.build_vlm(_vlm_cfgs(T), seed=9, device=CPU) if which == "smol"
             else T.build_paligemma(_pali_cfgs(T, T.GemmaConfig), seed=9,
                                    device=CPU))
    T.load_params_npz(p_ref, fresh)
    for k, v in tvlm.flax_params(fresh).items():
        np.testing.assert_array_equal(v, flat[k])
    back = _flat(J.load_params_npz(p_port, params))
    for k in flat:
        np.testing.assert_array_equal(back[k], flat[k])


def test_model_params_feeds_load_state_dict(smol):
    """``convert.model_params`` gives the port's names and layouts: a
    strict ``load_state_dict`` of a fresh model equals ``load_params``."""
    _, _, flat, port = smol
    fresh = T.build_vlm(_vlm_cfgs(T), seed=9, device=CPU)
    sd = convert.model_params(flat)
    fresh.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()},
                          strict=True)
    for (n, a), (_, b) in zip(fresh.named_parameters(),
                              port.named_parameters()):
        assert torch.equal(a, b), n
    assert sd["text.tok_embed.weight"].shape == (128, 48)
    assert sd["vision.patch_embed.weight"].shape == (32, 3, 14, 14)
    assert sd["vision.block_0.attn.qkv.weight"].shape == (96, 32)
    assert sd["text.layer_1.o.weight"].shape == (48, 48)


def test_load_params_overlay_and_errors(smol):
    port = T.build_vlm(_vlm_cfgs(T), seed=2, device=CPU)
    key = "params/connector/kernel"
    T.load_params(port, {key: np.zeros((128, 48), np.float32)})
    assert float(port.connector.weight.abs().max()) == 0.0
    with pytest.raises(KeyError):
        T.load_params(port, {"bogus/path": np.zeros(3)})
    with pytest.raises(ValueError, match="shape"):
        T.load_params(port, {key: np.zeros((48, 128), np.float32)})


# --------------------------------------------------------------------------
# processor and video
# --------------------------------------------------------------------------

# one u8 LSB of the resize, after (x / 255 − 0.5) / 0.5
PRE_TOL = 1.0 / 127.5 + 1e-6


@pytest.mark.parametrize("shape,size", [((100, 160, 3), 56),
                                        ((61, 47, 3), 64)])
def test_preprocess_image_matches_reference(shape, size):
    img = np.random.default_rng(size).integers(0, 256, shape, np.uint8)
    ref = np.asarray(J.preprocess_image(img, image_size=size))
    got = T.preprocess_image(img, image_size=size, device=CPU)
    assert got.shape == ref.shape == (1, size, size, 3)
    assert got.dtype == torch.float32
    assert _err(ref, got) <= PRE_TOL


def test_split_into_tiles_matches_reference():
    img = np.random.default_rng(1).integers(0, 256, (400, 800, 3), np.uint8)
    ref = J.split_into_tiles(img, tile=56, max_tiles=4)
    got = T.split_into_tiles(img, tile=56, max_tiles=4, device=CPU)
    assert isinstance(got, np.ndarray) and got.dtype == np.uint8
    assert got.shape == ref.shape
    assert np.abs(got.astype(int) - ref.astype(int)).max() <= 1


def test_prompt_tokens_and_frame_sampling_exact():
    for args in (([7, 8], 3, 100), ([], 5, 9), ([1, 2, 3], 0, 4)):
        np.testing.assert_array_equal(T.build_prompt_tokens(*args),
                                      J.build_prompt_tokens(*args))
    for n, k in ((100, 8), (3, 8), (0, 8), (17, 17), (1, 4)):
        np.testing.assert_array_equal(T.sample_video_frames(n, k),
                                      J.sample_video_frames(n, k))


def test_video_sample_semantics():
    """The ring drops the oldest frame past its capacity, processes each
    frame once, and stacks to (N, 3, H, W), as the reference's does."""
    pairs = [(J.VideoSample(capacity=3), T.VideoSample(capacity=3))]
    for jv, tv in pairs:
        for i in range(5):
            f = np.arange(4 * 6 * 3, dtype=np.uint8).reshape(4, 6, 3) + i
            jv.add_frame(f, float(i))
            tv.add_frame(f, float(i))
        calls = []
        tv.process_frames(lambda f: (calls.append(1), f + 1)[1])
        tv.process_frames(lambda f: (calls.append(1), f + 1)[1])
        jv.process_frames(lambda f: f + 1)
        assert len(calls) == 3 and len(tv) == len(jv) == 3
        assert tv.metadata.timestamps == jv.metadata.timestamps == \
            [2.0, 3.0, 4.0]
        for a, b in zip(tv.frames, jv.frames):
            np.testing.assert_array_equal(a, b)
        t = tv.as_tensor(device=CPU)
        assert t.shape == (3, 3, 4, 6) and t.dtype == torch.float32
        np.testing.assert_array_equal(t.numpy(), np.asarray(jv.as_tensor()))
    with pytest.raises(ValueError):
        T.VideoSample(capacity=0)
    with pytest.raises(ValueError):
        T.VideoSample().add_frame(np.zeros((4, 4)), 0.0)


def test_sample_video_reads_a_reference_avi(tmp_path):
    """A clip written by the reference's MjpegWriter, sampled by the port
    through its own MjpegReader and VideoReader: the frames, timestamps,
    fps and duration equal the reference's sampling of the same file;
    ``preprocess_video`` is ``preprocess_image`` frame by frame."""
    from kornia_tpu.io.mjpeg_avi import MjpegWriter as JWriter
    from kornia_tpu_torch.io import MjpegReader, VideoReader

    h, w = 40, 56
    yy, xx = np.mgrid[0:h, 0:w]
    path = str(tmp_path / "clip.avi")
    with JWriter(path, fps=20.0, size_hw=(h, w)) as wtr:
        for i in range(10):
            wtr.write(np.stack([xx * 4, yy * 6, np.full((h, w), 10 * i)],
                               -1).astype(np.uint8))
    from kornia_tpu.io.mjpeg_avi import MjpegReader as JReader
    ref = J.sample_video(JReader(path), n_frames=4)
    for reader in (MjpegReader(path), VideoReader(path)):
        s = T.sample_video(reader, n_frames=4)
        assert len(s) == 4
        assert s.metadata.fps == pytest.approx(ref.metadata.fps)
        assert s.metadata.duration == pytest.approx(ref.metadata.duration)
        assert s.metadata.timestamps == ref.metadata.timestamps
        for a, b in zip(s.frames, ref.frames):
            if isinstance(reader, MjpegReader):      # the same PIL decode
                np.testing.assert_array_equal(a, b)
            else:        # cv2's JPEG decoder: 8 LSB (measured 5)
                assert np.abs(a.astype(int) - b.astype(int)).max() <= 8
    s = T.sample_video(MjpegReader(path), n_frames=4)
    batch = T.preprocess_video(s, image_size=32, device=CPU)
    assert batch.shape == (4, 32, 32, 3)
    assert _err(np.asarray(J.preprocess_video(ref, image_size=32)),
                batch) <= PRE_TOL
    for i, f in enumerate(s.frames):
        one = T.preprocess_image(f, 32, device=CPU)[0]
        assert torch.equal(one, batch[i])


# --------------------------------------------------------------------------
# the full-width presets, by shape
# --------------------------------------------------------------------------


def _reference_shapes(cfg, build):
    cls = J.SmolVLM if build == "vlm" else J.PaliGemma
    model = cls(cfg)
    s = cfg.vision.image_size
    t = cfg.text
    kv = jax.ShapeDtypeStruct(
        (t.num_layers, 1, t.max_seq_len, t.num_kv_heads, t.head_dim),
        jnp.float32)
    cache = jllm.KVCache(k=kv, v=kv,
                         length=jax.ShapeDtypeStruct((), jnp.int32))
    shapes = jax.eval_shape(
        model.init, jax.random.PRNGKey(0),
        jax.ShapeDtypeStruct((1, 8), jnp.int32),
        jax.ShapeDtypeStruct((1, s, s, 3), jnp.float32), cache)
    return {k: tuple(v.shape)
            for k, v in tu.flatten_dict(shapes, sep="/").items()}


@pytest.mark.parametrize("name,tokens,n_params", [
    ("smolvlm_256m", 64, 228_1), ("smolvlm_500m", 64, 460_2),
    ("smolvlm_2_2b", 81, 2145_9), ("paligemma", 256, 2923_5)])
def test_presets_match_reference_shapes(name, tokens, n_params):
    """Every parameter of the full-width presets, by name and shape, as
    the reference's ``init`` makes it (``jax.eval_shape``) against the
    port built on the meta device; the counts (228.1 M, 460.2 M,
    2,145.9 M, 2,923.5 M) and tokens per image."""
    if name == "paligemma":
        cfg_j, cfg_t = J.PaliGemmaConfig(), T.PaliGemmaConfig()
        port = T.build_paligemma(cfg_t, device="meta")
        build = "pali"
    else:
        cfg_j, cfg_t = getattr(J, name)(), getattr(T, name)()
        port = T.build_vlm(cfg_t, device="meta")
        build = "vlm"
    assert cfg_t.tokens_per_image == cfg_j.tokens_per_image == tokens
    ref = _reference_shapes(cfg_j, build)
    assert tvlm.flax_shapes(port) == ref
    count = sum(p.numel() for p in port.parameters())
    assert count == sum(int(np.prod(s)) for s in ref.values())
    assert round(count / 1e5) == n_params
