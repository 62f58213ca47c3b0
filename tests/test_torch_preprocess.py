"""The port's fused preprocessing (kornia_tpu_torch/ops/preprocess.py,
ops/yuv.py) against the JAX package.

The port's ``resize_normalize_to_tensor`` runs in float32 through the fused
kernel's arithmetic; the reference's runs two bf16 passes and is itself
within one u8 LSB of exact (1/255/std ≈ 0.0175 normalised), the corridor
its own test allows (tests/test_pallas_kernels.py:32-36): atol 0.02. Against
the reference's one-program kernel, ``fused_preprocess_pallas`` in
interpret mode, the port is held to 1e-5."""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from kornia_tpu.ops import pallas_kernels as pk
from kornia_tpu.ops import preprocess as jpp
from kornia_tpu.ops import resize as jres
from kornia_tpu.ops import yuv as jyuv

from kornia_tpu_torch import convert
from kornia_tpu_torch.ops import cuda_kernels as ck
from kornia_tpu_torch.ops import preprocess as tpp
from kornia_tpu_torch.ops import yuv as tyuv

# One intra-op thread: these tests run many small ops, and torch's pool
# of a thread per core spins against the other test processes.
torch.set_num_threads(1)

tensor = functools.partial(convert.tensor, device="cpu")

MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)


def _img(seed, shape):
    return np.random.default_rng(seed).integers(0, 256, shape, np.uint8)


def _cfgs(**kw):
    cfg = jpp.PreprocessorConfig(**kw)
    return cfg, convert.preprocessor_config(dataclasses.asdict(cfg))


@pytest.mark.parametrize("kw", [
    dict(out_size=(64, 64), normalize=jpp.NormalizeMode.MEAN_STD, mean=MEAN,
         std=STD),
    dict(out_size=(48, 80)),
    dict(out_size=(64, 64), resize_mode=jpp.ResizeMode.LETTERBOX),
    dict(out_size=(64, 64), resize_mode=jpp.ResizeMode.LETTERBOX,
         normalize=jpp.NormalizeMode.MEAN_STD, mean=MEAN, std=STD),
    dict(out_size=(70, 40), resize_mode=jpp.ResizeMode.LETTERBOX,
         normalize=jpp.NormalizeMode.MEAN_STD, mean=MEAN, std=STD,
         bgr_output=True, pad_value=0.25),
    dict(out_size=(150, 200), bgr_output=True),       # upsampling
], ids=["stretch-meanstd", "stretch-unit", "letterbox-unit",
        "letterbox-meanstd", "letterbox-tall-bgr", "upsample-bgr"])
def test_resize_normalize_to_tensor_within_the_reference_corridor(kw):
    img = _img(60, (96, 128, 3))
    cfg, tcfg = _cfgs(**kw)
    want = np.asarray(jpp.resize_normalize_to_tensor(jnp.asarray(img), cfg))
    got = tpp.resize_normalize_to_tensor(img, tcfg, device="cpu")
    assert got.dtype == torch.float32
    assert got.shape == want.shape == (1, 3) + tuple(cfg.out_size)
    # the reference's own corridor for its two bf16 passes
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=0.02)
    if cfg.resize_mode is jpp.ResizeMode.LETTERBOX:
        # the pad canvas takes no part in the bf16 passes: it is equal to
        # float32 rounding of (pad - mean)/std
        pad = np.abs(got.numpy() - want) < 1e-6
        assert pad[0, :, 0, 0].all() or pad[0, :, -1, -1].all()


def test_stretch_matches_the_one_program_kernel_tightly():
    """Stretch + MEAN_STD is exactly what fused_preprocess_pallas computes:
    atol 1e-5 (summation order and FMA of two-term products)."""
    img = _img(61, (96, 128, 3))
    _, tcfg = _cfgs(out_size=(64, 64), normalize=jpp.NormalizeMode.MEAN_STD,
                    mean=MEAN, std=STD)
    want = np.asarray(pk.fused_preprocess_pallas(jnp.asarray(img), 64, 64,
                                                 MEAN, STD))
    got = tpp.resize_normalize_to_tensor(img, tcfg, device="cpu")[0]
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def test_unit_scale_identity_size_is_x_over_255():
    img = _img(62, (40, 56, 3))
    got = tpp.Preprocessor(tpp.PreprocessorConfig(out_size=(40, 56)),
                           device="cpu")(img)
    np.testing.assert_allclose(got[0].numpy(),
                               img.transpose(2, 0, 1) / 255.0, atol=1e-6)


@pytest.mark.parametrize("interp", ["bilinear", "bicubic", "lanczos",
                                    "area"])
def test_other_interpolations_match_the_dense_route(interp, record_property):
    """Every ``_resize_matrix`` mode: bilinear through the fused kernel,
    the others through the reference's dense route (two band products,
    then the normalisation). Held to the JAX preprocess at this file's
    corridor, atol 0.02, with unit scaling, where that is about 5 u8 LSB
    (the reference's two bf16 passes are up to ~2.4 LSB from exact for
    bicubic and lanczos); the mean/std letterbox, where 1 LSB is
    0.02 normalised, against the same products in float64 at 1e-5."""
    img = _img(63, (96, 128, 3))
    for kw in (dict(out_size=(64, 64)), dict(out_size=(150, 200))):
        cfg, tcfg = _cfgs(interp=interp, **kw)
        want = np.asarray(jpp.resize_normalize_to_tensor(jnp.asarray(img),
                                                         cfg))
        got = tpp.resize_normalize_to_tensor(img, tcfg, device="cpu")
        assert got.shape == want.shape
        record_property(f"max_abs_err_{kw['out_size']}",
                        float(np.abs(got.numpy() - want).max()))
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=0.02)
    cfg, tcfg = _cfgs(out_size=(64, 48), interp=interp,
                      resize_mode=jpp.ResizeMode.LETTERBOX,
                      normalize=jpp.NormalizeMode.MEAN_STD, mean=MEAN,
                      std=STD, bgr_output=True)
    got = tpp.resize_normalize_to_tensor(img, tcfg, device="cpu")[0]
    rh, rw, top = 36, 48, 14          # 96×128 fitted into 64×48, centred
    wy = jres._resize_matrix(96, rh, interp, False).astype(np.float64)
    wx = jres._resize_matrix(128, rw, interp, False).astype(np.float64)
    exact = np.einsum("oh,hwc,pw->cop", wy, img.astype(np.float64), wx)
    exact = ((exact / 255.0 - np.asarray(MEAN)[:, None, None])
             / np.asarray(STD)[:, None, None])[::-1]
    np.testing.assert_allclose(got.numpy()[:, top: top + rh, :], exact,
                               rtol=0, atol=1e-5)


def test_preprocess_nv12_and_rgb_from_nv12():
    """NV12 → RGB is float32 multiply-adds rounded to u8: at most 1 LSB on
    at most 0.1% of values where XLA contracts an FMA at an exact .5
    (measured 0); then the preprocess corridor. Both UV layouts."""
    rng = np.random.default_rng(64)
    y = rng.integers(0, 256, (48, 64), np.uint8)
    uv = rng.integers(0, 256, (24, 32, 2), np.uint8)
    want = np.asarray(jyuv.rgb_from_nv12(jnp.asarray(y), jnp.asarray(uv)))
    got = tyuv.rgb_from_nv12(tensor(y), tensor(uv)).numpy()
    d = np.abs(got.astype(int) - want.astype(int))
    assert got.dtype == np.uint8 and d.max() <= 1 and (d > 0).mean() <= 1e-3
    packed = tyuv.rgb_from_nv12(tensor(y),
                                tensor(uv.reshape(24, 64)))
    np.testing.assert_array_equal(packed.numpy(), got)
    cfg, tcfg = _cfgs(out_size=(32, 32))
    want_t = np.asarray(jpp.preprocess_nv12(jnp.asarray(y), jnp.asarray(uv),
                                            cfg))
    got_t = tpp.preprocess_nv12(y, uv, tcfg, device="cpu")
    np.testing.assert_allclose(got_t.numpy(), want_t, rtol=0, atol=0.01)


def test_preprocessor_config_conversion():
    cfg, tcfg = _cfgs(out_size=(64, 48),
                      resize_mode=jpp.ResizeMode.LETTERBOX,
                      normalize=jpp.NormalizeMode.MEAN_STD, mean=MEAN,
                      std=STD, bgr_output=True)
    assert tcfg.resize_mode is tpp.ResizeMode.LETTERBOX
    assert tcfg.normalize is tpp.NormalizeMode.MEAN_STD
    assert tcfg.out_size == (64, 48) and tcfg.mean == MEAN
    assert tcfg.pad_value == cfg.pad_value and tcfg.bgr_output
    by_value = convert.preprocessor_config(
        dict(out_size=np.array([8, 9]), resize_mode="stretch",
             normalize="unit_scale"))
    assert by_value == tpp.PreprocessorConfig(out_size=(8, 9))
    with pytest.raises(ValueError, match="unknown fields"):
        convert.preprocessor_config(dict(out_size=(8, 8), jit=True))


def test_preprocess_counts_no_cpu_launch():
    ck.reset_launch_counts()
    tpp.resize_normalize_to_tensor(
        _img(65, (20, 30, 3)), tpp.PreprocessorConfig(out_size=(8, 8)),
        device="cpu")
    assert ck.LAUNCHES["preprocess"] == 0


def test_preprocess_default_device_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CUDA entry point runs")
    cfg = tpp.PreprocessorConfig(out_size=(8, 8))
    img = _img(66, (16, 16, 3))
    for call in (lambda: tpp.resize_normalize_to_tensor(img, cfg),
                 lambda: tpp.Preprocessor(cfg)(img),
                 lambda: tpp.preprocess_nv12(img[..., 0], img[:8, :8, :2],
                                             cfg)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
