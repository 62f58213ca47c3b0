"""The rest of the port's filters, resize modes, video formats, pyramids and
responses (kornia_tpu_torch/ops/{filters,resize,yuv,pyramid}.py,
features/responses.py) against the JAX package on the same numpy-seeded
inputs, the reference run as its own tests run it (XLA on the CPU), the
port with ``device="cpu"``.

Exact where the reference is: the shift-add filters, the median networks,
nearest resize, the weight matrices, the video formats. Tolerances, each
beside its case with the value measured here: the band-matrix products of
resize sum in another order than XLA's gemm, so u8 may differ by one LSB
after rounding (ROADMAP queue 3, "Pyramid ±1 LSB"); ``exp`` and ``sqrt``
can differ by one ULP (bilateral, Shi-Tomasi)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from kornia_tpu.features import responses as jresp
from kornia_tpu.ops import filters as jfilt
from kornia_tpu.ops import pyramid as jpyr
from kornia_tpu.ops import resize as jres
from kornia_tpu.ops import yuv as jyuv

from kornia_tpu_torch.features import responses as tresp
from kornia_tpu_torch.ops import filters as tfilt
from kornia_tpu_torch.ops import pyramid as tpyr
from kornia_tpu_torch.ops import resize as tres
from kornia_tpu_torch.ops import yuv as tyuv

# One intra-op thread: these tests run many small ops, and torch's pool
# of a thread per core spins against the other test processes.
torch.set_num_threads(1)

CPU = {"device": "cpu"}


def _textured(seed, shape):
    rng = np.random.default_rng(seed)
    h, w = shape[:2]
    base = rng.integers(0, 256, (h // 4 + 1, w // 4 + 1) + shape[2:]
                        ).astype(np.float32)
    up = np.kron(base, np.ones((4, 4) + (1,) * (len(shape) - 2)))[:h, :w]
    return np.clip(up + rng.normal(0, 8, up.shape), 0, 255).astype(np.uint8)


RGB = _textured(21, (96, 128, 3))
GRAY = _textured(22, (96, 128))
IMGS = {"rgb-u8": RGB, "rgb-f32": RGB.astype(np.float32) / 255.0,
        "gray-u8": GRAY}


def _diff(ref, got):
    ref = np.asarray(ref)
    got = got.numpy()
    assert got.shape == ref.shape and got.dtype == ref.dtype, \
        (got.shape, got.dtype, ref.shape, ref.dtype)
    return np.abs(got.astype(np.float64) - ref.astype(np.float64))


def _equal(ref, got):
    if isinstance(got, (tuple, list)):
        for r, g in zip(ref, got):
            _equal(r, g)
        return
    assert _diff(ref, got).max() == 0


# --------------------------------------------------------------------------
# filters
# --------------------------------------------------------------------------


@pytest.mark.parametrize("kind", list(IMGS))
@pytest.mark.parametrize("case", ["box", "box-replicate", "gradient",
                                  "laplacian", "filter2d", "median3",
                                  "median5"])
def test_filters_equal(case, kind):
    x = IMGS[kind]
    k = np.random.default_rng(23).normal(size=(3, 5)).astype(np.float32)
    ref, got = {
        "box": lambda: (jfilt.box_blur(jnp.asarray(x), (5, 3)),
                        tfilt.box_blur(x, (5, 3), **CPU)),
        "box-replicate": lambda: (
            jfilt.box_blur(jnp.asarray(x), (4, 4), "replicate"),
            tfilt.box_blur(x, (4, 4), "replicate", **CPU)),
        "gradient": lambda: (jfilt.spatial_gradient(jnp.asarray(x)),
                             tfilt.spatial_gradient(x, **CPU)),
        "laplacian": lambda: (jfilt.laplacian(jnp.asarray(x)),
                              tfilt.laplacian(x, **CPU)),
        "filter2d": lambda: (jfilt.filter2d(jnp.asarray(x), jnp.asarray(k)),
                             tfilt.filter2d(x, k, **CPU)),
        "median3": lambda: (jfilt.median_blur(jnp.asarray(x), 3),
                            tfilt.median_blur(x, 3, **CPU)),
        "median5": lambda: (jfilt.median_blur(jnp.asarray(x), 5),
                            tfilt.median_blur(x, 5, **CPU)),
    }[case]()
    _equal(ref, got)


def test_median_blur_row_chunks(monkeypatch):
    """A median over more patch elements than one chunk holds is computed
    in row chunks with the same result."""
    monkeypatch.setattr(tfilt, "_PATCH_ELEMS", 5000)
    _equal(jfilt.median_blur(jnp.asarray(RGB), 5),
           tfilt.median_blur(RGB, 5, **CPU))


@pytest.mark.parametrize("kind", list(IMGS))
@pytest.mark.parametrize("d,sc,ss", [(5, 30.0, 3.0), (0, 20.0, 2.0)])
def test_bilateral_blur(kind, d, sc, ss, record_property, monkeypatch):
    """exp of one float32 argument can differ by one ULP: float32 within
    1e-6 (measured 3.6e-7), u8 at most 1 LSB on at most 0.1% of pixels
    (measured 1 of 36,864). Row chunks forced small."""
    monkeypatch.setattr(tfilt, "_PATCH_ELEMS", 20000)
    x = IMGS[kind]
    if kind.endswith("f32"):
        sc = sc / 255.0
    d_ = _diff(jfilt.bilateral_blur(jnp.asarray(x), d, sc, ss),
               tfilt.bilateral_blur(x, d, sc, ss, **CPU))
    record_property("max_abs_err", float(d_.max()))
    if kind.endswith("f32"):
        assert d_.max() <= 1e-6
    else:
        assert d_.max() <= 1 and (d_ > 0).mean() <= 1e-3


# --------------------------------------------------------------------------
# resize
# --------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["bilinear", "bicubic", "lanczos", "area"])
@pytest.mark.parametrize("antialias", [False, True])
def test_resize_matrices_equal(mode, antialias):
    for n_in, n_out in ((10, 7), (31, 64), (200, 320), (640, 224),
                        (17, 17)):
        np.testing.assert_array_equal(
            tres._resize_matrix(n_in, n_out, mode, antialias),
            jres._resize_matrix(n_in, n_out, mode, antialias))


@pytest.mark.parametrize("mode", ["nearest", "bilinear", "bicubic",
                                  "lanczos", "area"])
@pytest.mark.parametrize("antialias", [False, True])
@pytest.mark.parametrize("size", [(100, 130), (500, 700)],
                         ids=["down", "up"])
def test_resize_u8(mode, antialias, size, record_property):
    """u8, down- and upscale: nearest exact; the band products at most 1
    LSB on at most 0.1% of pixels (measured ≤ 9 of 39,000 down, 0 up)."""
    src = _textured(24, (240, 320, 3))
    d = _diff(jres.resize(jnp.asarray(src), size, mode, antialias),
              tres.resize(torch.from_numpy(src), size, mode, antialias))
    record_property("pixels_off", int((d > 0).sum()))
    if mode == "nearest":
        assert d.max() == 0
    else:
        assert d.max() <= 1 and (d > 0).mean() <= 1e-3


@pytest.mark.parametrize("dtype", ["f32", "u16", "gray"])
def test_resize_other_dtypes(dtype, record_property):
    """float32 within 1e-6 relative of the output range (measured 2.1e-7);
    u16 and 2-D u8 at most 1 LSB on at most 0.2% (measured 43 of 39,000
    u16 values)."""
    src = _textured(25, (240, 320, 3))
    if dtype == "f32":
        src = src.astype(np.float32)
    elif dtype == "u16":
        src = src.astype(np.uint16) * 200
    else:
        src = src[..., 0]
    d = _diff(jres.resize(jnp.asarray(src), (100, 130), "lanczos"),
              tres.resize(torch.from_numpy(src), (100, 130), "lanczos"))
    record_property("max_abs_err", float(d.max()))
    if dtype == "f32":
        assert d.max() <= 1e-6 * 255
    else:
        assert d.max() <= 1 and (d > 0).mean() <= 2e-3


def test_resize_fast_is_an_entry_point():
    src = _textured(26, (120, 160, 3))
    d = _diff(jres.resize_fast(jnp.asarray(src), (77, 99), "area"),
              tres.resize_fast(src, (77, 99), "area", **CPU))
    assert d.max() <= 1 and (d > 0).mean() <= 1e-3


@pytest.mark.parametrize("factor,src", [(1.2, "rgb"), (1.3, "gray")])
def test_scale_pyramid_chains_levels(factor, src):
    """Level i from level i−1 at round(dim / factor^i); the levels are
    held with the resize bound above, and each level equals the port's
    resize of the reference's previous level (the chain, not level 0)."""
    img = _textured(27, (240, 320, 3)) if src == "rgb" else GRAY
    ref = jpyr.scale_pyramid(jnp.asarray(img), 5, factor)
    got = tpyr.scale_pyramid(img, 5, factor, **CPU)
    assert len(got) == 5
    for lv_r, lv_g in zip(ref, got):
        d = _diff(lv_r, lv_g)
        assert d.max() <= 1 and (d > 0).mean() <= 2e-3
    for prev, lv_r in zip(ref[:-1], ref[1:]):
        step = tres.resize(torch.from_numpy(np.array(prev)),
                           lv_r.shape[:2])
        d = _diff(lv_r, step)
        assert d.max() <= 1 and (d > 0).mean() <= 2e-3


# --------------------------------------------------------------------------
# video formats
# --------------------------------------------------------------------------

_Y = np.random.default_rng(28).integers(0, 256, (48, 64), np.uint8)
_UV = np.random.default_rng(29).integers(0, 256, (24, 32, 2), np.uint8)
_422 = np.random.default_rng(30).integers(0, 256, (48, 128), np.uint8)


@pytest.mark.parametrize("fmt", ["nv21", "nv21-packed", "i420", "yv12",
                                 "yuyv", "uyvy", "yvyu"])
def test_yuv_to_rgb_exact(fmt):
    u, v = _UV[..., 0].copy(), _UV[..., 1].copy()
    ref, got = {
        "nv21": lambda: (jyuv.rgb_from_nv21(jnp.asarray(_Y), jnp.asarray(_UV)),
                         tyuv.rgb_from_nv21(_Y, _UV, **CPU)),
        "nv21-packed": lambda: (
            jyuv.rgb_from_nv21(jnp.asarray(_Y),
                               jnp.asarray(_UV.reshape(24, 64))),
            tyuv.rgb_from_nv21(_Y, _UV.reshape(24, 64), **CPU)),
        "i420": lambda: (jyuv.rgb_from_i420(jnp.asarray(_Y), jnp.asarray(u),
                                            jnp.asarray(v)),
                         tyuv.rgb_from_i420(_Y, u, v, **CPU)),
        "yv12": lambda: (jyuv.rgb_from_yv12(jnp.asarray(_Y), jnp.asarray(v),
                                            jnp.asarray(u)),
                         tyuv.rgb_from_yv12(_Y, v, u, **CPU)),
        "yuyv": lambda: (jyuv.rgb_from_yuyv(jnp.asarray(_422)),
                         tyuv.rgb_from_yuyv(_422, **CPU)),
        "uyvy": lambda: (jyuv.rgb_from_uyvy(jnp.asarray(_422)),
                         tyuv.rgb_from_uyvy(_422, **CPU)),
        "yvyu": lambda: (jyuv.rgb_from_yvyu(jnp.asarray(_422)),
                         tyuv.rgb_from_yvyu(_422, **CPU)),
    }[fmt]()
    _equal(ref, got)


def test_nv12_from_rgb_exact_and_round_trip():
    _equal(jyuv.nv12_from_rgb(jnp.asarray(RGB)),
           tyuv.nv12_from_rgb(RGB, **CPU))
    y, uv = tyuv.nv12_from_rgb(RGB, **CPU)
    back = tyuv.rgb_from_nv12(y, uv).numpy().astype(int)
    # 4:2:0 chroma and limited range: a smooth round trip, not exact
    assert np.abs(back - RGB.astype(int)).mean() < 20


# --------------------------------------------------------------------------
# responses
# --------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["harris-box", "harris-box-central",
                                  "hessian", "dog", "dog-wide"])
def test_responses_equal(case):
    gf = GRAY.astype(np.float32)
    ref, got = {
        "harris-box": lambda: (
            jresp.harris_response(jnp.asarray(gf), window="box"),
            tresp.harris_response(torch.from_numpy(gf), window="box")),
        "harris-box-central": lambda: (
            jresp.harris_response(jnp.asarray(gf), block_size=3,
                                  window="box", grad="central"),
            tresp.harris_response(torch.from_numpy(gf), block_size=3,
                                  window="box", grad="central")),
        "hessian": lambda: (jresp.hessian_response(jnp.asarray(GRAY)),
                            tresp.hessian_response(GRAY, **CPU)),
        "dog": lambda: (jresp.dog_response(jnp.asarray(GRAY)),
                        tresp.dog_response(GRAY, **CPU)),
        "dog-wide": lambda: (jresp.dog_response(jnp.asarray(GRAY), 1.5, 3.0,
                                                13),
                             tresp.dog_response(GRAY, 1.5, 3.0, 13, **CPU)),
    }[case]()
    _equal(ref, got)


def test_shi_tomasi_response(record_property):
    """sqrt of one float32 value can differ by one ULP (ATen's CPU sqrt is
    not always correctly rounded): 1e-6 of the response's range (measured
    5.6e-8)."""
    ref = np.asarray(jresp.shi_tomasi_response(jnp.asarray(GRAY)))
    d = _diff(ref, tresp.shi_tomasi_response(GRAY, **CPU))
    record_property("rel_err", float(d.max() / np.abs(ref).max()))
    assert d.max() <= 1e-6 * np.abs(ref).max()
