"""The port's image-processing library against the JAX package: colour
(``ops/color``), normalisation, histograms, enhancement and CLAHE,
thresholds, morphology, Canny, Bayer, the distance transform, metrics,
flips/crops/padding and drawing (kornia_tpu_torch/ops/*.py), on the same
numpy-seeded inputs, the reference run as its own tests run it (XLA on the
CPU), the port with ``device="cpu"``.

Exact wherever the reference is exact: integer and u8 outputs, LUT
lookups, histograms, CLAHE, Bayer, the distance transform, geometry and
drawing. Float outputs that differ carry their tolerance beside the case,
with the reason and the value measured on this test's inputs."""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from kornia_tpu.ops import bayer as jbayer
from kornia_tpu.ops import canny as jcanny
from kornia_tpu.ops import color as jcolor
from kornia_tpu.ops import distance_transform as jdt
from kornia_tpu.ops import draw as jdraw
from kornia_tpu.ops import enhance as jenh
from kornia_tpu.ops import geometry_utils as jgeo
from kornia_tpu.ops import histogram as jhist
from kornia_tpu.ops import metrics as jmet
from kornia_tpu.ops import morphology as jmorph
from kornia_tpu.ops import normalize as jnorm
from kornia_tpu.ops import threshold as jthr

from kornia_tpu_torch.ops import bayer as tbayer
from kornia_tpu_torch.ops import canny as tcanny
from kornia_tpu_torch.ops import color as tcolor
from kornia_tpu_torch.ops import distance_transform as tdt
from kornia_tpu_torch.ops import draw as tdraw
from kornia_tpu_torch.ops import enhance as tenh
from kornia_tpu_torch.ops import geometry_utils as tgeo
from kornia_tpu_torch.ops import histogram as thist
from kornia_tpu_torch.ops import metrics as tmet
from kornia_tpu_torch.ops import morphology as tmorph
from kornia_tpu_torch.ops import normalize as tnorm
from kornia_tpu_torch.ops import threshold as tthr

# One intra-op thread: these tests run many small ops, and torch's pool
# of a thread per core spins against the other test processes.
torch.set_num_threads(1)

CPU = {"device": "cpu"}


def _textured(seed, shape):
    """Blocky noise (4-px cells) plus pixel noise, u8: edges, corners and
    flat patches."""
    rng = np.random.default_rng(seed)
    h, w = shape[:2]
    base = rng.integers(0, 256, (h // 4 + 1, w // 4 + 1) + shape[2:]
                        ).astype(np.float32)
    up = np.kron(base, np.ones((4, 4) + (1,) * (len(shape) - 2)))[:h, :w]
    return np.clip(up + rng.normal(0, 8, up.shape), 0, 255).astype(np.uint8)


RGB = _textured(11, (96, 128, 3))
GRAY = _textured(12, (96, 128))
RGBF = RGB.astype(np.float32) / 255.0
IMGS = {"u8": RGB, "f32": RGBF}


def _check(ref, got, tol=0.0):
    """``got`` (a tensor or tuple of tensors) against the reference: equal
    when ``tol`` is 0, else within ``tol`` (absolute). Returns the largest
    difference."""
    if isinstance(got, (tuple, list)):
        return max(_check(r, g, tol) for r, g in zip(ref, got))
    ref = np.asarray(ref)
    got = got.numpy()
    assert got.shape == ref.shape and got.dtype == ref.dtype, \
        (got.shape, got.dtype, ref.shape, ref.dtype)
    if tol == 0.0:
        np.testing.assert_array_equal(got, ref)
        return 0.0
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol)
    return float(np.abs(got.astype(np.float64) - ref).max())


# --------------------------------------------------------------------------
# colour
# --------------------------------------------------------------------------

# float32 tolerances: torch has no cbrt, so the Lab/Luv cube root is
# pow(|t|, 1/3), a few ULPs from XLA's cbrt, scaled by 116 (L) and 500 /
# 200 (a, b): measured 6.1e-5 (Lab), 7.6e-5 (Luv); through the inverse's
# pow(·, 1/2.4): 1.2e-7. Everything else, and every u8 output, is exact.
_FORWARD_TOL = {("rgb_to_lab", "f32"): 5e-4, ("rgb_to_luv", "f32"): 5e-4}
_INVERSE_TOL = {("lab_to_rgb", "f32"): 1e-6, ("luv_to_rgb", "f32"): 1e-6}


@pytest.mark.parametrize("kind", ["u8", "f32"])
@pytest.mark.parametrize("fn", [
    "rgb_to_gray", "bgr_to_gray", "rgb_to_bgr", "bgr_to_rgb", "rgb_to_rgba",
    "rgba_to_rgb", "rgb_to_hsv", "rgb_to_hls", "rgb_to_xyz", "rgb_to_lab",
    "rgb_to_luv", "rgb_to_yuv", "sepia"])
def test_color_forward(fn, kind, record_property):
    x = IMGS[kind]
    err = _check(getattr(jcolor, fn)(jnp.asarray(x)),
                 getattr(tcolor, fn)(x, **CPU), _FORWARD_TOL.get((fn, kind),
                                                                 0.0))
    record_property("max_abs_err", err)


@pytest.mark.parametrize("kind", ["u8", "f32"])
@pytest.mark.parametrize("fn,fwd", [
    ("hsv_to_rgb", "rgb_to_hsv"), ("hls_to_rgb", "rgb_to_hls"),
    ("lab_to_rgb", "rgb_to_lab"), ("luv_to_rgb", "rgb_to_luv"),
    ("yuv_to_rgb", "rgb_to_yuv"), ("xyz_to_rgb", "rgb_to_xyz")])
def test_color_inverse(fn, fwd, kind, record_property):
    """Each inverse on the reference's own forward output."""
    x = np.asarray(getattr(jcolor, fwd)(jnp.asarray(IMGS[kind])))
    err = _check(getattr(jcolor, fn)(jnp.asarray(x)),
                 getattr(tcolor, fn)(x, **CPU), _INVERSE_TOL.get((fn, kind),
                                                                 0.0))
    record_property("max_abs_err", err)


def test_color_xyz_gamma_options_gray_and_alpha():
    _check(jcolor.rgb_to_xyz(jnp.asarray(RGBF), linear_input=False),
           tcolor.rgb_to_xyz(RGBF, linear_input=False, **CPU), 1e-6)
    xyz = np.asarray(jcolor.rgb_to_xyz(jnp.asarray(RGBF)))
    _check(jcolor.xyz_to_rgb(jnp.asarray(xyz), linear_output=False),
           tcolor.xyz_to_rgb(xyz, linear_output=False, **CPU), 1e-6)
    _check(jcolor.gray_to_rgb(jnp.asarray(GRAY[..., None])),
           tcolor.gray_to_rgb(GRAY[..., None], **CPU).contiguous())
    rgba = np.concatenate([RGB, RGB[..., :1]], -1)
    _check(jcolor.bgra_to_rgba(jnp.asarray(rgba)),
           tcolor.bgra_to_rgba(rgba, **CPU))
    _check(jcolor.rgb_to_rgba(jnp.asarray(RGB), 7),
           tcolor.rgb_to_rgba(RGB, 7, **CPU))


@pytest.mark.parametrize("name", [
    "viridis", "jet", "turbo", "hot", "gray", "autumn", "winter", "spring",
    "summer", "cool", "ocean", "bone", "pink", "hsv", "rainbow",
    "deepgreen"])
def test_apply_colormap_builtin_luts(name):
    _check(jcolor.apply_colormap(jnp.asarray(GRAY), name),
           tcolor.apply_colormap(GRAY, name, **CPU))
    _check(jcolor.apply_colormap(jnp.asarray(RGBF[..., :1]), name),
           tcolor.apply_colormap(RGBF[..., :1], name, **CPU))


def test_apply_colormap_unknown_and_matplotlib_maps():
    with pytest.raises(ValueError, match="unknown colormap"):
        tcolor.apply_colormap(GRAY, "nope", **CPU)
    try:
        ref = jcolor.apply_colormap(jnp.asarray(GRAY), "magma")
    except ValueError:
        # no matplotlib here: the port raises as the reference does
        with pytest.raises(ValueError, match="matplotlib"):
            tcolor.apply_colormap(GRAY, "magma", **CPU)
    else:
        _check(ref, tcolor.apply_colormap(GRAY, "magma", **CPU))


# --------------------------------------------------------------------------
# normalisation, histograms
# --------------------------------------------------------------------------

MEAN, STD = (0.4, 0.5, 0.6), (0.2, 0.3, 0.25)


def test_normalize():
    _check(jnorm.normalize_mean_std(jnp.asarray(RGB), MEAN, STD),
           tnorm.normalize_mean_std(RGB, MEAN, STD, **CPU))
    _check(jnorm.denormalize_mean_std(jnp.asarray(RGBF), MEAN, STD),
           tnorm.denormalize_mean_std(RGBF, MEAN, STD, **CPU))
    _check(jnorm.normalize_min_max(jnp.asarray(RGB), -1.0, 2.0),
           tnorm.normalize_min_max(RGB, -1.0, 2.0, **CPU))


@pytest.mark.parametrize("nbins", [256, 64, 7])
def test_histogram_u8(nbins):
    got = thist.histogram_u8(GRAY, nbins, **CPU)
    _check(jhist.histogram_u8(jnp.asarray(GRAY), nbins), got)
    assert int(got.sum()) == GRAY.size


@pytest.mark.parametrize("nbins,lo,hi", [(100, 0.0, 1.0), (256, 0.2, 0.8),
                                         (1000, -0.1, 1.1)])
def test_histogram_float(nbins, lo, hi):
    """Float bins, values outside [lo, hi) clipped into the end bins; more
    than 256 bins as well."""
    _check(jhist.histogram(jnp.asarray(RGBF), nbins, lo, hi),
           thist.histogram(RGBF, nbins, lo, hi, **CPU))


# --------------------------------------------------------------------------
# enhancement
# --------------------------------------------------------------------------

# float32: the mean of adjust_contrast is a reduction in another order
# (measured 6.0e-8), pow's ULP in adjust_gamma (6.0e-8); u8 exact
_ENH_TOL = {("adjust_contrast", "f32"): 1e-6, ("adjust_gamma", "f32"): 1e-6}


@pytest.mark.parametrize("kind", ["u8", "f32"])
@pytest.mark.parametrize("fn,arg", [
    ("adjust_brightness", 1.3), ("adjust_contrast", 1.4),
    ("adjust_saturation", 0.6), ("adjust_hue", 30.0), ("adjust_hue", -75.0),
    ("adjust_gamma", 0.7)])
def test_adjust(fn, arg, kind, record_property):
    x = IMGS[kind]
    err = _check(getattr(jenh, fn)(jnp.asarray(x), arg),
                 getattr(tenh, fn)(x, arg, **CPU),
                 _ENH_TOL.get((fn, kind), 0.0))
    record_property("max_abs_err", err)


def test_add_weighted_invert_equalize():
    b = RGB[::-1].copy()
    _check(jenh.add_weighted(jnp.asarray(RGB), 0.3, jnp.asarray(b), 0.7, 5),
           tenh.add_weighted(RGB, 0.3, b, 0.7, 5, **CPU))
    _check(jenh.invert(jnp.asarray(RGB)), tenh.invert(RGB, **CPU))
    _check(jenh.invert(jnp.asarray(RGBF)), tenh.invert(RGBF, **CPU))
    _check(jenh.equalize_hist(jnp.asarray(GRAY)),
           tenh.equalize_hist(GRAY, **CPU))


@pytest.mark.parametrize("shape,clip,grid", [
    ((96, 128), 40.0, (8, 8)), ((96, 128), 2.0, (8, 8)),
    ((100, 150), 3.0, (4, 6)), ((101, 77), 1.0, (3, 5))],
    ids=["default", "clip2", "padded-4x6", "odd-3x5"])
def test_clahe_bytes_equal(shape, clip, grid):
    """CLAHE's bytes equal the reference's, tile sizes that need the
    reflect-101 extension included."""
    g = _textured(13, shape)
    _check(jenh.clahe(jnp.asarray(g), clip, grid),
           tenh.clahe(g, clip, grid, **CPU))


# --------------------------------------------------------------------------
# thresholds
# --------------------------------------------------------------------------


@pytest.mark.parametrize("fn,args", [
    ("threshold_binary", (127.5, 200)), ("threshold_binary_inverse",
                                         (127.5, 200)),
    ("threshold_truncate", (127.7,)), ("threshold_to_zero", (100,)),
    ("threshold_to_zero_inverse", (100,))])
def test_fixed_thresholds(fn, args):
    _check(getattr(jthr, fn)(jnp.asarray(GRAY), *args),
           getattr(tthr, fn)(GRAY, *args, **CPU))
    x = RGBF[..., 0]
    fargs = tuple(a / 255.0 for a in args)
    _check(getattr(jthr, fn)(jnp.asarray(x), *fargs),
           getattr(tthr, fn)(x, *fargs, **CPU))


def test_otsu_threshold_is_a_device_scalar():
    got = tthr.otsu_threshold(GRAY, **CPU)
    assert got.ndim == 0 and got.dtype == torch.float32
    _check(jthr.otsu_threshold(jnp.asarray(GRAY)), got)
    bimodal = np.where(GRAY > 128, 200, 40).astype(np.uint8)
    _check(jthr.otsu_threshold(jnp.asarray(bimodal)),
           tthr.otsu_threshold(bimodal, **CPU))


@pytest.mark.parametrize("method", ["mean", "gaussian"])
@pytest.mark.parametrize("inverse", [False, True])
def test_adaptive_threshold(method, inverse):
    _check(jthr.adaptive_threshold(jnp.asarray(GRAY), 255.0, method, 11,
                                   2.0, inverse),
           tthr.adaptive_threshold(GRAY, 255.0, method, 11, 2.0, inverse,
                                   **CPU))


# --------------------------------------------------------------------------
# morphology, Canny, Bayer, distance transform
# --------------------------------------------------------------------------


@pytest.mark.parametrize("ksize", [(3, 3), (4, 2), (5, 5)])
@pytest.mark.parametrize("fn", ["dilate", "erode", "opening", "closing",
                                "gradient", "top_hat", "black_hat"])
def test_morphology(fn, ksize):
    """(4, 2): an even kernel pads (k // 2, (k − 1) // 2), asymmetric."""
    _check(getattr(jmorph, fn)(jnp.asarray(RGB), ksize),
           getattr(tmorph, fn)(RGB, ksize, **CPU))


def test_morphology_structuring_element_and_float():
    se = np.array([[0, 1, 0], [1, 1, 1], [0, 1, 0]], np.uint8)
    ring = np.ones((4, 4), np.uint8)
    ring[1:3, 1:3] = 0
    for kernel in (se, ring):
        _check(jmorph.dilate(jnp.asarray(GRAY), kernel=kernel),
               tmorph.dilate(GRAY, kernel=kernel, **CPU))
        _check(jmorph.erode(jnp.asarray(GRAY), kernel=kernel),
               tmorph.erode(GRAY, kernel=kernel, **CPU))
    _check(jmorph.gradient(jnp.asarray(RGBF), (3, 3)),
           tmorph.gradient(RGBF, (3, 3), **CPU))


@pytest.mark.parametrize("args", [(), (50.0, 120.0), (20.0, 60.0, 3, 1.0, 4),
                                  (30.0, 90.0, 1)],
                         ids=["default", "low", "k3-4iters", "no-blur"])
def test_canny_equals_reference(args):
    """Edges equal on these inputs. atan2 can differ by one ULP between
    the packages and move a pixel's direction bin; on the card that share
    is measured by chip_smoke.py."""
    _check(jcanny.canny(jnp.asarray(GRAY), *args),
           tcanny.canny(GRAY, *args, **CPU))


@pytest.mark.parametrize("pattern", ["rggb", "bggr", "grbg", "gbrg"])
def test_bayer_mosaic_and_demosaic(pattern):
    raw = np.asarray(jbayer.mosaic(jnp.asarray(RGB), pattern))
    _check(raw, tbayer.mosaic(RGB, pattern, **CPU))
    _check(jbayer.demosaic_bilinear(jnp.asarray(raw), pattern),
           tbayer.demosaic_bilinear(raw, pattern, **CPU))
    rawf = raw.astype(np.float32)
    _check(jbayer.demosaic_bilinear(jnp.asarray(rawf), pattern),
           tbayer.demosaic_bilinear(rawf, pattern, **CPU))
    with pytest.raises(ValueError, match="pattern"):
        tbayer.mosaic(RGB, "rgbg", **CPU)


@pytest.mark.parametrize("case", ["blobs", "sparse-zeros", "no-zero",
                                  "chunk-7"])
def test_distance_transform_bit_equal(case):
    mask = (GRAY > 60).astype(np.uint8)
    chunk = 32
    if case == "sparse-zeros":
        mask = np.ones((70, 90), np.uint8)
        mask[[5, 40, 66], [80, 3, 45]] = 0
    elif case == "no-zero":
        mask = np.ones((20, 30), np.uint8)
    elif case == "chunk-7":
        chunk = 7
    _check(jdt.distance_transform(jnp.asarray(mask), chunk),
           tdt.distance_transform(mask, chunk, **CPU))


# --------------------------------------------------------------------------
# metrics, geometry, drawing
# --------------------------------------------------------------------------

B2 = np.clip(RGB.astype(int) + np.random.default_rng(14).integers(
    -20, 20, RGB.shape), 0, 255).astype(np.uint8)


@pytest.mark.parametrize("fn", ["mse", "l1", "huber", "psnr", "ssim"])
def test_metrics_are_device_scalars(fn, record_property):
    """Means over the image: one reduction in another summation order
    (measured ≤ 1.2e-8 relative on these inputs); 1e-6 relative."""
    got = getattr(tmet, fn)(RGB, B2, **CPU)
    assert got.ndim == 0 and got.dtype == torch.float32
    ref = float(getattr(jmet, fn)(jnp.asarray(RGB), jnp.asarray(B2)))
    record_property("rel_err", abs(float(got) - ref) / abs(ref))
    assert abs(float(got) - ref) <= 1e-6 * abs(ref)
    g2 = B2[..., 0]
    ref = float(getattr(jmet, fn)(jnp.asarray(GRAY), jnp.asarray(g2)))
    assert abs(float(getattr(tmet, fn)(GRAY, g2, **CPU)) - ref) \
        <= 1e-6 * abs(ref)


@pytest.mark.parametrize("fn", ["hflip", "vflip", "rot180"])
def test_flips(fn):
    for x in (RGB, GRAY):
        _check(getattr(jgeo, fn)(jnp.asarray(x)), getattr(tgeo, fn)(x, **CPU))


def test_crops():
    _check(jgeo.crop(jnp.asarray(RGB), 5, 7, 30, 20),
           tgeo.crop(RGB, 5, 7, 30, 20, **CPU))
    _check(jgeo.center_crop(jnp.asarray(RGB), (31, 40)),
           tgeo.center_crop(RGB, (31, 40), **CPU))


@pytest.mark.parametrize("x,y", [(5, 7), (120, -3), (-200, 5), (3, -100),
                                 (-1, -1)])
def test_dynamic_crop_clamps_like_dynamic_slice(x, y):
    """Negative starts count from the end, then each start is clamped so
    the window fits; offsets as tensors (index arithmetic, nothing read
    back) and as Python ints."""
    ref = jgeo.dynamic_crop(jnp.asarray(RGB), jnp.asarray(x), jnp.asarray(y),
                            30, 20)
    _check(ref, tgeo.dynamic_crop(RGB, torch.tensor(x), torch.tensor(y), 30,
                                  20, **CPU))
    _check(ref, tgeo.dynamic_crop(RGB, x, y, 30, 20, **CPU))


@pytest.mark.parametrize("mode", ["constant", "reflect", "replicate"])
def test_pad(mode):
    for x in (RGB, GRAY, RGBF):
        _check(jgeo.pad(jnp.asarray(x), 3, 5, 2, 7, mode, 7.6),
               tgeo.pad(x, 3, 5, 2, 7, mode, 7.6, **CPU))
    _check(jgeo.pad(jnp.asarray(GRAY[:4, :5]), 9, 1, 11, 0, mode),
           tgeo.pad(GRAY[:4, :5], 9, 1, 11, 0, mode, **CPU))


def test_draw_line_circle_rect():
    img = RGB
    _check(jdraw.draw_line(jnp.asarray(img), (3.3, 4.1), (100.7, 80.2),
                           (255, 0, 0), 2.5),
           tdraw.draw_line(img, (3.3, 4.1), (100.7, 80.2), (255, 0, 0), 2.5,
                           **CPU))
    for thickness in (3.0, -1):
        _check(jdraw.draw_circle(jnp.asarray(img), (50.5, 40.2), 20.3,
                                 (0, 0, 255), thickness),
               tdraw.draw_circle(img, (50.5, 40.2), 20.3, (0, 0, 255),
                                 thickness, **CPU))
        _check(jdraw.draw_rect(jnp.asarray(img), (10, 12), (90.5, 70),
                               (9, 9, 9), thickness),
               tdraw.draw_rect(img, (10, 12), (90.5, 70), (9, 9, 9),
                               thickness, **CPU))
    _check(jdraw.draw_line(jnp.asarray(RGBF), (0, 0), (0, 0), (0.5, 1, 0)),
           tdraw.draw_line(RGBF, (0, 0), (0, 0), (0.5, 1, 0), **CPU))


@pytest.mark.parametrize("radius", [2.0, 1.5, 3.7, 0.5])
def test_draw_keypoints_equals_the_dense_form(radius):
    """Keypoints inside, on and beyond the border; the port tests only each
    keypoint's disc neighbourhood, the reference every pixel."""
    xy = np.random.default_rng(15).uniform(-5, 140, (200, 2)).astype(
        np.float32)
    xy[:4] = [[0, 0], [127, 95], [127.5, 95.5], [64, 48]]
    _check(jdraw.draw_keypoints(jnp.asarray(RGB), jnp.asarray(xy),
                                radius=radius),
           tdraw.draw_keypoints(RGB, xy, radius=radius, **CPU))
