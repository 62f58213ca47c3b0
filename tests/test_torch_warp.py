"""The port's image-warping slice (kornia_tpu_torch/ops/{interpolation,
warp_exact,warp,warp_shear}.py, geometry/{camera,stereo}.py) against the
JAX package, on the CPU.

On the CPU each kernel wrapper runs its plain version (K7 remap, K8
lane_shift, K9 shear_x); those are held here both to the XLA gather route
the CPU reference runs and to the Pallas kernels themselves in interpret
mode. Interpret mode costs ~7 s per call at 75×170 on this suite's CPU, so
it is kept to a handful of calls. The CUDA kernels are held to their plain
versions on the card by tests/test_torch_cuda.py.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from kornia_tpu.geometry import camera as jcam
from kornia_tpu.geometry import stereo as jstereo
from kornia_tpu.ops import interpolation as jint
from kornia_tpu.ops import warp as jwarp
from kornia_tpu.ops import warp_pallas as jwp
from kornia_tpu.ops import warp_shear as jws

from kornia_tpu_torch import convert
from kornia_tpu_torch.geometry import camera, stereo
from kornia_tpu_torch.ops import cuda_kernels as ck
from kornia_tpu_torch.ops import interpolation, warp, warp_exact, warp_shear

# One intra-op thread: these tests run many small ops, and torch's pool
# of a thread per core spins against the other test processes.
torch.set_num_threads(1)

CPU = "cpu"


@pytest.fixture(scope="module")
def img_u8():
    # tests/test_warp_pallas.py:45-46
    return np.random.default_rng(7).integers(0, 256, (75, 170), np.uint8)


@pytest.fixture(scope="module")
def smooth_maps(img_u8):
    # tests/test_warp_pallas.py:50-56
    h, w = img_u8.shape
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    r2 = ((xx - w / 2) / w) ** 2 + ((yy - h / 2) / h) ** 2
    mx = xx + 40.0 * r2 * (xx - w / 2) / w
    my = yy + 40.0 * r2 * (yy - h / 2) / h
    return mx.astype(np.float32), my.astype(np.float32)


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _lsb_ties(a, b):
    """(max |a − b|, share of pixels that differ) of two u8 images."""
    d = np.abs(_np(a).astype(int) - _np(b).astype(int))
    return d.max(), (d > 0).mean()


# --------------------------------------------------------------------------
# remap (K7, data maps)
# --------------------------------------------------------------------------


@pytest.mark.parametrize("mode,pad", [("bilinear", "border")])
def test_remap_matches_remap_exact_interpret(img_u8, smooth_maps, mode, pad):
    """u8 remap is bit-equal to the Pallas kernel (interpret mode; its
    gather fallback is not compiled: an exact result shows the maps fit
    its window capacity). Border padding is where the Pallas contract
    differs from the gather route; zeros padding and nearest, where the
    two JAX routes agree on these maps, are held to the gather route
    below (one interpret-mode call costs 7-20 s)."""
    mx, my = smooth_maps
    ref = jwp.remap_exact(jnp.asarray(img_u8), jnp.asarray(mx),
                          jnp.asarray(my), mode=mode, padding_mode=pad,
                          fallback=False)
    got = interpolation.remap(img_u8, mx, my, mode=mode, padding_mode=pad,
                              device=CPU)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("mode", ["bilinear", "nearest"])
@pytest.mark.parametrize("pad", ["zeros", "border"])
def test_remap_matches_gather_route(img_u8, smooth_maps, mode, pad):
    """Bit-equal to the gather route (interpolation.remap on the CPU), u8
    and 3-channel f32 alike: the kernel sums the taps in grid_sample's
    order. The maps have no exact .5 nearest ties. Their corners reach
    past the image, where the two JAX routes' border padding differs in
    f32 (pinned below): there, f32 bilinear is held to 1e-6 relative."""
    mx, my = smooth_maps
    h, w = img_u8.shape
    inside = (mx >= 0) & (mx <= w - 1) & (my >= 0) & (my <= h - 1)
    imgf = np.random.default_rng(3).random(img_u8.shape + (3,)).astype(
        np.float32)
    for img in (img_u8, imgf):
        ref = np.asarray(jint.remap(jnp.asarray(img), jnp.asarray(mx),
                                    jnp.asarray(my), mode=mode,
                                    padding_mode=pad))
        got = interpolation.remap(img, mx, my, mode=mode, padding_mode=pad,
                                  device=CPU).numpy()
        if pad == "border" and mode == "bilinear" and img.dtype != np.uint8:
            assert (~inside).sum() > 0
            np.testing.assert_array_equal(got[inside], ref[inside])
            np.testing.assert_allclose(got, ref, rtol=1e-6)
        else:
            np.testing.assert_array_equal(got, ref)


def test_remap_nearest_tie_follows_pallas():
    """At an exact .5 the Pallas path rounds up (floor(x + 0.5),
    warp_pallas.py:796-798); the gather route rounds half to even
    (interpolation.py:65-66). The port follows the Pallas path."""
    img = np.arange(40, dtype=np.uint8).reshape(4, 10) * 3
    mx = np.full((4, 3), 0.0, np.float32) + np.array([2.5, 3.5, 4.5],
                                                     np.float32)
    my = np.tile(np.arange(4, dtype=np.float32)[:, None], (1, 3))
    got = interpolation.remap(img, mx, my, mode="nearest", device=CPU)
    np.testing.assert_array_equal(got.numpy(), img[:, [3, 4, 5]])
    gather = np.asarray(jint.remap(jnp.asarray(img), jnp.asarray(mx),
                                   jnp.asarray(my), mode="nearest"))
    np.testing.assert_array_equal(gather, img[:, [2, 4, 4]])


def test_remap_border_clips_map_like_pallas():
    """Border padding clips the map before sampling (warp_pallas.py:
    804-806), so a sample past the edge reads the edge value exactly; the
    gather route clamps each tap and blends v·(1-fx) + v·fx, which need not
    equal v in f32 (interpolation.py:86)."""
    rng = np.random.default_rng(5)
    img = rng.random((6, 9)).astype(np.float32)
    h, w = img.shape
    fx = rng.uniform(0.05, 0.95, 40).astype(np.float32)
    mx = np.float32(w - 1) + fx
    my = np.tile(np.arange(h, dtype=np.float32)[:, None], (1, 40))
    mx = np.tile(mx[None], (h, 1))
    got = interpolation.remap(img, mx, my, padding_mode="border",
                              device=CPU).numpy()
    np.testing.assert_array_equal(got, np.tile(img[:, -1:], (1, 40)))
    gather = np.asarray(jint.remap(jnp.asarray(img), jnp.asarray(mx),
                                   jnp.asarray(my), padding_mode="border"))
    assert (gather != got).any()
    np.testing.assert_allclose(gather, got, rtol=1e-6)


def test_remap_u8_rounds_half_to_even():
    """u8 finalisation is round-half-to-even like jnp.round (torch.round in
    the plain version, __float2int_rn in the kernel), never half-up."""
    img = np.array([[0, 1, 2, 3, 4, 5]], np.uint8)
    mx = np.array([[0.5, 1.5, 2.5, 3.5, 4.5]], np.float32)
    my = np.zeros_like(mx)
    got = interpolation.remap(img, mx, my, device=CPU).numpy()
    np.testing.assert_array_equal(got, [[0, 2, 2, 4, 4]])
    ref = np.asarray(jint.remap(jnp.asarray(img), jnp.asarray(mx),
                                jnp.asarray(my)))
    np.testing.assert_array_equal(got, ref)


def test_remap_fill_value_and_other_dtypes(img_u8, smooth_maps):
    """A non-zero fill and a float64 image (sampled as f32, cast back) match
    the gather route; bicubic goes through grid_sample."""
    mx, my = smooth_maps
    mx = mx - 20.0
    img64 = img_u8.astype(np.float64) / 255.0
    for kw in ({"fill_value": 37.0}, {"mode": "bicubic"}):
        ref = jint.remap(jnp.asarray(img_u8), jnp.asarray(mx),
                         jnp.asarray(my), **kw)
        got = interpolation.remap(img_u8, mx, my, device=CPU, **kw)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    got = interpolation.remap(img64, mx, my, device=CPU)
    assert got.dtype == torch.float64
    ref = jint.remap(jnp.asarray(img64.astype(np.float32)), jnp.asarray(mx),
                     jnp.asarray(my))
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(ref).astype(np.float64))


def test_grid_sample_bicubic_matches_reference(img_u8, smooth_maps):
    """The gather route itself, bicubic with border padding: the 16 taps in
    the reference's order. ≤ 2e-4 on values up to 255 (≈1 ULP at 255):
    XLA's CPU compiler may contract the Keys polynomial into FMAs."""
    mx, my = smooth_maps
    img = img_u8[..., None].astype(np.float32)
    ref = np.asarray(jint.grid_sample(jnp.asarray(img), jnp.asarray(mx),
                                      jnp.asarray(my), mode="bicubic",
                                      padding_mode="border"))
    got = interpolation.grid_sample(img, mx, my, mode="bicubic",
                                    padding_mode="border", device=CPU)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=2e-4)


# --------------------------------------------------------------------------
# warp_affine / warp_perspective (K7, affine and perspective coefficients)
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def img_small(img_u8):
    # one 32-row destination block of the Pallas kernel: interpret mode
    # costs per block
    return np.ascontiguousarray(img_u8[:32, :120])


@pytest.mark.parametrize("angle", [10.0, 30.0])
def test_warp_affine_matches_exact_interpret(img_small, angle):
    """10° takes the JAX package's direct route, 30° its rot90 + integer
    pre-shear route (K8); both sample the same source pixels with the same
    coefficients, so the result is bit-equal (the gather fallback is not
    compiled, as above). The reference's rotation
    matrix is passed to both (torch and XLA cos/sin may differ by an ULP;
    see test_rotation_matrix_matches)."""
    h, w = img_small.shape
    m = np.asarray(jwarp.get_rotation_matrix2d((w / 2, h / 2), angle, 1.0))
    ref = np.asarray(jwp.warp_affine_exact(jnp.asarray(img_small),
                                           jnp.asarray(m), (h, w),
                                           fallback=False))
    got = warp.warp_affine(img_small, m, (h, w), device=CPU)
    np.testing.assert_array_equal(got.numpy(), ref)


def test_warp_affine_scale_and_gather_route(img_u8):
    """Scale 0.5 and 25°/0.8 with border and nearest, against the gather
    route: ≤ 1 LSB on < 1% of pixels, the reference's own bound
    (tests/test_warp_pallas.py:129-132) for its ulp-level matrix-inversion
    difference (adjugate/det here, jnp.linalg.inv there)."""
    h, w = img_u8.shape
    cases = [
        (np.asarray([[0.5, 0, 10], [0, 0.5, 5]], np.float32), {}),
        (np.asarray(jwarp.get_rotation_matrix2d((w / 2, h / 2), 25.0, 0.8)),
         {"padding_mode": "border"}),
        (np.asarray(jwarp.get_rotation_matrix2d((w / 2, h / 2), 25.0, 0.8)),
         {"mode": "nearest"}),
    ]
    for m, kw in cases:
        ref = jwarp.warp_affine(jnp.asarray(img_u8), jnp.asarray(m),
                                (60, 200), method="gather", **kw)
        got = warp.warp_affine(img_u8, m, (60, 200), device=CPU, **kw)
        dmax, share = _lsb_ties(got, ref)
        assert dmax <= 1 and share < 0.01, (kw, dmax, share)


def test_warp_perspective_matches_exact_interpret(img_small):
    """The mild homography of tests/test_warp_pallas.py:171-172: ≤ 1 LSB on
    < 1% of pixels, because the 3×3 inverse (torch.linalg.inv vs
    jnp.linalg.inv) may differ by an ULP (measured: one entry by 7e-12)."""
    h, w = img_small.shape
    hm = np.asarray([[1.0, 0.05, 4], [0.02, 0.98, -3], [1e-4, -8e-5, 1.0]],
                    np.float32)
    ref = jwp.warp_perspective_exact(jnp.asarray(img_small), jnp.asarray(hm),
                                     (h, w), fallback=False)
    got = warp.warp_perspective(img_small, hm, (h, w), device=CPU)
    dmax, share = _lsb_ties(got, ref)
    assert dmax <= 1 and share < 0.01, (dmax, share)


def test_warp_perspective_denominator_clamp():
    """|den| < 1e-8 → 1e-8 (warp.py:143, warp_pallas.py:922): a homography
    whose inverse's third row vanishes at one destination pixel gives the
    same result as the gather route, f32 and u8, with a non-zero fill."""
    rng = np.random.default_rng(9)
    img = rng.random((20, 30, 2)).astype(np.float32)
    # inverse third row (1, 1, -10): den = x + y - 10 is 0 on a diagonal
    hinv = np.array([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [1.0, 1.0, -10.0]],
                    np.float64)
    hm = np.linalg.inv(hinv).astype(np.float32)
    for x in (img, (img * 255).astype(np.uint8)):
        ref = jwarp.warp_perspective(jnp.asarray(x), jnp.asarray(hm), (20, 30),
                                     method="gather", fill_value=3.0)
        got = warp.warp_perspective(x, hm, (20, 30), fill_value=3.0,
                                    device=CPU)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_warp_bicubic_takes_gather_route(img_u8):
    h, w = img_u8.shape
    m = np.asarray(jwarp.get_rotation_matrix2d((w / 2, h / 2), 12.0, 1.1))
    hm = np.asarray([[1.0, 0.05, 4], [0.02, 0.98, -3], [1e-4, -8e-5, 1.0]],
                    np.float32)
    pairs = [(jwarp.warp_affine(jnp.asarray(img_u8), jnp.asarray(m), (h, w),
                                mode="bicubic"),
              warp.warp_affine(img_u8, m, (h, w), mode="bicubic",
                               device=CPU)),
             (jwarp.warp_perspective(jnp.asarray(img_u8), jnp.asarray(hm),
                                     (h, w), mode="bicubic"),
              warp.warp_perspective(img_u8, hm, (h, w), mode="bicubic",
                                    device=CPU))]
    for ref, got in pairs:
        # ≤ 1 LSB on < 1%: the 2×2 / 3×3 inverses and the Keys polynomial
        # may differ by an ULP between torch and XLA
        dmax, share = _lsb_ties(got, ref)
        assert dmax <= 1 and share < 0.01, (dmax, share)


def test_rotation_matrix_and_inverse_match():
    """get_rotation_matrix2d within an ULP of the reference (f32 cos/sin
    may differ by one ULP between torch and XLA); invert_affine to f32
    roundoff; the exact path's adjugate inverse bit-equal."""
    for ang, sc in ((10.0, 1.0), (30.0, 1.0), (-73.0, 0.6)):
        ref = np.asarray(jwarp.get_rotation_matrix2d((85.0, 37.5), ang, sc))
        got = warp.get_rotation_matrix2d((85.0, 37.5), ang, sc,
                                         device=CPU).numpy()
        np.testing.assert_allclose(got, ref, rtol=2e-7, atol=2e-5)
        inv_ref = np.asarray(jwarp.invert_affine(jnp.asarray(ref)))
        np.testing.assert_allclose(
            warp.invert_affine(ref, device=CPU).numpy(), inv_ref,
            rtol=1e-6, atol=1e-4)
        mm = jnp.asarray(ref)
        a = mm[:, :2]
        det = a[0, 0] * a[1, 1] - a[0, 1] * a[1, 0]
        ainv = jnp.stack([jnp.stack([a[1, 1], -a[0, 1]]),
                          jnp.stack([-a[1, 0], a[0, 0]])]) / det
        tinv = -ainv @ mm[:, 2]
        want = np.array([ainv[0, 0], ainv[0, 1], tinv[0], ainv[1, 0],
                         ainv[1, 1], tinv[1], 0, 0, 1], np.float32)
        np.testing.assert_array_equal(warp_exact.affine_coefs(ref).numpy(),
                                      want)


def test_warp_methods_of_the_jax_package_raise(img_u8):
    m = np.eye(2, 3, dtype=np.float32)
    for method in ("pallas", "gather"):
        with pytest.raises(ValueError, match="method='auto'"):
            warp.warp_affine(img_u8, m, (10, 10), method=method, device=CPU)
        with pytest.raises(ValueError, match="method='auto'"):
            warp.warp_perspective(img_u8, np.eye(3), (10, 10), method=method,
                                  device=CPU)


# --------------------------------------------------------------------------
# K8 lane_shift, K9 shear_x, warp_affine_shear
# --------------------------------------------------------------------------


def test_lane_shift_matches_pallas_interpret():
    """Bit-equal to _lane_shift_pallas at the shapes its sheared branch
    gives it: shift = floor(κ·r) − s0 with |κ| ≤ 1.05, ht = s + ⌈1.05 s⌉
    + 8, odd s, both slope signs."""
    rng = np.random.default_rng(2)
    s = 90
    ht = s + int(np.ceil(1.05 * s)) + 8
    src = rng.random((s, s)).astype(np.float32)
    for kap in (np.float32(0.57735), np.float32(-1.05)):
        sh = np.floor(kap * np.arange(s, dtype=np.float32))
        sh = (sh - sh.min()).astype(np.int32)
        ref = np.asarray(jwp._lane_shift_pallas(jnp.asarray(src),
                                                jnp.asarray(sh), ht))
        got = warp_exact.lane_shift(src, sh, ht, device=CPU)
        np.testing.assert_array_equal(got.numpy(), ref)
    batch = ck.lane_shift(torch.tensor(np.stack([src, src[::-1].copy()])),
                          torch.tensor(sh), ht)
    np.testing.assert_array_equal(batch[0].numpy(), got.numpy())


def test_shear_x_matches_pallas_interpret():
    """Against _shear_x (interpret mode): ≤ 1 ULP. XLA's CPU compiler
    contracts the kernel's a·(1-f) + b·f into fma(a, 1-f, b·f) there
    (measured: equal to that FMA form at every pixel); the TPU and the
    port round each op, so the written formula is checked exactly."""
    rng = np.random.default_rng(1)
    c = 256
    img = rng.standard_normal((c, c)).astype(np.float32)
    for shifts in ((0.3 * np.arange(c) - 40).astype(np.float32),
                   (-0.414 * np.arange(c) + 60.7).astype(np.float32),
                   np.full(c, 33.5, np.float32),
                   np.full(c, 400.0, np.float32)):     # invalid rows: zero
        ref = np.asarray(jws._shear_x(jnp.asarray(img), jnp.asarray(shifts)))
        got = warp_shear._shear_x(torch.tensor(img),
                                  torch.tensor(shifts)).numpy()
        np.testing.assert_allclose(got, ref, rtol=0,
                                   atol=np.spacing(np.float32(4.0)))
        i0f = np.floor(shifts)
        f = shifts - i0f
        i0 = i0f.astype(int)
        pad = np.pad(img, ((0, 0), (1000, 1000)))
        cols = 1000 + i0[:, None] + np.arange(c)
        a = np.take_along_axis(pad, cols, 1)
        b = np.take_along_axis(pad, cols + 1, 1)
        want = (a * (np.float32(1) - f)[:, None]
                + b * f[:, None]).astype(np.float32)
        slack = c // 4 + 192
        want[~((i0 > -slack) & (i0 < slack - 1))] = 0
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("batch", [1, 3])
def test_shear_y_matches_transpose_and_pallas_interpret(batch):
    """The column mode against the row mode on the transpose (bit-equal),
    and against the JAX package's _shear_y (interpret mode, on the
    transpose) to 1 ULP: XLA's FMA contraction, as for _shear_x. Shifts of
    both signs, exact integers and columns past ±slack (zero)."""
    rng = np.random.default_rng(3)
    c = 256
    img = rng.standard_normal((batch, c, c)).astype(np.float32)
    xs = np.arange(c, dtype=np.float32)
    for shifts in ((0.3 * xs - 40).astype(np.float32),
                   (-0.414 * xs + 60.7).astype(np.float32),
                   np.where(xs < 100, 33.0, 400.0).astype(np.float32)):
        got = warp_shear._shear_y(torch.tensor(img), torch.tensor(shifts))
        want = ck._shear_x_plain(torch.tensor(img).transpose(-1, -2)
                                 .contiguous(), torch.tensor(shifts))
        assert torch.equal(got, want.transpose(-1, -2))
        assert torch.equal(got, ck.shear_y(torch.tensor(img),
                                           torch.tensor(shifts)))
        ref = np.asarray(jws._shear_y(jnp.asarray(img[-1]),
                                      jnp.asarray(shifts)))
        np.testing.assert_allclose(got[-1].numpy(), ref, rtol=0,
                                   atol=np.spacing(np.float32(4.0)))
        assert (got[..., xs >= 100] == 0).all() if shifts[-1] == 400 \
            else True


def test_warp_affine_shear_matches_reference():
    """The whole shear route, u8 RGB and f32. u8: ≤ 1 LSB on < 1% of
    pixels; f32 (values up to 255): ≤ 4e-3. The deviations come from f32
    arctan/cos/tan ULPs between torch and XLA, the band matmul's summation
    order and the FMA contraction noted above, carried through six
    interpolating passes."""
    rng = np.random.default_rng(4)
    img = rng.integers(0, 256, (40, 60, 3), np.uint8)
    for m in (np.asarray(jwarp.get_rotation_matrix2d((30, 20), 25.0, 0.9)),
              np.asarray([[-1.1, 0.2, 70.0], [0.1, 0.8, 3.0]], np.float32)):
        ref = jws.warp_affine_shear(jnp.asarray(img), jnp.asarray(m),
                                    (40, 60))
        got = warp.warp_affine(img, m, (40, 60), method="shear", device=CPU)
        dmax, share = _lsb_ties(got, ref)
        assert dmax <= 1 and share < 0.01, (dmax, share)
        imgf = img.astype(np.float32)
        ref = np.asarray(jws.warp_affine_shear(jnp.asarray(imgf),
                                               jnp.asarray(m), (40, 60)))
        got = warp_shear.warp_affine_shear(imgf, m, (40, 60), device=CPU)
        np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=4e-3)


# --------------------------------------------------------------------------
# camera: projection, distortion, undistortion
# --------------------------------------------------------------------------

K_EUROC = np.array([[458.654, 0.0, 367.215], [0.0, 457.296, 248.375],
                    [0.0, 0.0, 1.0]], np.float32)
# tests/test_geometry.py:71-72
DIST = np.array([-0.28, 0.07, 0.0002, -0.0001, 0.001], np.float32)


def test_camera_points_match_reference():
    """Projection, distortion, iterative undistortion and the fisheye model
    to f32 roundoff (a few ULPs: XLA may contract the polynomials into
    FMAs)."""
    rng = np.random.default_rng(0)
    pts = rng.uniform([-1, -1, 2], [1, 1, 6], (64, 3)).astype(np.float32)
    xy = rng.uniform(-0.4, 0.4, (64, 2)).astype(np.float32)
    px = rng.uniform([50, 50], [700, 430], (64, 2)).astype(np.float32)
    kb = np.array([0.01, -0.005, 0.001, -0.0002], np.float32)
    k, d = jnp.asarray(K_EUROC), jnp.asarray(DIST)
    pairs = [
        (jcam.project_points(jnp.asarray(pts), k),
         camera.project_points(pts, K_EUROC, device=CPU), 1e-4),
        (jcam.unproject_points(jnp.asarray(px), jnp.asarray(pts[:, 2]), k),
         camera.unproject_points(px, pts[:, 2], K_EUROC, device=CPU), 1e-5),
        (jcam.distort_points_polynomial(jnp.asarray(xy), d),
         camera.distort_points_polynomial(xy, DIST, device=CPU), 1e-6),
        (jcam.undistort_points_iterative(jnp.asarray(xy), d),
         camera.undistort_points_iterative(xy, DIST, device=CPU), 1e-6),
        (jcam.undistort_points(jnp.asarray(px), k, d),
         camera.undistort_points(px, K_EUROC, DIST, device=CPU), 1e-3),
        (jcam.fisheye_project(jnp.asarray(pts), k, jnp.asarray(kb)),
         camera.fisheye_project(pts, K_EUROC, kb, device=CPU), 1e-4),
        (jcam.fisheye_unproject(jnp.asarray(px), k, jnp.asarray(kb)),
         camera.fisheye_unproject(px, K_EUROC, kb, device=CPU), 1e-6),
    ]
    for ref, got, atol in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                                   atol=atol)
    cam = camera.PinholeCamera.from_matrix(K_EUROC, 752, 480)
    np.testing.assert_array_equal(
        cam.k_matrix(CPU).numpy(),
        np.asarray(jcam.PinholeCamera.from_matrix(K_EUROC, 752,
                                                  480).k_matrix))


def test_undistort_image_matches_reference():
    """undistort_image at 120×160: the correction maps to f32 roundoff and
    the u8 image ≤ 1 LSB on < 1% of pixels (the maps' last-ULP
    differences can tip a rounding tie)."""
    rng = np.random.default_rng(6)
    img = rng.integers(0, 256, (120, 160), np.uint8)
    k = np.array([[150.0, 0, 80.0], [0, 150.0, 60.0], [0, 0, 1]], np.float32)
    new_k = k * np.array([[0.9], [0.9], [1.0]], np.float32)
    mx_r, my_r = jcam.generate_correction_map_polynomial(
        jnp.asarray(k), jnp.asarray(DIST), (120, 160), jnp.asarray(new_k))
    mx, my = camera.generate_correction_map_polynomial(
        k, DIST, (120, 160), new_k, device=CPU)
    np.testing.assert_allclose(mx.numpy(), np.asarray(mx_r), rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(my.numpy(), np.asarray(my_r), rtol=0,
                               atol=1e-4)
    ref = jcam.undistort_image(jnp.asarray(img), jnp.asarray(k),
                               jnp.asarray(DIST), jnp.asarray(new_k))
    got = camera.undistort_image(img, k, DIST, new_k, device=CPU)
    dmax, share = _lsb_ties(got, ref)
    assert dmax <= 1 and share < 0.01, (dmax, share)


# --------------------------------------------------------------------------
# stereo rectification
# --------------------------------------------------------------------------


def _calib():
    # tests/test_dense_ops2.py:236-242, with radtan distortion on both
    k1 = np.array([[458.0, 0, 367.2], [0, 457.3, 248.4], [0, 0, 1]])
    k2 = np.array([[457.6, 0, 379.0], [0, 456.1, 255.2], [0, 0, 1]])
    rvec = np.array([0.003, -0.002, 0.001])
    r = jstereo._rodrigues_matrix(rvec)
    t = np.array([-0.11, 0.0003, 0.0005])
    return k1, DIST.astype(np.float64), k2, DIST.astype(np.float64) * 0.9, r, t


def test_stereo_rectify_matches_reference():
    """The float64 calibration outputs to 1e-12."""
    k1, d1, k2, d2, r, t = _calib()
    ref = jstereo.stereo_rectify(k1, d1, k2, d2, (48, 75), r, t)
    got = stereo.stereo_rectify(k1, d1, k2, d2, (48, 75), r, t)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)
    rv = np.array([0.2, -0.1, 0.05])
    np.testing.assert_allclose(stereo._rodrigues_vector(
        stereo._rodrigues_matrix(rv)), rv, atol=1e-12)


def test_rectifier_from_reference_fields():
    """The reference rectifier's numpy fields carried over by
    convert.stereo_rectifier_from_reference give the same maps (f32
    roundoff: the reference applies R⁻¹ as an XLA dot) and rectify_left /
    rectify_right ≤ 1 LSB on < 1% of pixels."""
    k1, d1, k2, d2, r, t = _calib()
    size = (48, 75)
    ref = jstereo.StereoRectifier.from_calib(k1, d1, k2, d2, size, r, t)
    port = convert.stereo_rectifier_from_reference(dataclasses.asdict(ref))
    assert port.baseline == ref.baseline and port.bf == ref.bf
    for side in ("left", "right"):
        ref_maps = getattr(ref, f"map_{side}")
        got_maps = getattr(port, f"map_{side}")(CPU)
        for a, b in zip(got_maps, ref_maps):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                       atol=2e-4)
    rng = np.random.default_rng(8)
    img = rng.integers(0, 256, size, np.uint8)
    for side in ("left", "right"):
        want = getattr(ref, f"rectify_{side}")(jnp.asarray(img))
        got = getattr(port, f"rectify_{side}")(img, device=CPU)
        dmax, share = _lsb_ties(got, want)
        assert dmax <= 1 and share < 0.01, (side, dmax, share)
    with pytest.raises(ValueError, match="missing"):
        convert.stereo_rectifier_from_reference({"k1": k1})


# --------------------------------------------------------------------------
# device rule
# --------------------------------------------------------------------------


def test_entry_points_without_card_raise(img_u8, smooth_maps):
    """Every entry point defaults to device="cuda" and raises without a
    card unless the caller passes device="cpu"."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CUDA entry points run")
    mx, my = smooth_maps
    m = np.eye(2, 3, dtype=np.float32)
    k1, d1, k2, d2, r, t = _calib()
    rect = stereo.StereoRectifier.from_calib(k1, d1, k2, d2, (48, 75), r, t)
    pts = np.ones((4, 3), np.float32)
    calls = [
        lambda: interpolation.remap(img_u8, mx, my),
        lambda: interpolation.grid_sample(img_u8[..., None], mx, my),
        lambda: interpolation.meshgrid_pixel(4, 5),
        lambda: warp_exact.remap_exact(img_u8, mx, my),
        lambda: warp_exact.warp_affine_exact(img_u8, m, (8, 8)),
        lambda: warp_exact.warp_perspective_exact(img_u8, np.eye(3), (8, 8)),
        lambda: warp_exact.lane_shift(np.zeros((4, 4), np.float32),
                                      np.zeros(4, np.int32), 8),
        lambda: warp.warp_affine(img_u8, m, (8, 8)),
        lambda: warp.warp_affine(img_u8, m, (8, 8), method="shear"),
        lambda: warp.warp_perspective(img_u8, np.eye(3), (8, 8)),
        lambda: warp.invert_affine(m),
        lambda: warp.get_rotation_matrix2d((1.0, 1.0), 10.0, 1.0),
        lambda: warp_shear.warp_affine_shear(img_u8, m, (8, 8)),
        lambda: camera.PinholeCamera(1.0, 1.0, 0.0, 0.0).k_matrix(),
        lambda: camera.project_points(pts, K_EUROC),
        lambda: camera.unproject_points(pts[:, :2], pts[:, 2], K_EUROC),
        lambda: camera.distort_points_polynomial(pts[:, :2], DIST),
        lambda: camera.undistort_points_iterative(pts[:, :2], DIST),
        lambda: camera.undistort_points(pts[:, :2], K_EUROC, DIST),
        lambda: camera.generate_correction_map_polynomial(K_EUROC, DIST,
                                                          (4, 5)),
        lambda: camera.undistort_image(img_u8, K_EUROC, DIST),
        lambda: camera.fisheye_project(pts, K_EUROC, np.zeros(4)),
        lambda: camera.fisheye_unproject(pts[:, :2], K_EUROC, np.zeros(4)),
        lambda: stereo.init_undistort_rectify_map(k1, d1, rect.r1, rect.p1,
                                                  (48, 75)),
        lambda: rect.map_left(),
        lambda: rect.map_right(),
        lambda: rect.rectify_left(img_u8[:48, :75]),
        lambda: rect.rectify_right(img_u8[:48, :75]),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


def test_warp_kernels_count_no_cpu_launch(img_u8, smooth_maps):
    mx, my = smooth_maps
    ck.reset_launch_counts()
    interpolation.remap(img_u8, mx, my, device=CPU)
    warp.warp_affine(img_u8, np.eye(2, 3), (20, 20), method="shear",
                     device=CPU)
    warp_exact.lane_shift(np.zeros((4, 4), np.float32),
                          np.zeros(4, np.int32), 8, device=CPU)
    assert ck.LAUNCHES["remap"] == ck.LAUNCHES["lane_shift"] == 0
    assert ck.LAUNCHES["shear_x"] == ck.LAUNCHES["shear_y"] == 0
