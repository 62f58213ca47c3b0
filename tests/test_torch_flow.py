"""The port's pyramidal Lucas-Kanade (kornia_tpu_torch/ops/optical_flow.py)
and pyramids (ops/pyramid.py) against the JAX package. Each LK method is
held to the SAME method of the reference: the three clamp differently near
the borders by design. The fixture is made with numpy (no cv2)."""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from kornia_tpu.ops import optical_flow as jflow
from kornia_tpu.ops import pyramid as jpyr

from kornia_tpu_torch import convert
from kornia_tpu_torch.ops import cuda_kernels as ck
from kornia_tpu_torch.ops import optical_flow as tflow
from kornia_tpu_torch.ops import pyramid as tpyr

# One intra-op thread: these tests run many small ops, and torch's pool
# of a thread per core spins against the other test processes.
torch.set_num_threads(1)

tensor = functools.partial(convert.tensor, device="cpu")

METHODS = ("gather", "windows", "taps")
PARAMS = jflow.PyrLKParams(window=21, max_level=2)
TPARAMS = convert.pyrlk_params(dataclasses.asdict(PARAMS))


def _smooth(rng, h=120, w=160, cells=(15, 20)):
    """Seeded noise upsampled with smoothstep weights to (h, w), scaled to
    [0, 255]: smooth blobs with gradients everywhere."""
    base = rng.standard_normal((cells[0] + 1, cells[1] + 1))
    ys = np.arange(h) * (cells[0] / h)
    xs = np.arange(w) * (cells[1] / w)
    y0, x0 = np.floor(ys).astype(int), np.floor(xs).astype(int)
    fy, fx = (ys - y0)[:, None], (xs - x0)[None, :]
    fy, fx = fy * fy * (3 - 2 * fy), fx * fx * (3 - 2 * fx)
    img = (base[y0][:, x0] * (1 - fy) * (1 - fx)
           + base[y0][:, x0 + 1] * (1 - fy) * fx
           + base[y0 + 1][:, x0] * fy * (1 - fx)
           + base[y0 + 1][:, x0 + 1] * fy * fx)
    return ((img - img.min()) / (img.max() - img.min()) * 255).astype(
        np.float32)


def _warp(img, deg, tx, ty):
    """Rotate by ``deg`` about the centre and shift by (tx, ty), bilinear."""
    h, w = img.shape
    c, s = np.cos(np.deg2rad(deg)), np.sin(np.deg2rad(deg))
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    dx, dy = xx - w / 2 - tx, yy - h / 2 - ty
    x = np.clip(c * dx + s * dy + w / 2, 0, w - 1.001)
    y = np.clip(-s * dx + c * dy + h / 2, 0, h - 1.001)
    x0, y0 = np.floor(x).astype(int), np.floor(y).astype(int)
    fx, fy = x - x0, y - y0
    return (img[y0, x0] * (1 - fx) * (1 - fy) + img[y0, x0 + 1] * fx * (1 - fy)
            + img[y0 + 1, x0] * (1 - fx) * fy
            + img[y0 + 1, x0 + 1] * fx * fy).astype(np.float32)


@pytest.fixture(scope="module")
def pair():
    """The 160×120 fixture: a 2° rotation plus a (2.5, −1.5) px shift, 40
    points at least 16 px inside."""
    rng = np.random.default_rng(50)
    img0 = _smooth(rng)
    img1 = _warp(img0, 2.0, 2.5, -1.5)
    pts = np.stack([rng.uniform(16, 142, 40), rng.uniform(16, 102, 40)],
                   1).astype(np.float32)
    return img0, img1, pts


def _both(img0, img1, pts, method, params=PARAMS):
    tparams = convert.pyrlk_params(dataclasses.asdict(params))
    want = jflow.calc_optical_flow_pyr_lk(
        jnp.asarray(img0), jnp.asarray(img1), jnp.asarray(pts), params,
        method=method)
    stats = {}
    got = tflow.calc_optical_flow_pyr_lk(img0, img1, pts, tparams,
                                         method=method, device="cpu",
                                         stats=stats)
    return want, got, stats


@pytest.mark.parametrize("method", METHODS)
def test_lk_matches_reference_method(pair, method):
    """Status equal; points within 1e-3 px median and 0.05 px max: the
    window sums run in another order than XLA's, which can move a point's
    last Newton step across the eps = 0.01 px stopping test. The true flow
    is recovered within the reference's own bound (median < 0.25 px,
    tests/test_dense_ops2.py:170)."""
    img0, img1, pts = pair
    want, got, stats = _both(img0, img1, pts, method)
    np.testing.assert_array_equal(got.status.numpy(),
                                  np.asarray(want.status))
    assert got.status.sum() >= 30
    d = np.linalg.norm(got.points.numpy() - np.asarray(want.points), axis=1)
    assert np.median(d) < 1e-3 and d.max() < 0.05
    np.testing.assert_allclose(got.errors.numpy(), np.asarray(want.errors),
                               atol=1e-3)
    assert stats["method"] == method
    assert len(stats["iterations"]) == 3
    assert all(1 <= it <= TPARAMS.max_iters for it in stats["iterations"])
    c, s = np.cos(np.deg2rad(2.0)), np.sin(np.deg2rad(2.0))
    rel = pts - [80, 60]
    true = np.stack([c * rel[:, 0] - s * rel[:, 1] + 80 + 2.5,
                     s * rel[:, 0] + c * rel[:, 1] + 60 - 1.5], 1)
    ok = got.status.numpy()
    assert np.median(np.linalg.norm(got.points.numpy() - true,
                                    axis=1)[ok]) < 0.25


@pytest.mark.parametrize("method", METHODS)
def test_lk_near_border_points_match_reference_method(pair, method):
    """Points 2-11 px from the borders enter each method's own clamp
    corridor (the frame edge, the window edge, the extraction centre); the
    port follows the same method of the reference through it."""
    img0, img1, _ = pair
    pts = np.asarray([[10.0, 10.0], [149.0, 11.0], [11.0, 109.0],
                      [148.0, 108.0], [80.0, 10.0], [3.5, 60.2],
                      [157.0, 4.0], [2.0, 117.0]], np.float32)
    want, got, _ = _both(img0, img1, pts, method)
    np.testing.assert_array_equal(got.status.numpy(),
                                  np.asarray(want.status))
    d = np.linalg.norm(got.points.numpy() - np.asarray(want.points), axis=1)
    assert np.median(d) < 1e-3 and d.max() < 0.05


def test_lk_precomputed_reuse_and_u8_input(pair):
    img0, img1, pts = pair
    a, b = img0.astype(np.uint8), img1.astype(np.uint8)
    pre = tflow.build_lk_precomputed(a, b[..., None], TPARAMS, device="cpu")
    jpre = jflow.build_lk_precomputed(jnp.asarray(a), jnp.asarray(b), PARAMS)
    for name in pre._fields:
        for lt, lj in zip(getattr(pre, name), getattr(jpre, name)):
            # pyramids and Scharr gradients are shift-adds in the
            # reference's order: exact
            np.testing.assert_array_equal(lt.numpy(), np.asarray(lj))
    r1 = tflow.calc_optical_flow_pyr_lk_with_precomputed(pre, pts, TPARAMS)
    r2 = tflow.calc_optical_flow_pyr_lk(a, b, pts, TPARAMS, device="cpu")
    assert torch.equal(r1.points, r2.points)
    assert torch.equal(r1.status, r2.status)


def test_resolve_method_chain():
    for args in (("taps", 21), ("taps", 23), ("taps", 25), ("taps", 31),
                 ("windows", 21), ("windows", 27), ("windows", 31),
                 ("gather", 51)):
        assert tflow._resolve_method(*args) == jflow._resolve_method(*args)
    assert tflow._resolve_method("taps", 25) == "windows"
    assert tflow._resolve_method("taps", 31) == "gather"
    assert tflow._resolve_method("auto", 21, "cpu") == "gather"
    assert tflow._resolve_method("auto", 21, "cuda") == "taps"
    assert tflow._resolve_method("auto", 25, "cuda:0") == "windows"
    assert tflow._resolve_method("auto", 51, "cuda") == "gather"
    with pytest.raises(ValueError, match="unknown LK method"):
        tflow._resolve_method("pallas", 21)


def test_lk_large_window_routes_to_gather():
    rng = np.random.default_rng(51)
    img0 = _smooth(rng, 96, 128, (12, 16))
    img1 = np.roll(img0, 2, axis=1)
    pts = np.asarray([[48.0, 40.0], [70.0, 50.0]], np.float32)
    params = jflow.PyrLKParams(window=31, max_level=1)
    want, got, stats = _both(img0, img1, pts, "windows", params)
    assert stats["method"] == "gather"
    assert got.status.all()
    np.testing.assert_allclose(got.points.numpy(), np.asarray(want.points),
                               atol=1e-3)
    np.testing.assert_allclose(got.points.numpy()[:, 0] - pts[:, 0], 2.0,
                               atol=0.1)


def test_lk_singular_points_and_empty_set(pair):
    """A flat frame has no gradient: status false, the point stays. An
    empty point set gives empty results."""
    flat = np.full((64, 64), 7.0, np.float32)
    for method in METHODS:
        r = tflow.calc_optical_flow_pyr_lk(
            flat, flat, np.asarray([[30.0, 30.0]], np.float32), TPARAMS,
            method=method, device="cpu")
        assert not r.status.any()
        np.testing.assert_array_equal(r.points.numpy(), [[30.0, 30.0]])
        e = tflow.calc_optical_flow_pyr_lk(
            pair[0], pair[1], np.zeros((0, 2), np.float32), TPARAMS,
            method=method, device="cpu")
        assert e.points.shape == (0, 2) and e.status.shape == (0,)


def test_lk_counts_no_cpu_launch(pair):
    ck.reset_launch_counts()
    tflow.calc_optical_flow_pyr_lk(*pair, TPARAMS, method="taps",
                                   device="cpu")
    assert ck.LAUNCHES["windows"] == 0


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
@pytest.mark.parametrize("shape", [(37, 53), (40, 64, 3)])
def test_pyramids_exact(shape, dtype):
    """pyrdown / pyrup / gaussian_pyramid are shift-adds in the reference's
    order: bit-equal, odd sizes and channels included."""
    img = (np.random.default_rng(52).random(shape) * 255).astype(dtype)
    np.testing.assert_array_equal(
        tpyr.pyrdown(tensor(img)).numpy(),
        np.asarray(jpyr.pyrdown(jnp.asarray(img))))
    np.testing.assert_array_equal(
        tpyr.pyrup(tensor(img)).numpy(),
        np.asarray(jpyr.pyrup(jnp.asarray(img))))
    for lt, lj in zip(tpyr.gaussian_pyramid(tensor(img), 3),
                      jpyr.gaussian_pyramid(jnp.asarray(img), 3)):
        np.testing.assert_array_equal(lt.numpy(), np.asarray(lj))


def test_lk_default_device_needs_a_card(pair):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CUDA entry point runs")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tflow.calc_optical_flow_pyr_lk(*pair, TPARAMS)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tflow.build_lk_precomputed(pair[0], pair[1])
