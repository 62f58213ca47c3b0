"""The geometry half of item 15 against the JAX package on the CPU: the
5-point essential solver and ``estimate_relative_pose(solver="5pt")``,
ICP, and the public functions the port lacked in modules it had
(``epipolar_distance``, ``match_descriptors_f32``, ``match_by_projection``,
``num_hypotheses``).

The 5-point solver is float32-chaotic in both packages (a degree-10
polynomial fitted from sampled determinants, rooted by Durand-Kerner), so
it is held by the share of clean minimal sets solved, set by set beside
the reference, and the whole two-view by the reference's own gates and by
the pose it finds on the same draws. The rest is exact or within the
stated tolerance of float32 rounding.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from kornia_tpu.features import matching as jmatch
from kornia_tpu.geometry import epipolar as jepi
from kornia_tpu.geometry import icp as jicp
from kornia_tpu.geometry import liegroup as jlg
from kornia_tpu.geometry import ransac as jransac
from kornia_tpu.geometry import twoview as jtv
from kornia_tpu.geometry.essential5pt import essential_5pt as j5pt

from kornia_tpu_torch import convert
from kornia_tpu_torch.features import matching as tmatch
from kornia_tpu_torch.geometry import epipolar as tepi
from kornia_tpu_torch.geometry import icp as ticp
from kornia_tpu_torch.geometry import ransac as transac
from kornia_tpu_torch.geometry import twoview as ttv
from kornia_tpu_torch.geometry.essential5pt import essential_5pt as t5pt

torch.set_num_threads(1)

tensor = functools.partial(convert.tensor, device="cpu")
K = np.array([[500.0, 0, 320], [0, 500.0, 240], [0, 0, 1]], np.float32)


def _two_view_scene(rng, n=100, noise=0.3):
    """tests/test_geometry.py's TestEssential5pt scene."""
    pts = rng.uniform([-1, -1, 3], [1, 1, 7], (n, 3)).astype(np.float32)
    w = np.array([0.05, -0.1, 0.08], np.float32)
    r = np.asarray(jlg.so3_exp_matrix(jnp.asarray(w)))
    t = np.array([0.4, 0.1, -0.05], np.float32)
    t /= np.linalg.norm(t)
    p2 = pts @ r.T + t
    x1 = pts[:, :2] / pts[:, 2:] * 500 + [320, 240]
    x2 = p2[:, :2] / p2[:, 2:] * 500 + [320, 240]
    x1 += rng.normal(0, noise, x1.shape)
    x2 += rng.normal(0, noise, x2.shape)
    return x1.astype(np.float32), x2.astype(np.float32), r, t


def _rot_deg(r, r_true):
    return float(np.rad2deg(np.arccos(np.clip(
        (np.trace(r @ r_true.T) - 1) / 2, -1, 1))))


def _dir_deg(t, t_true):
    return float(np.rad2deg(np.arccos(np.clip(abs(float(t @ t_true)), -1,
                                              1))))


@pytest.fixture(scope="module")
def minimal_sets():
    """512 clean 8-point sets of the reference test's scene (its seed 3;
    it takes 8) in normalized coordinates, and the reference's batched
    solutions."""
    rng = np.random.default_rng(3)
    x1s, x2s = [], []
    for _ in range(512):
        x1, x2, _, _ = _two_view_scene(rng, n=8, noise=0.0)
        x1s.append((x1 - [320, 240]) / 500)
        x2s.append((x2 - [320, 240]) / 500)
    x1s = np.asarray(x1s, np.float32)
    x2s = np.asarray(x2s, np.float32)
    e_ref = np.asarray(jax.jit(j5pt)(jnp.asarray(x1s), jnp.asarray(x2s)))
    return x1s, x2s, e_ref


def _solved(e, x1, x2):
    """Sets whose E has an epipolar residual < 1e-3 on all 8 points and
    unit norm (a set with no finite candidate returns E = 0, whose
    residual is 0 too)."""
    p1 = np.concatenate([x1, np.ones(x1.shape[:-1] + (1,))], -1)
    p2 = np.concatenate([x2, np.ones(x2.shape[:-1] + (1,))], -1)
    res = np.abs(np.einsum("bni,bij,bnj->bn", p2, e, p1)).max(-1)
    return (res < 1e-3) & (np.abs(np.linalg.norm(e, axis=(1, 2)) - 1) < 1e-3)


def test_essential_5pt_minimal_sets_share_solved(minimal_sets):
    """The share of clean minimal sets solved (residual < 1e-3 and unit
    norm; the reference test's bar, tests/test_geometry.py:346-361, which
    takes 7 of 8) within 2% of the sets of the reference's own, and set by
    set both packages solve at least 80% of them. The 1e-3 bar sits at
    float32's edge for the degree-10 fit, so a set near it goes either way
    in either package: the reference's own routes differ by 7 of these 512
    sets (jit 448, eager 441, one set a call 446); the port solves 439,
    432 of them with the jitted reference. Where both solve, the two E
    agree up to sign within 0.05 (measured 0.046)."""
    x1s, x2s, e_ref = minimal_sets
    e = t5pt(tensor(x1s), tensor(x2s)).numpy()
    ok_ref = _solved(e_ref, x1s, x2s)
    ok = _solved(e, x1s, x2s)
    n = len(ok)
    assert ok.sum() >= ok_ref.sum() - 0.02 * n
    both = ok & ok_ref
    assert both.sum() >= 0.8 * n
    sign = np.sign(np.sum(e * e_ref, axis=(1, 2)))[:, None, None]
    assert np.abs(e * sign - e_ref)[both].max() < 0.05


def test_essential_5pt_batched_shapes():
    rng = np.random.default_rng(4)
    xn1 = rng.normal(0, 0.3, (16, 6, 2)).astype(np.float32)
    xn2 = rng.normal(0, 0.3, (16, 6, 2)).astype(np.float32)
    e = t5pt(tensor(xn1), tensor(xn2))
    assert e.shape == (16, 3, 3) and torch.isfinite(e).all()
    e2 = t5pt(tensor(xn1.reshape(2, 8, 6, 2)), tensor(xn2.reshape(2, 8, 6,
                                                                   2)))
    assert e2.shape == (2, 8, 3, 3) and torch.isfinite(e2).all()


@pytest.fixture(scope="module")
def five_point_scene():
    """The reference test's two-view scene (seed 5), the reference's
    whole 5-point two-view on PRNGKey(0), and its two draws as
    ``ransac`` takes them inside."""
    x1, x2, r, t = _two_view_scene(np.random.default_rng(5))
    key = jax.random.PRNGKey(0)
    params = jtv.TwoViewParams(solver="5pt")
    ref = jax.jit(lambda a, b, k: jtv.estimate_relative_pose(
        key, a, b, k, k, params=params))(jnp.asarray(x1), jnp.asarray(x2),
                                         jnp.asarray(K))
    kf, kh = jax.random.split(key)
    mask = jnp.ones(x1.shape[0], bool)
    idx_f = jransac.sample_minimal_sets(jax.random.split(kf)[0], len(x1),
                                        mask, params.n_hypotheses, 6)
    idx_h = jransac.sample_minimal_sets(jax.random.split(kh)[0], len(x1),
                                        mask, params.n_hypotheses, 4)
    return x1, x2, r, t, ref, (np.asarray(idx_f), np.asarray(idx_h))


def test_twoview_5pt_meets_the_reference_gates(five_point_scene):
    """``estimate_relative_pose(solver="5pt")`` with the port's own draw:
    the reference test's gates (> 80 inliers, rotation < 0.5°, direction
    < 3°)."""
    x1, x2, r_true, t_true, _, _ = five_point_scene
    res = ttv.estimate_relative_pose(
        x1, x2, K, K, params=ttv.TwoViewParams(solver="5pt"),
        generator=torch.Generator().manual_seed(0), device="cpu")
    assert int(res.n_inliers) > 80
    assert _rot_deg(res.rotation.numpy(), r_true) < 0.5
    assert _dir_deg(res.translation.numpy(), t_true) < 3.0


def test_twoview_5pt_on_reference_draws(five_point_scene):
    """On the reference's draws (``samples=`` (B, 6) and (B, 4)): the same
    model choice, inliers within 2 of the reference's and the pose within
    1e-3 rad / 1e-3 of it (both solves are float32; the Sampson LM
    polishes both to the same optimum)."""
    x1, x2, r_true, t_true, ref, samples = five_point_scene
    res = ttv.estimate_relative_pose(
        x1, x2, K, K, params=ttv.TwoViewParams(solver="5pt"),
        samples=samples, device="cpu")
    assert bool(res.use_homography) == bool(ref.use_homography)
    assert abs(int(res.n_inliers) - int(ref.n_inliers)) <= 2
    r = res.rotation.numpy()
    assert np.linalg.norm(r - np.asarray(ref.rotation)) / (2 * np.sqrt(2)) \
        < 1e-3
    np.testing.assert_allclose(res.translation.numpy(),
                               np.asarray(ref.translation), atol=1e-3)
    assert _rot_deg(r, r_true) < 0.5


def test_twoview_unknown_solver_raises():
    x1, x2, _, _ = _two_view_scene(np.random.default_rng(6), n=20)
    with pytest.raises(ValueError, match="solver"):
        ttv.estimate_relative_pose(x1, x2, K, K,
                                   params=ttv.TwoViewParams(solver="7pt"),
                                   device="cpu")


# --------------------------------------------------------------------------
# ICP
# --------------------------------------------------------------------------


def _icp_scene(seed=7, n=2000, deg=2.0, shift=(0.05, -0.03, 0.02),
               noise=0.004):
    """A seeded scan of ``n`` points on two bumpy surfaces, and the source:
    the first 70% of it moved by the inverse of a known rigid transform,
    with noise."""
    rng = np.random.default_rng(seed)
    u = rng.uniform(-1, 1, (n, 2))
    z = 0.2 * np.sin(3 * u[:, 0]) * np.cos(2 * u[:, 1])
    z[n // 2:] += 1.0 + 0.3 * u[n // 2:, 0]
    target = np.concatenate([u, z[:, None]], 1).astype(np.float32)
    ax = np.array([0.3, -0.5, 0.8])
    ax /= np.linalg.norm(ax)
    r = np.asarray(jlg.so3_exp_matrix(jnp.asarray(
        np.deg2rad(deg) * ax, jnp.float32)), np.float64)
    t = np.asarray(shift)
    src = (target[: int(0.7 * n)] - t) @ r       # R^T (x - t)
    src = src + rng.normal(0, noise, src.shape)
    return src.astype(np.float32), target, r, t


def test_nearest_neighbors_indices_equal_reference():
    """2000 × 2000 points: the indices exactly, the squared distances
    within 1e-5 of their scale (float32 sums of three products in another
    order; measured 3.8e-7 relative)."""
    rng = np.random.default_rng(8)
    a = rng.normal(size=(2000, 3)).astype(np.float32)
    b = rng.normal(size=(2000, 3)).astype(np.float32)
    idx_r, d_r = jicp.nearest_neighbors(jnp.asarray(a), jnp.asarray(b))
    idx, d = ticp.nearest_neighbors(tensor(a), tensor(b))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(idx_r))
    np.testing.assert_allclose(d.numpy(), np.asarray(d_r), rtol=0,
                               atol=1e-5 * float(np.asarray(d_r).max()))


@pytest.mark.parametrize("params", [
    dict(), dict(distance_threshold=0.03)],
    ids=["default", "threshold"])
def test_icp_vanilla_equals_reference(params):
    """R within 1e-5, t within 1e-5 relative and rmse within 1e-5 relative
    of the reference's, at ICPParams() and with a distance threshold (3 cm:
    the noise is 4 mm a coordinate, the start 5 cm off); both recover the
    known transform. Measured: R 1.2e-7; rmse 9.4e-6 relative with the
    threshold, as each squared distance is |a|² + |b|² − 2ab, a difference
    of terms ~2e4 times larger, one float32 rounding of which is ~3e-3 of
    it."""
    src, dst, r_true, t_true = _icp_scene()
    ref = jicp.icp_vanilla(jnp.asarray(src), jnp.asarray(dst),
                           jicp.ICPParams(**params))
    got = ticp.icp_vanilla(src, dst, convert.icp_params(params),
                           device="cpu")
    np.testing.assert_allclose(got.rotation.numpy(),
                               np.asarray(ref.rotation), rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.translation.numpy(),
                               np.asarray(ref.translation), rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_allclose(float(got.rmse), float(ref.rmse), rtol=1e-5)
    assert bool(got.converged) == bool(ref.converged)
    assert int(got.num_iterations) == int(ref.num_iterations)
    assert np.abs(got.rotation.numpy() - r_true).max() < 2e-3
    assert np.abs(got.translation.numpy() - t_true).max() < 2e-3


# --------------------------------------------------------------------------
# the public functions the port lacked
# --------------------------------------------------------------------------


def test_epipolar_distance_equals_reference():
    """Within 1e-6 relative (float32 products in einsum's order)."""
    rng = np.random.default_rng(9)
    f = rng.normal(size=(4, 3, 3)).astype(np.float32)
    x1 = rng.uniform(0, 640, (4, 50, 2)).astype(np.float32)
    x2 = rng.uniform(0, 480, (4, 50, 2)).astype(np.float32)
    ref = np.asarray(jepi.epipolar_distance(jnp.asarray(f), jnp.asarray(x1),
                                            jnp.asarray(x2)))
    got = tepi.epipolar_distance(tensor(f), tensor(x1), tensor(x2)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6)


@pytest.mark.parametrize("ratio,cross_check,masked", [
    (0.8, True, False), (None, False, True), (0.9, True, True)])
def test_match_descriptors_f32_equals_reference(ratio, cross_check, masked):
    """Indices and mask exactly. The squared distance is |a|² + |b|² − 2ab
    in float32, each term ~20× the result, summed in another order by each
    package: held within 1e-6 of |a|² + max |b|² (measured 5e-6 relative to
    the distance itself, 2.5e-7 of that scale)."""
    rng = np.random.default_rng(10)
    a = rng.normal(size=(150, 32)).astype(np.float32)
    b = np.concatenate([a[:100] + rng.normal(0, 0.3, (100, 32)),
                        rng.normal(size=(120, 32))]).astype(np.float32)
    am = rng.random(150) > 0.1 if masked else None
    bm = rng.random(220) > 0.1 if masked else None
    ref = jmatch.match_descriptors_f32(
        jnp.asarray(a), jnp.asarray(b), ratio=ratio, cross_check=cross_check,
        a_mask=None if am is None else jnp.asarray(am),
        b_mask=None if bm is None else jnp.asarray(bm))
    got = tmatch.match_descriptors_f32(a, b, ratio=ratio,
                                       cross_check=cross_check, a_mask=am,
                                       b_mask=bm, device="cpu")
    np.testing.assert_array_equal(got.idx.numpy(), np.asarray(ref.idx))
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(ref.mask))
    scale = (a * a).sum(1) + (b * b).sum(1).max()
    d2, d2_ref = got.dist.numpy() ** 2, np.asarray(ref.dist) ** 2
    fin = np.isfinite(d2_ref)
    np.testing.assert_array_equal(np.isfinite(d2), fin)
    assert (np.abs(d2[fin] - d2_ref[fin]) <= 1e-6 * scale[fin]).all()
    assert int(got.mask.sum()) > 40


def test_match_by_projection_equals_reference():
    """300 map points against 400 keypoints (the projections of 250 of
    them with noise, and clutter), descriptors with flipped bits, masks on
    both sides; several keypoints claimed twice: exact."""
    rng = np.random.default_rng(11)
    pts = rng.uniform([-2, -1.5, 3], [2, 1.5, 8], (300, 3)).astype(
        np.float32)
    pose7 = np.asarray(jlg.se3_exp(jnp.asarray(
        [0.05, -0.02, 0.1, 0.01, -0.02, 0.015], jnp.float32)))
    cam = np.asarray(jlg.se3_apply(jnp.asarray(pose7)[None],
                                   jnp.asarray(pts)))
    uv = cam[:, :2] / cam[:, 2:] * 500 + [320, 240]
    xy = np.concatenate([uv[:250] + rng.normal(0, 2, (250, 2)),
                         rng.uniform(0, 640, (150, 2))]).astype(np.float32)
    xy[250:260] = xy[:10] + 1.0                  # second claimants
    pbits = rng.integers(0, 2, (300, 256)).astype(np.uint8)
    fbits = np.concatenate([pbits[:250], rng.integers(0, 2, (150, 256))
                            ]).astype(np.uint8)
    flip = rng.random(fbits.shape) < 0.05
    fbits = np.where(flip, 1 - fbits, fbits).astype(np.uint8)
    fbits[250:260] = fbits[:10]
    pm = rng.random(300) > 0.05
    fm = rng.random(400) > 0.05
    ref = jmatch.match_by_projection(
        jnp.asarray(pts), jnp.asarray(pbits), jnp.asarray(pose7),
        jnp.asarray(K), jnp.asarray(xy), jnp.asarray(fbits), radius_px=12.0,
        max_distance=50.0, point_mask=jnp.asarray(pm),
        frame_mask=jnp.asarray(fm))
    got = tmatch.match_by_projection(pts, pbits, pose7, K, xy, fbits,
                                     radius_px=12.0, max_distance=50.0,
                                     point_mask=pm, frame_mask=fm,
                                     device="cpu")
    for name in ("idx", "dist", "mask"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(ref, name)))
    assert int(got.mask.sum()) > 150


@pytest.mark.parametrize("s,ratio,conf", [(8, 0.3, 0.999), (4, 0.5, 0.99),
                                          (6, 0.9, 0.999), (1, 0.99, 0.5),
                                          (12, 0.1, 0.9999)])
def test_num_hypotheses_equals_reference(s, ratio, conf):
    assert transac.num_hypotheses(s, ratio, conf) == \
        jransac.num_hypotheses(s, ratio, conf)
