"""The port's two-view geometry (kornia_tpu_torch/geometry, optim/lm.py)
against the JAX package on seed-made synthetic scenes. RANSAC draws come
from ``jax.random`` in the reference; the port is handed the reference's
own draws through ``samples=`` / ``sample_idx=``."""

import dataclasses
import functools

import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

import jax
import jax.numpy as jnp

from kornia_tpu.geometry import camera as jcam
from kornia_tpu.geometry import epipolar as jepi
from kornia_tpu.geometry import linalg as jla
from kornia_tpu.geometry import liegroup as jlg
from kornia_tpu.geometry import ransac as jransac
from kornia_tpu.geometry import refine as jrefine
from kornia_tpu.geometry import triangulation as jtri
from kornia_tpu.geometry import twoview as jtv

from kornia_tpu_torch import convert
from kornia_tpu_torch.geometry import camera as tcam
from kornia_tpu_torch.geometry import epipolar as tepi
from kornia_tpu_torch.geometry import linalg as tla
from kornia_tpu_torch.geometry import liegroup as tlg
from kornia_tpu_torch.geometry import ransac as transac
from kornia_tpu_torch.geometry import refine as trefine
from kornia_tpu_torch.geometry import triangulation as ttri
from kornia_tpu_torch.geometry import twoview as ttv

# One intra-op thread: these tests run many small ops, and torch's pool
# of a thread per core spins against the other test processes.
torch.set_num_threads(1)

PARAMS = jtv.TwoViewParams(n_hypotheses=64, refine_iters=4)
TPARAMS = convert.twoview_params(dataclasses.asdict(PARAMS))
T = functools.partial(convert.tensor, device="cpu")


def make_scene(seed=0, n=200, noise=0.0, outlier_frac=0.0, planar=False):
    """Random 3D points (or a plane), known relative pose, pixels."""
    rng = np.random.default_rng(seed)
    hi_z = 5.0001 if planar else 10.0
    lo_z = 5.0 if planar else 4.0
    pts = rng.uniform([-2, -2, lo_z], [2, 2, hi_z], size=(n, 3))
    k = np.array([[500.0, 0, 320], [0, 500.0, 240], [0, 0, 1]], np.float32)
    r = Rotation.from_euler("xyz", [5, -8, 3], degrees=True).as_matrix()
    t = np.array([0.5, 0.1, 0.05])
    t = t / np.linalg.norm(t)

    def project(p, rr, tt):
        c = p @ rr.T + tt
        return (c[:, :2] / c[:, 2:]) * [k[0, 0], k[1, 1]] + [k[0, 2], k[1, 2]]

    x1 = project(pts, np.eye(3), np.zeros(3))
    x2 = project(pts, r, t)
    if noise > 0:
        x1 = x1 + rng.normal(0, noise, x1.shape)
        x2 = x2 + rng.normal(0, noise, x2.shape)
    n_out = int(n * outlier_frac)
    if n_out:
        idx = rng.choice(n, n_out, replace=False)
        x2[idx] = rng.uniform([0, 0], [640, 480], size=(n_out, 2))
    return (x1.astype(np.float32), x2.astype(np.float32), k,
            r.astype(np.float32), t.astype(np.float32))


def rot_angle(r_a, r_b):
    """Angle of R_aᵀR_b in float64, from the chord ‖R_a − R_b‖_F =
    2√2·sin(θ/2), which keeps its precision at small angles."""
    d = np.linalg.norm(np.asarray(r_a, np.float64) - np.asarray(r_b,
                                                                  np.float64))
    return float(2 * np.arcsin(min(d / (2 * np.sqrt(2)), 1.0)))


def dir_angle(t_a, t_b):
    a = np.asarray(t_a, np.float64) / np.linalg.norm(t_a)
    b = np.asarray(t_b, np.float64) / np.linalg.norm(t_b)
    return float(2 * np.arcsin(min(np.linalg.norm(a - b) / 2, 1.0)))


def _np(x):
    return np.asarray(x)


def _ref_samples(key, n, mask, params):
    """The draws the reference makes inside estimate_relative_pose:
    kf, kh = split(key) (twoview.py:76), then sample_minimal_sets(
    split(k)[0], ...) inside ransac (ransac.py:87-88)."""
    kf, kh = jax.random.split(key)
    m = jnp.asarray(mask)
    idx_f = jransac.sample_minimal_sets(jax.random.split(kf)[0], n, m,
                                        params.n_hypotheses, 8)
    idx_h = jransac.sample_minimal_sets(jax.random.split(kh)[0], n, m,
                                        params.n_hypotheses, 4)
    return T(_np(idx_f)), T(_np(idx_h))


# --------------------------------------------------------------------------
# building blocks
# --------------------------------------------------------------------------


def test_linalg_blocks():
    rng = np.random.default_rng(1)
    m = rng.normal(size=(16, 3, 3)).astype(np.float32)
    np.testing.assert_allclose(tla.inv3x3(T(m)).numpy(),
                               _np(jla.inv3x3(jnp.asarray(m))),
                               rtol=1e-5, atol=1e-5)
    a = rng.normal(size=(5, 5)).astype(np.float32)
    a = a @ a.T + np.eye(5, dtype=np.float32)
    b = rng.normal(size=5).astype(np.float32)
    np.testing.assert_allclose(
        tla.solve_cholesky_damped(T(a), T(b), 1e-3).numpy(),
        _np(jla.solve_cholesky_damped(jnp.asarray(a), jnp.asarray(b),
                                      1e-3)), rtol=1e-4, atol=1e-5)
    # not positive definite: NaN, as the reference, not an exception
    bad = -np.eye(5, dtype=np.float32)
    assert torch.isnan(tla.solve_cholesky(T(bad), T(b))).all()
    x = rng.normal(size=(7, 2)).astype(np.float32)
    np.testing.assert_array_equal(tla.homogenize(T(x)).numpy(),
                                  _np(jla.homogenize(jnp.asarray(x))))


def test_so3_exp_and_normalize_points():
    rng = np.random.default_rng(2)
    w = np.concatenate([rng.normal(size=(8, 3)) * 0.3,
                        np.zeros((1, 3)), np.full((1, 3), 1e-5)]).astype(
        np.float32)
    np.testing.assert_allclose(tlg.so3_exp_matrix(T(w)).numpy(),
                               _np(jlg.so3_exp_matrix(jnp.asarray(w))),
                               atol=2e-6)
    k = np.array([[458.6, 0, 367.2], [0, 457.3, 248.4], [0, 0, 1]],
                 np.float32)
    px = rng.uniform(0, 700, (20, 2)).astype(np.float32)
    np.testing.assert_allclose(
        tcam.normalize_points(T(px), T(k)).numpy(),
        _np(jcam.normalize_points(jnp.asarray(px), jnp.asarray(k))),
        rtol=1e-6, atol=1e-7)


def test_minimal_solvers_batched():
    """Batched 8-point F and 4-point H on minimal samples (Cramer null
    vector, closed-form rank-2 projection): f32 tolerance, sign-free."""
    x1, x2, k, r, t = make_scene(3, n=64)
    rng = np.random.default_rng(3)
    idx8 = np.stack([rng.choice(64, 8, replace=False) for _ in range(32)])
    idx4 = idx8[:, :4]
    f_ref = _np(jepi.fundamental_8pt(jnp.asarray(x1[idx8]),
                                     jnp.asarray(x2[idx8])))
    f_got = tepi.fundamental_8pt(T(x1[idx8]), T(x2[idx8])).numpy()
    sgn = np.sign(np.sum(f_ref * f_got, axis=(1, 2)))[:, None, None]
    np.testing.assert_allclose(f_got * sgn, f_ref, atol=2e-4)
    h_ref = _np(jepi.homography_dlt(jnp.asarray(x1[idx4]),
                                    jnp.asarray(x2[idx4])))
    h_got = tepi.homography_dlt(T(x1[idx4]), T(x2[idx4])).numpy()
    np.testing.assert_allclose(h_got, h_ref, rtol=2e-3, atol=2e-3)


def test_weighted_refits_and_residuals():
    """The over-determined (eigh) branch of the LO refits, and the two
    residuals."""
    x1, x2, k, r, t = make_scene(4, n=120, noise=0.3)
    w = (np.random.default_rng(4).random(120) > 0.2).astype(np.float32)
    f_ref = _np(jepi.fundamental_8pt(jnp.asarray(x1)[None],
                                     jnp.asarray(x2)[None],
                                     jnp.asarray(w)[None]))[0]
    f_got = tepi.fundamental_8pt(T(x1)[None], T(x2)[None],
                                 T(w)[None])[0].numpy()
    f_got = f_got * np.sign(np.sum(f_got * f_ref))
    np.testing.assert_allclose(f_got, f_ref, atol=1e-4)
    h_ref = _np(jepi.homography_dlt(jnp.asarray(x1)[None],
                                    jnp.asarray(x2)[None],
                                    jnp.asarray(w)[None]))[0]
    h_got = tepi.homography_dlt(T(x1)[None], T(x2)[None],
                                T(w)[None])[0].numpy()
    np.testing.assert_allclose(h_got, h_ref, rtol=1e-3, atol=1e-3)
    s_ref = _np(jepi.sampson_distance(jnp.asarray(f_ref), jnp.asarray(x1),
                                      jnp.asarray(x2)))
    s_got = tepi.sampson_distance(T(f_ref), T(x1), T(x2)).numpy()
    np.testing.assert_allclose(s_got, s_ref, rtol=1e-4, atol=1e-6)
    e_ref = _np(jepi.homography_transfer_error(
        jnp.asarray(h_ref), jnp.asarray(x1), jnp.asarray(x2)))
    e_got = tepi.homography_transfer_error(T(h_ref), T(x1), T(x2)).numpy()
    np.testing.assert_allclose(e_got, e_ref, rtol=1e-4, atol=1e-4)
    # a zero F is a rejection, not a perfect fit
    z = tepi.sampson_distance(torch.zeros(3, 3), T(x1), T(x2))
    assert (z == 1e12).all()


def test_decompositions_and_triangulation():
    x1, x2, k, r, t = make_scene(5, n=80)
    f = _np(jepi.fundamental_8pt(jnp.asarray(x1), jnp.asarray(x2)))
    e_ref = _np(jepi.essential_from_fundamental(jnp.asarray(f),
                                                jnp.asarray(k),
                                                jnp.asarray(k)))
    e_got = tepi.essential_from_fundamental(T(f), T(k), T(k)).numpy()
    np.testing.assert_allclose(e_got * np.sign(np.sum(e_got * e_ref)),
                               e_ref, atol=1e-4)
    rs, ts = tepi.decompose_essential(T(e_ref))
    # the true (R, t) is among the four candidates
    errs = [rot_angle(rs[i].numpy(), r) + dir_angle(ts[i].numpy(), t)
            for i in range(4)]
    assert min(errs) < 2e-3
    rs_j, ts_j = jepi.decompose_essential(jnp.asarray(e_ref))
    for i in range(4):
        assert min(rot_angle(_np(rs_j[i]), rs[j].numpy())
                   for j in range(4)) < 1e-3
    h = _np(jepi.homography_dlt(jnp.asarray(x1[:4]), jnp.asarray(x2[:4])))
    rh, th, nh = tepi.decompose_homography(T(h), T(k), T(k))
    rh_j, th_j, nh_j = jepi.decompose_homography(jnp.asarray(h),
                                                 jnp.asarray(k),
                                                 jnp.asarray(k))
    np.testing.assert_allclose(rh.numpy(), _np(rh_j), atol=1e-3)
    np.testing.assert_allclose(th.numpy(), _np(th_j), atol=1e-3)
    eye = np.eye(3, dtype=np.float32)
    p1 = _np(jtri.projection_matrix(jnp.asarray(eye),
                                    jnp.zeros(3, jnp.float32),
                                    jnp.asarray(k)))
    p2 = _np(jtri.projection_matrix(jnp.asarray(r), jnp.asarray(t),
                                    jnp.asarray(k)))
    np.testing.assert_allclose(
        ttri.projection_matrix(T(r), T(t), T(k)).numpy(), p2, rtol=1e-6)
    x_ref = _np(jtri.triangulate_dlt(jnp.asarray(p1), jnp.asarray(p2),
                                     jnp.asarray(x1), jnp.asarray(x2)))
    x_got = ttri.triangulate_dlt(T(p1), T(p2), T(x1), T(x2)).numpy()
    np.testing.assert_allclose(x_got, x_ref, rtol=1e-3, atol=1e-3)
    xn1 = _np(jcam.normalize_points(jnp.asarray(x1), jnp.asarray(k)))
    xn2 = _np(jcam.normalize_points(jnp.asarray(x2), jnp.asarray(k)))
    v_ref = _np(jax.vmap(lambda rr, tt: jtri.count_cheirality(
        rr, tt, jnp.asarray(xn1), jnp.asarray(xn2)))(rs_j, ts_j))
    v_got = ttri.count_cheirality(T(_np(rs_j)), T(_np(ts_j)), T(xn1),
                                  T(xn2)).numpy()
    np.testing.assert_array_equal(v_got, v_ref)


def test_sample_minimal_sets_valid():
    mask = np.ones(50, bool)
    mask[::3] = False
    gen = torch.Generator().manual_seed(0)
    idx = transac.sample_minimal_sets(gen, 50, T(mask), 200, 8).numpy()
    assert idx.shape == (200, 8)
    assert mask[idx].all()
    assert all(len(set(row)) == 8 for row in idx)
    # every valid point gets drawn
    assert set(idx.ravel()) == set(np.nonzero(mask)[0])


def test_ransac_with_reference_samples():
    """Given the reference's draws, the same winner: equal inlier sets up
    to ±2 points near the threshold."""
    x1, x2, k, r, t = make_scene(6, n=150, noise=0.5, outlier_frac=0.3)
    key = jax.random.PRNGKey(3)
    mask = np.ones(150, bool)
    ref = jransac.ransac(
        key, jnp.asarray(x1), jnp.asarray(x2),
        solver_fn=lambda a, b, weights=None: jepi.fundamental_8pt(a, b,
                                                                  weights),
        residual_fn=jepi.sampson_distance, sample_size=8, threshold=1.5,
        n_hypotheses=64)
    idx = jransac.sample_minimal_sets(jax.random.split(key)[0], 150,
                                      jnp.asarray(mask), 64, 8)
    got = transac.ransac(
        None, T(x1), T(x2),
        solver_fn=lambda a, b, weights=None: tepi.fundamental_8pt(a, b,
                                                                  weights),
        residual_fn=tepi.sampson_distance, sample_size=8, threshold=1.5,
        n_hypotheses=64, sample_idx=T(_np(idx)))
    assert abs(int(got.n_inliers) - int(ref.n_inliers)) <= 2
    assert (got.inliers.numpy() != _np(ref.inliers)).sum() <= 2


def test_refine_pose_sampson():
    """Sampson LM (torch.func.jacfwd) from a perturbed pose: same polish
    as the reference within 1e-4 rad / 1e-3 rad."""
    x1, x2, k, r, t = make_scene(7, n=120, noise=0.5)
    r0 = (Rotation.from_rotvec([0.004, -0.003, 0.002]).as_matrix()
          @ r).astype(np.float32)
    t0 = (t + np.array([0.02, -0.03, 0.01], np.float32))
    inl = np.ones(120, bool)
    rr, tr = jrefine.refine_pose_sampson(
        jnp.asarray(r0), jnp.asarray(t0), jnp.asarray(x1), jnp.asarray(x2),
        jnp.asarray(k), jnp.asarray(k), jnp.asarray(inl), iters=6)
    rg, tg = trefine.refine_pose_sampson(T(r0), T(t0), T(x1), T(x2), T(k),
                                         T(k), T(inl), iters=6)
    assert rot_angle(rg.numpy(), _np(rr)) < 1e-4
    assert dir_angle(tg.numpy(), _np(tr)) < 1e-3
    assert rot_angle(rg.numpy(), r) < rot_angle(r0, r)


# --------------------------------------------------------------------------
# the two-view bootstrap
# --------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["general", "planar"])
def test_estimate_relative_pose_matches_reference(case):
    """With the reference's own draws: the same model choice, R within
    1e-4 rad, t direction within 1e-3 rad, n_inliers within ±2."""
    if case == "general":
        x1, x2, k, r, t = make_scene(9, n=200, noise=0.5, outlier_frac=0.3)
    else:
        x1, x2, k, r, t = make_scene(10, n=150, planar=True, noise=0.3)
    key = jax.random.PRNGKey(0)
    mask = np.ones(len(x1), bool)
    mask[-7:] = False
    ref = jtv.estimate_relative_pose(
        key, jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(k),
        jnp.asarray(k), mask=jnp.asarray(mask), params=PARAMS)
    got = ttv.estimate_relative_pose(
        x1, x2, k, k, mask=mask, params=TPARAMS,
        samples=_ref_samples(key, len(x1), mask, PARAMS), device="cpu")
    assert bool(got.use_homography) == bool(ref.use_homography)
    assert bool(got.use_homography) == (case == "planar")
    assert rot_angle(got.rotation.numpy(), _np(ref.rotation)) < 1e-4
    assert dir_angle(got.translation.numpy(), _np(ref.translation)) < 1e-3
    assert abs(int(got.n_inliers) - int(ref.n_inliers)) <= 2
    assert got.points3d.shape == (len(x1), 3)
    assert rot_angle(got.rotation.numpy(), r) < np.deg2rad(1.0)


def test_estimate_relative_pose_own_generator():
    """With the port's own torch.Generator draw: recovers the pose."""
    x1, x2, k, r, t = make_scene(11, n=200, noise=0.5, outlier_frac=0.3)
    got = ttv.estimate_relative_pose(
        x1, x2, k, k, params=TPARAMS,
        generator=torch.Generator().manual_seed(0), device="cpu")
    assert not bool(got.use_homography)
    assert int(got.n_inliers) > 100
    assert np.degrees(rot_angle(got.rotation.numpy(), r)) < 0.5
    assert np.degrees(dir_angle(got.translation.numpy(), t)) < 2.0
