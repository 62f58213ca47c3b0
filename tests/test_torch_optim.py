"""The port's SLAM optimisers (kornia_tpu_torch/optim: losses, LM, Schur
bundle adjustment with dense and PCG solves, pose-graph optimisation)
against the JAX package's, on the CPU. The scenes are the reference
tests' own generators at their small sizes (copied): a 6-pose × 120-point
BA scene, the PCG scene cut to 24 poses, the 12-pose PGO ring. Inputs
are made with numpy from a seed and fed to both packages.

Where the two packages add the same float32 terms in another order
(``index_add_`` against XLA's ``segment_sum``, cuBLAS/MKL against XLA's
dot), results differ by rounding; each comparison states its tolerance
and why, none looser than the reference's own bound for two summation
orders of the same problem (tests/test_optim.py: initial cost rtol 1e-4,
final cost rtol 0.05, poses atol 1e-3 after 10 LM iterations)."""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from kornia_tpu.geometry import liegroup as jlg
from kornia_tpu.optim import ba as jba
from kornia_tpu.optim import lm as jlm
from kornia_tpu.optim import losses as jlosses
from kornia_tpu.optim import pgo as jpgo

from kornia_tpu_torch import convert
from kornia_tpu_torch.optim import ba as tba
from kornia_tpu_torch.optim import lm as tlm
from kornia_tpu_torch.optim import losses as tlosses
from kornia_tpu_torch.optim import pgo as tpgo

# One intra-op thread: these tests run many small ops, and torch's pool
# of a thread per core spins against the other test processes.
torch.set_num_threads(1)

T = functools.partial(convert.tensor, device="cpu")


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _rel(got, ref):
    """max |got − ref| relative to max |ref|."""
    got, ref = _np(got).astype(np.float64), _np(ref).astype(np.float64)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30))


# ---------------------------------------------------------------------------
# scenes (copies of tests/test_optim.py's generators)
# ---------------------------------------------------------------------------


def make_ba_scene(seed=0, n_poses=6, n_points=120, noise_px=1.0,
                  pose_noise=0.05):
    from scipy.spatial.transform import Rotation

    rng = np.random.default_rng(seed)
    k = np.array([[500.0, 0, 320], [0, 500.0, 240], [0, 0, 1]], np.float32)
    pts = rng.uniform([-3, -2, 6], [3, 2, 12],
                      size=(n_points, 3)).astype(np.float32)
    poses_gt = []
    for i in range(n_poses):
        w = rng.normal(0, 0.03, 3).astype(np.float32)
        t = (np.array([0.4 * i, 0.02 * i, 0.0], np.float32)
             + rng.normal(0, 0.01, 3).astype(np.float32))
        q = np.asarray(jlg.so3_exp(jnp.asarray(w)))
        poses_gt.append(np.concatenate(
            [q, -Rotation.from_quat(np.roll(q, -1)).as_matrix() @ t]))
    poses_gt = np.stack(poses_gt).astype(np.float32)

    obs_cam, obs_pt, obs_uv = [], [], []
    for c in range(n_poses):
        pc = np.asarray(jlg.se3_apply(jnp.asarray(poses_gt[c])[None],
                                      jnp.asarray(pts)))
        uv = pc[:, :2] / pc[:, 2:] * [k[0, 0], k[1, 1]] + [k[0, 2], k[1, 2]]
        vis = ((pc[:, 2] > 0.1) & (uv[:, 0] > 0) & (uv[:, 0] < 640)
               & (uv[:, 1] > 0) & (uv[:, 1] < 480))
        idx = np.nonzero(vis)[0]
        obs_cam += [c] * len(idx)
        obs_pt += list(idx)
        obs_uv += list(uv[idx] + rng.normal(0, noise_px, (len(idx), 2)))
    obs_cam = np.array(obs_cam, np.int32)
    obs_pt = np.array(obs_pt, np.int32)
    obs_uv = np.array(obs_uv, np.float32)

    poses_init = poses_gt.copy()
    for c in range(1, n_poses):
        d = rng.normal(0, pose_noise, 6).astype(np.float32)
        poses_init[c] = np.asarray(jlg.se3_retract(jnp.asarray(poses_gt[c]),
                                                   jnp.asarray(d)))
    pts_init = pts + rng.normal(0, 0.05, pts.shape).astype(np.float32)
    fixed = np.zeros(n_poses, bool)
    fixed[0] = True
    return (poses_gt, poses_init, pts, pts_init, k, obs_cam, obs_pt, obs_uv,
            fixed)


def make_pcg_scene(n_poses=24, n_points=600, seed=3):
    """tests/test_optim.py's PCG scene (cameras on a line before a point
    cloud, ≤ 80 observations each), cut from 120 poses to 24."""
    rng = np.random.default_rng(seed)
    k = np.asarray([[400.0, 0, 320], [0, 400, 240], [0, 0, 1]], np.float32)
    pts = rng.uniform([-5, -5, 8], [5, 5, 16], (n_points, 3)).astype(
        np.float32)
    poses = np.asarray([np.concatenate([[1, 0, 0, 0],
                                        -np.array([0.05 * i, 0.0, 0.0])])
                        for i in range(n_poses)], np.float32)
    obs_cam, obs_pt, obs_uv = [], [], []
    for c in range(n_poses):
        cam = pts + poses[c, 4:7]
        uv = cam[:, :2] / cam[:, 2:] * [400, 400] + [320, 240]
        vis = ((uv[:, 0] > 0) & (uv[:, 0] < 640)
               & (uv[:, 1] > 0) & (uv[:, 1] < 480))
        ids = np.nonzero(vis)[0][:80]
        obs_cam += [c] * len(ids)
        obs_pt += list(ids)
        obs_uv += list(uv[ids] + rng.normal(0, 0.5, (len(ids), 2)))
    poses_noisy = poses.copy()
    poses_noisy[1:, 4:7] += rng.normal(0, 0.05, (n_poses - 1, 3))
    pts_noisy = pts + rng.normal(0, 0.1, pts.shape).astype(np.float32)
    fixed = np.zeros(n_poses, bool)
    fixed[0] = True
    return (poses_noisy, pts_noisy, k, np.asarray(obs_cam, np.int32),
            np.asarray(obs_pt, np.int32), np.asarray(obs_uv, np.float32),
            fixed)


def make_loop(n=12, drift=0.02, seed=0):
    """tests/test_optim.py's PGO ring: a circle of n poses, drifted
    odometry edges and one exact loop-closure edge."""
    rng = np.random.default_rng(seed)
    poses_gt = []
    for i in range(n):
        ang = 2 * np.pi * i / n
        q = np.asarray(jlg.so3_exp(jnp.asarray([0, 0, ang], jnp.float32)))
        t = np.array([np.cos(ang), np.sin(ang), 0], np.float32)
        poses_gt.append(np.concatenate([q, t]).astype(np.float32))
    poses_gt = np.stack(poses_gt)
    edges_i, edges_j, meas = [], [], []
    for i in range(n - 1):
        rel = jlg.se3_compose(jnp.asarray(poses_gt[i + 1]),
                              jlg.se3_inverse(jnp.asarray(poses_gt[i])))
        noise = jnp.asarray(rng.normal(0, drift, 6).astype(np.float32))
        meas.append(np.asarray(jlg.se3_compose(jlg.se3_exp(noise), rel)))
        edges_i.append(i)
        edges_j.append(i + 1)
    meas.append(np.asarray(jlg.se3_compose(
        jnp.asarray(poses_gt[0]), jlg.se3_inverse(jnp.asarray(
            poses_gt[n - 1])))))
    edges_i.append(n - 1)
    edges_j.append(0)
    init = [poses_gt[0]]
    for i in range(n - 1):
        init.append(np.asarray(jlg.se3_compose(jnp.asarray(meas[i]),
                                               jnp.asarray(init[i]))))
    return (poses_gt, np.stack(init).astype(np.float32),
            np.array(edges_i, np.int32), np.array(edges_j, np.int32),
            np.stack(meas).astype(np.float32))


def _both(*args, **kwargs):
    """The reference's BAProblem and the port's, built from the same
    inputs."""
    return (jba.build_problem(*args, **kwargs),
            tba.build_problem(*args, **kwargs, device="cpu"))


@pytest.fixture(scope="module")
def scene():
    return make_ba_scene(noise_px=0.5)


@pytest.fixture(scope="module")
def problems(scene):
    _, poses_init, _, pts_init, k, oc, op, ouv, fixed = scene
    return _both(poses_init, pts_init, k, oc, op, ouv, fixed_poses=fixed)


PARAMS = dict(loss="huber", loss_scale=2.0)


# ---------------------------------------------------------------------------
# losses, LM
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["identity", "huber", "cauchy", "tukey"])
@pytest.mark.parametrize("scale", [1.0, 2.0])
def test_losses_equal_reference(name, scale):
    """Bit-equal: the same float32 ops in the same order. Huber alone
    within 1 ULP: ATen's vectorised CPU sqrt is not always correctly
    rounded (1 of these 257 values; the card's sqrtf is)."""
    sq = np.random.default_rng(0).exponential(3.0, 257).astype(np.float32)
    sq[:4] = [0.0, 1e-20, scale * scale, 1.0]
    ref = np.asarray(jlosses.LOSSES[name](jnp.asarray(sq), scale))
    got = tlosses.LOSSES[name](T(sq), scale)
    assert got.dtype == torch.float32
    if name == "huber":
        np.testing.assert_array_max_ulp(_np(got), ref, maxulp=1)
    else:
        np.testing.assert_array_equal(_np(got), ref)


def test_lm_optimize_matches_reference():
    """y = exp(a x + b) fit: both reach (0.8, 0.2) within 1e-4 (the
    reference test's bound); params within 1e-5 of each other and cost
    < 1e-8 (float32 exp rounding differs between XLA and ATen)."""
    xs = np.linspace(0, 1, 30).astype(np.float32)
    ys = np.exp(0.8 * xs + 0.2).astype(np.float32)
    ref = jlm.lm_optimize(lambda p: jnp.exp(p[0] * xs + p[1]) - ys,
                          jnp.asarray([0.0, 0.0]), max_iterations=30)
    xt, yt = T(xs), T(ys)
    got = tlm.lm_optimize(lambda p: torch.exp(p[0] * xt + p[1]) - yt,
                          torch.zeros(2), max_iterations=30)
    np.testing.assert_allclose(_np(got.params), [0.8, 0.2], atol=1e-4)
    np.testing.assert_allclose(_np(got.params), _np(ref.params), atol=1e-5)
    assert float(got.cost) < 1e-8
    assert bool(got.converged) == bool(ref.converged)
    assert float(got.initial_cost) == pytest.approx(float(ref.initial_cost),
                                                    rel=1e-6)
    assert tlm.TerminationReason("cost_tolerance").name == "COST_TOLERANCE"


# ---------------------------------------------------------------------------
# build_problem
# ---------------------------------------------------------------------------


def _build_case(case, scene):
    _, poses_init, _, pts_init, k, oc, op, ouv, fixed = scene
    rng = np.random.default_rng(7)
    m, n = len(oc), len(pts_init)
    # unsorted observations, so the stable sort matters
    perm = rng.permutation(m)
    oc, op, ouv = oc[perm], op[perm], ouv[perm]
    args = (poses_init, pts_init, k, oc, op, ouv)
    if case == "plain":
        return args, dict(fixed_poses=fixed)
    if case == "priors_rgbd":
        sigma = rng.uniform(0.1, 1.0, len(poses_init)).astype(np.float32)
        sigma[2] = np.nan                                # no prior
        sigma[3] = -1.0                                  # no prior
        center = rng.normal(0, 1, (len(poses_init), 3)).astype(np.float32)
        center[4] = np.nan
        return args, dict(
            fixed_poses=fixed, obs_depth=rng.uniform(5, 12, m),
            obs_depth_w=rng.uniform(0, 2, m), pose_prior_center=center,
            pose_prior_sigma=sigma)
    if case == "max_obs_per_point":
        return args, dict(fixed_poses=fixed, max_obs_per_point=3,
                          obs_w=rng.uniform(0.5, 1.0, m))
    if case == "exact_1024":
        keep = np.arange(1024) % m
        return ((poses_init, pts_init, k, oc[keep], op[keep], ouv[keep]),
                dict(fixed_poses=fixed))
    # the SLAM loop's buckets: a dummy fixed point takes the zero-weight
    # padding observations
    n_b = n + 1 + (-(n + 1) % 64)
    m_b = m + (-m % 256)
    pts = np.concatenate([pts_init, np.ones((n_b - n, 3), np.float32)])
    pad = m_b - m
    fixed_pts = np.arange(n_b) >= n
    counts = np.bincount(op, minlength=n_b)
    k_b = int(counts.max()) + (-int(counts.max()) % 4)
    return ((poses_init, pts, k, np.concatenate([oc, np.zeros(pad, np.int32)]),
             np.concatenate([op, np.full(pad, n, np.int32)]),
             np.concatenate([ouv, np.zeros((pad, 2), np.float32)])),
            dict(obs_w=(np.arange(m_b) < m).astype(np.float32),
                 fixed_poses=fixed, fixed_points=fixed_pts,
                 max_obs_per_point=k_b))


@pytest.mark.parametrize("case", ["plain", "priors_rgbd", "max_obs_per_point",
                                  "exact_1024", "slam_buckets"])
def test_build_problem_arrays_equal(case, scene):
    """Every array equal to the reference's, value and dtype: the sort,
    the padding to 1024 on the last point, obs_by_point and its mask
    (vectorised here, a Python loop there), priors and RGB-D rows."""
    args, kwargs = _build_case(case, scene)
    ref, got = _both(*args, **kwargs)
    assert ref.seg_oh is None and ref.cam_oh is None
    for name in tba.BAProblem._fields:
        r, g = getattr(ref, name), getattr(got, name)
        assert (r is None) == (g is None), name
        if r is None:
            continue
        r = np.asarray(r)
        assert str(g.dtype) == f"torch.{r.dtype}", name
        np.testing.assert_array_equal(_np(g), r, err_msg=name)
    assert got.obs_cam.shape[0] % 1024 == 0


def test_convert_ba_problem_and_params(problems):
    """convert.ba_problem carries the reference's arrays across (engine
    fields dropped), convert.ba_params / pgo_params the settings."""
    ref, got = problems
    fields = {k: None if v is None else np.asarray(v)
              for k, v in ref._asdict().items()}
    moved = convert.ba_problem(fields, device="cpu")
    for name in tba.BAProblem._fields:
        a, b = getattr(moved, name), getattr(got, name)
        assert (a is None) == (b is None)
        if a is not None:
            assert torch.equal(a, b), name
    p = convert.ba_params(dataclasses.asdict(jba.BAParams(solver="pcg")))
    assert p == tba.BAParams(solver="pcg")
    q = convert.pgo_params(dataclasses.asdict(jpgo.PGOParams(loss="huber")))
    assert q == tpgo.PGOParams(loss="huber")
    with pytest.raises(ValueError):
        convert.ba_problem({**fields, "extra": None}, device="cpu")


# ---------------------------------------------------------------------------
# the Schur step's parts
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("depth", [False, True])
def test_project_with_jacobians(depth, scene):
    """r, J_pose and J_pt per observation within 2e-5 relative (each
    is a handful of float32 ops; XLA and ATen round the quaternion
    rotation's multiply-adds apart)."""
    _, poses_init, _, pts_init, k, oc, op, ouv, _ = scene
    rng = np.random.default_rng(2)
    extra = ((rng.uniform(5, 12, len(oc)).astype(np.float32),
              rng.uniform(0, 3, len(oc)).astype(np.float32))
             if depth else ())
    ref = jba._project_with_jacobians(
        *(jnp.asarray(a) for a in (poses_init, pts_init, k, oc, op, ouv)
          + extra))
    got = tba._project_with_jacobians(
        *(T(a) for a in (poses_init, pts_init, k, oc, op, ouv) + extra))
    assert got[0].shape == (len(oc), 3 if depth else 2)
    for g, r in zip(got, ref):
        assert _rel(g, r) <= 2e-5


@pytest.fixture(scope="module")
def normal_eqs(problems):
    ref, got = problems
    params = jba.BAParams(**PARAMS)
    r = jba.schur_normal_equations(ref, ref.poses, ref.points, params)
    g = tba.schur_normal_equations(got, got.poses, got.points,
                                   tba.BAParams(**PARAMS))
    return r, g


def test_schur_normal_equations(normal_eqs):
    """U, g_p, V, g_x, B within 1e-5 relative: segmented sums of up to
    ~100 float32 terms in another order."""
    ref, got = normal_eqs
    for name, g, r in zip(("U", "g_p", "V", "g_x", "B"), got, ref):
        assert g.shape == tuple(r.shape), name
        assert _rel(g, r) <= 1e-5, (name, _rel(g, r))


def test_reduce_camera_system_and_back_substitute(problems, normal_eqs):
    """S, rhs and the points' back-substitution within 1e-4 relative:
    S sums ~120 point products of V⁻¹-scaled blocks (one matmul here,
    XLA's dot there), and its diagonal is a difference of such sums."""
    ref_p, got_p = problems
    ref, got = normal_eqs
    lam = 1e-3
    s_r, rhs_r, vinv_r, y_r = jba.reduce_camera_system(ref_p, *ref, lam)
    s_g, rhs_g, vinv_g, y_g = tba.reduce_camera_system(
        got_p, *got, torch.tensor(lam))
    assert s_g.shape == tuple(s_r.shape)
    for name, g, r in (("S", s_g, s_r), ("rhs", rhs_g, rhs_r),
                       ("V_inv", vinv_g, vinv_r), ("Y", y_g, y_r)):
        assert _rel(g, r) <= 1e-4, (name, _rel(g, r))
    dp = np.random.default_rng(3).normal(0, 0.01, (len(s_r) // 6, 6))
    dx_r = jba.back_substitute_points(ref_p, vinv_r, ref[4], ref[3],
                                      jnp.asarray(dp, jnp.float32))
    dx_g = tba.back_substitute_points(got_p, vinv_g, got[4], got[3],
                                      T(dp.astype(np.float32)))
    assert _rel(dx_g, dx_r) <= 1e-4


def test_pcg_reduced_solve(problems, normal_eqs):
    """The PCG pose step within 1e-3 relative of the reference's and of
    the dense solve's (CG over 6P = 36 unknowns; each step's rounding
    feeds the next), V⁻¹ within 1e-5."""
    ref_p, got_p = problems
    ref, got = normal_eqs
    x_r, vinv_r = jba._pcg_reduced_solve(ref_p, *ref, 1e-3, 40)
    x_g, vinv_g = tba._pcg_reduced_solve(got_p, *got, torch.tensor(1e-3), 40)
    assert _rel(x_g, x_r) <= 1e-3
    assert _rel(vinv_g, vinv_r) <= 1e-5
    s, rhs, _, _ = tba.reduce_camera_system(got_p, *got, torch.tensor(1e-3))
    dense = torch.linalg.solve(s.double(), rhs.double()).reshape(-1, 6)
    assert _rel(x_g, dense) <= 1e-3


def test_prior_terms_and_cost(scene):
    """prior_terms (dU, dg, cost) within 1e-5 relative and ba_cost with
    priors, RGB-D and Huber within 1e-5 relative (sums of ~700 float32
    terms in another order)."""
    args, kwargs = _build_case("priors_rgbd", scene)
    ref, got = _both(*args, **kwargs)
    r = jba.prior_terms(ref.poses, ref.prior_center, ref.prior_invs,
                        ref.fixed_poses, "huber", 0.5)
    g = tba.prior_terms(got.poses, got.prior_center, got.prior_invs,
                        got.fixed_poses, "huber", 0.5)
    for a, b in zip(g, r):
        assert _rel(a, b) <= 1e-5
    c_r = jba.ba_cost(ref, params=jba.BAParams(**PARAMS))
    c_g = tba.ba_cost(got, params=tba.BAParams(**PARAMS))
    assert float(c_g) == pytest.approx(float(c_r), rel=1e-5)


# ---------------------------------------------------------------------------
# the LM loop
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ref_lm_step():
    """One reference LM iteration (_schur_step, ba_cost, the accept rule),
    jitted once per (params) and iterated by the test."""
    cache = {}

    def get(params):
        if params not in cache:
            def step(problem, poses, points, lam, cost):
                new_poses, new_points = jba._schur_step(
                    problem, poses, points, lam, params)
                new_cost = jba.ba_cost(problem, new_poses, new_points, params)
                accept = new_cost < cost
                return (jnp.where(accept, new_poses, poses),
                        jnp.where(accept, new_points, points),
                        jnp.clip(jnp.where(accept, lam / params.lambda_factor,
                                           lam * params.lambda_factor),
                                 1e-10, 1e8),
                        jnp.where(accept, new_cost, cost))
            cache[params] = jax.jit(step)
        return cache[params]
    return get


def _costs_per_iteration(ref_p, got_p, params, step, n_iter):
    r_state = (ref_p.poses, ref_p.points, jnp.float32(params.lambda_init),
               jba.ba_cost(ref_p, params=params))
    tparams = convert.ba_params(dataclasses.asdict(params))
    g_state = (got_p.poses, got_p.points, torch.tensor(params.lambda_init),
               tba.ba_cost(got_p, params=tparams))
    costs = [(float(r_state[3]), float(g_state[3]))]
    for _ in range(n_iter):
        r_state = step(ref_p, *r_state)
        poses, points, lam, cost = g_state
        new_poses, new_points = tba._schur_step(got_p, poses, points, lam,
                                                tparams)
        new_cost = tba.ba_cost(got_p, new_poses, new_points, tparams)
        accept = new_cost < cost
        g_state = (torch.where(accept, new_poses, poses),
                   torch.where(accept, new_points, points),
                   torch.clamp(torch.where(accept, lam / params.lambda_factor,
                                           lam * params.lambda_factor),
                               1e-10, 1e8),
                   torch.where(accept, new_cost, cost))
        costs.append((float(r_state[3]), float(g_state[3])))
    return np.asarray(costs), r_state, g_state


@pytest.mark.parametrize("solver", ["dense", "pcg"])
def test_cost_after_each_lm_iteration(solver, problems, ref_lm_step):
    """The cost after each of 10 LM iterations within 1e-4 relative of
    the reference's, the same accept/reject at every step, and poses
    within 1e-4 after 10 (the reference's own bound for two summation
    orders: 1e-4 initial, 0.05 final, 1e-3 poses)."""
    ref_p, got_p = problems
    params = jba.BAParams(max_iterations=10, solver=solver, cg_iters=40,
                          **PARAMS)
    costs, r_state, g_state = _costs_per_iteration(
        ref_p, got_p, params, ref_lm_step(params), 10)
    np.testing.assert_allclose(costs[:, 1], costs[:, 0], rtol=1e-4)
    assert costs[-1, 0] < 0.1 * costs[0, 0]
    np.testing.assert_allclose(_np(g_state[0]), np.asarray(r_state[0]),
                               atol=1e-4)
    # bundle_adjust_schur runs exactly these iterations
    res = tba.bundle_adjust_schur(got_p, convert.ba_params(
        dataclasses.asdict(params)))
    assert float(res.final_cost) == costs[-1, 1]
    assert torch.equal(res.poses, g_state[0])


@pytest.mark.parametrize("case", ["dense", "pcg", "fixed_points",
                                  "slam_buckets"])
def test_bundle_adjust_schur_matches_reference(case, scene):
    """Whole solves: initial cost within 1e-5, final cost within 1e-3
    relative, poses within 1e-4 and points within 1e-3 (12 iterations of
    float32 rounding on both sides, inside the reference's summation-
    order bound of 0.05 / 1e-3). Every pose within 0.5° of the truth.
    Poses 0 and 1 are fixed at the truth, as the SLAM loop fixes its
    first two keyframes: with one pose fixed the scale is free, and once
    λ is small each package's rounding moves it its own way along that
    null direction (3e-3 apart after 12 iterations)."""
    poses_gt = scene[0]
    args, kwargs = _build_case(
        "slam_buckets" if case == "slam_buckets" else "plain", scene)
    args = (np.concatenate([poses_gt[:2], args[0][2:]]),) + args[1:]
    kwargs["fixed_poses"] = np.arange(len(poses_gt)) < 2
    if case == "fixed_points":
        kwargs["fixed_points"] = np.arange(len(args[1])) % 5 == 0
    ref_p, got_p = _both(*args, **kwargs)
    solver = "pcg" if case == "pcg" else "dense"
    params = jba.BAParams(max_iterations=12, solver=solver, cg_iters=40,
                          **PARAMS)
    ref = jax.jit(lambda p: jba.bundle_adjust_schur(p, params))(ref_p)
    got = tba.bundle_adjust_schur(got_p, convert.ba_params(
        dataclasses.asdict(params)))
    assert float(got.initial_cost) == pytest.approx(float(ref.initial_cost),
                                                    rel=1e-5)
    assert float(got.final_cost) == pytest.approx(float(ref.final_cost),
                                                  rel=1e-3)
    assert float(got.final_cost) < 0.1 * float(got.initial_cost)
    np.testing.assert_allclose(_np(got.poses), np.asarray(ref.poses),
                               atol=1e-4)
    np.testing.assert_allclose(_np(got.points), np.asarray(ref.points),
                               atol=1e-3)
    fixed_pts = _np(got_p.fixed_points)
    assert torch.equal(got.points[fixed_pts], got_p.points[fixed_pts])
    for c in range(len(poses_gt)):
        dot = abs(np.dot(_np(got.poses[c, :4]), poses_gt[c, :4]))
        assert 2 * np.degrees(np.arccos(min(dot, 1.0))) < 0.5


def test_pcg_scene_matches_dense():
    """The PCG scene at 24 poses: auto picks dense (P ≤ 400); the PCG
    solve reaches < 0.1× the initial cost and within 1.2× of the dense
    solve's final cost (the reference test's bound), and each solver's
    final cost within 1e-3 relative of the reference's."""
    poses, pts, k, oc, op, ouv, fixed = make_pcg_scene()
    ref_p, got_p = _both(poses, pts, k, oc, op, ouv, fixed_poses=fixed)
    out = {}
    for solver in ("pcg", "dense"):
        params = jba.BAParams(max_iterations=8, solver=solver, cg_iters=80)
        ref = jax.jit(lambda p: jba.bundle_adjust_schur(p, params))(ref_p)
        got = tba.bundle_adjust_schur(got_p, convert.ba_params(
            dataclasses.asdict(params)))
        assert float(got.final_cost) == pytest.approx(float(ref.final_cost),
                                                      rel=1e-3)
        out[solver] = got
    c0 = float(out["pcg"].initial_cost)
    assert float(out["pcg"].final_cost) < 0.1 * c0
    assert float(out["pcg"].final_cost) <= 1.2 * float(
        out["dense"].final_cost)
    assert not tba._uses_pcg(tba.BAParams(), 400)
    assert tba._uses_pcg(tba.BAParams(), 401)


def test_cholesky_failure_rejects_the_step(problems):
    """A system that is not positive definite (λ = −10 makes the damped
    diagonal negative) gives NaN, as jnp.linalg.cholesky does, and the
    cost test then keeps the old poses: no exception, no wait."""
    _, got_p = problems
    params = tba.BAParams(max_iterations=1, solver="dense", lambda_init=-10.0,
                          **PARAMS)
    new_poses, _ = tba._schur_step(got_p, got_p.poses, got_p.points,
                                   torch.tensor(-10.0), params)
    assert torch.isnan(new_poses).any()
    res = tba.bundle_adjust_schur(got_p, params)
    assert torch.equal(res.poses, got_p.poses)
    assert float(res.final_cost) == float(res.initial_cost)


# ---------------------------------------------------------------------------
# PGO
# ---------------------------------------------------------------------------


def _padded_ring(p_b=16, e_b=32):
    """The 12-pose ring bucketed as the SLAM loop buckets it: identity
    poses (fixed) beyond the ring, identity-measurement weight-0 edges
    (0 → 0) beyond its edges."""
    poses_gt, init, ei, ej, meas = make_loop()
    n, e = len(init), len(ei)
    poses = np.tile(np.array([1.0, 0, 0, 0, 0, 0, 0], np.float32), (p_b, 1))
    poses[:n] = init
    fixed = np.ones(p_b, bool)
    fixed[1:n] = False
    pad_e = e_b - e
    w = np.zeros(e_b, np.float32)
    w[:e] = 1.0
    w[e - 1] = 100.0                                # the exact loop edge
    meas_b = np.tile(np.array([1.0, 0, 0, 0, 0, 0, 0], np.float32), (e_b, 1))
    meas_b[:e] = meas
    return (poses_gt, poses, np.concatenate([ei, np.zeros(pad_e, np.int32)]),
            np.concatenate([ej, np.zeros(pad_e, np.int32)]), meas_b, w,
            fixed)


def test_edge_residual_and_jacobians():
    """Residuals within 2e-6 and Jacobians within 1e-4 relative of
    jax.jacfwd's; at identity (the padding's 0 → 0 edge with an identity
    measurement, θ = 0 in se3_log) the Jacobian is finite, as the
    reference's, and float32."""
    _, poses, ei, ej, meas, _, _ = _padded_ring()
    ta, tb, tm = poses[ei], poses[ej], meas
    r_ref = np.asarray(jax.jit(jax.vmap(jpgo.edge_residual))(
        jnp.asarray(ta), jnp.asarray(tb), jnp.asarray(tm)))
    r_got = tpgo.edge_residual(T(ta), T(tb), T(tm))
    np.testing.assert_allclose(_np(r_got), r_ref, atol=2e-6)
    ref = jax.jit(jax.vmap(jpgo._edge_res_and_jac))(
        jnp.asarray(ta), jnp.asarray(tb), jnp.asarray(tm))
    got = torch.func.vmap(tpgo._edge_res_and_jac)(T(ta), T(tb), T(tm))
    for g, r in zip(got, ref):
        assert g.dtype == torch.float32
        assert torch.isfinite(g).all()
        assert _rel(g, r) <= 1e-4
    assert np.isfinite(np.asarray(ref[1][-1])).all()


def test_pgo_normal_equations():
    """H, g and the cost within 1e-5 relative (sums of ≤ 3 edge blocks
    per pose pair)."""
    _, poses, ei, ej, meas, w, _ = _padded_ring()
    params = jpgo.PGOParams()
    ref = jax.jit(jpgo.pgo_normal_equations, static_argnums=5)(
        jnp.asarray(poses), jnp.asarray(ei), jnp.asarray(ej),
        jnp.asarray(meas), jnp.asarray(w), params)
    got = tpgo.pgo_normal_equations(T(poses), T(ei).long(), T(ej).long(),
                                    T(meas), T(w), tpgo.PGOParams())
    for g, r in zip(got, ref):
        assert torch.isfinite(g).all()
        assert _rel(g, r) <= 1e-5


@pytest.mark.parametrize("padded", [False, True])
def test_pose_graph_optimize_matches_reference(padded):
    """The ring with and without the SLAM loop's identity padding (15
    iterations, PGOParams(max_iterations=15) as the loop runs it):
    initial cost within 1e-5 relative, final cost within 1e-3 relative
    or 1e-7 absolute (the solve drives it to ~1e-4), poses within 1e-4;
    the padding stays identity; cost < 0.5× and translation ATE < 0.75×
    the initial (the reference test's bounds)."""
    poses_gt, poses, ei, ej, meas, w, fixed = _padded_ring()
    n = len(poses_gt)
    if not padded:
        e = int((w > 0).sum())
        poses, ei, ej, meas, w, fixed = (poses[:n], ei[:e], ej[:e], meas[:e],
                                         w[:e], None)
    params = jpgo.PGOParams(max_iterations=15)
    ref = jax.jit(lambda p: jpgo.pose_graph_optimize(
        p, ei, ej, jnp.asarray(meas), jnp.asarray(w),
        fixed=None if fixed is None else jnp.asarray(fixed),
        params=params))(jnp.asarray(poses))
    got = tpgo.pose_graph_optimize(
        T(poses), ei, ej, meas, w, fixed=None if fixed is None else T(fixed),
        params=convert.pgo_params(dataclasses.asdict(params)))
    assert float(got.initial_cost) == pytest.approx(float(ref.initial_cost),
                                                    rel=1e-5)
    assert float(got.final_cost) == pytest.approx(float(ref.final_cost),
                                                  rel=1e-3, abs=1e-7)
    np.testing.assert_allclose(_np(got.poses), np.asarray(ref.poses),
                               atol=1e-4)
    assert float(got.final_cost) < 0.5 * float(got.initial_cost)

    def ate(ps):
        return np.sqrt(np.mean(np.sum((_np(ps)[:n, 4:] - poses_gt[:, 4:])
                                      ** 2, axis=1)))

    assert ate(got.poses) < 0.75 * ate(poses[:n])
    if padded:
        assert torch.equal(got.poses[n:], T(poses[n:]))
