"""The port's geometry examples (``two_view``, ``pnp_demo``,
``icp_registration`` of kornia_tpu_torch/examples/) on the CPU, against
the JAX package, as tests/test_torch_examples.py holds the others: each
``main(argv + ["--cpu"])`` in-process with tests/test_examples.py's
printed assertions, then its main figure against the reference library's
same computation on the same inputs, fed the reference's RANSAC draws
through the port's seams (``samples=``, ``sample_idx=``) where the
reference draws from a ``jax.random`` key."""

import functools
import os
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from kornia_tpu import io as jio
from kornia_tpu.geometry import camera as jcamera
from kornia_tpu.geometry import icp as jicp
from kornia_tpu.geometry import liegroup as jlg
from kornia_tpu.geometry import pnp as jpnp
from kornia_tpu.geometry import ransac as jransac
from kornia_tpu.geometry import twoview as jtwoview
from kornia_tpu.optim import pgo as jpgo

import chip_smoke
from kornia_tpu_torch import convert
from kornia_tpu_torch.examples import icp_registration, pnp_demo, two_view

from test_torch_examples import CPU, _ref_match, _ref_orb, run

# One intra-op thread: these tests run many small ops, and torch's pool
# of a thread per core spins against the other test processes.
torch.set_num_threads(1)

tensor = functools.partial(convert.tensor, device="cpu")


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """The two-view pair's top-left 240×376 (chip_smoke.render_scene; K_EUROC
    holds for a crop at the origin) as gray PNGs."""
    d = tmp_path_factory.mktemp("two_view")
    img1, img2, _, _ = chip_smoke.render_scene()
    paths = {"a": str(d / "a.png"), "b": str(d / "b.png")}
    jio.write_image_png(paths["a"], img1[:240, :376, None])
    jio.write_image_png(paths["b"], img2[:240, :376, None])
    return paths


# ---------------------------------------------------------------------------
# two_view
# ---------------------------------------------------------------------------


def _ref_samples(key, mask, n_hyp):
    """The reference's draws inside estimate_relative_pose (8-point)."""
    kf, kh = jax.random.split(key)
    m = jnp.asarray(mask)
    idx_f = jransac.sample_minimal_sets(jax.random.split(kf)[0], len(mask),
                                        m, n_hyp, 8)
    idx_h = jransac.sample_minimal_sets(jax.random.split(kh)[0], len(mask),
                                        m, n_hyp, 4)
    return tensor(np.asarray(idx_f)), tensor(np.asarray(idx_h))


def _chord(r_a, r_b):
    d = np.linalg.norm(np.asarray(r_a, np.float64) - np.asarray(r_b,
                                                                  np.float64))
    return float(2 * np.arcsin(min(d / (2 * np.sqrt(2)), 1.0)))


@pytest.fixture(scope="module")
def ref_two_view(pair):
    """The reference example's computation (8-point, PRNGKey(0)) on the
    pair: ORB, match, estimate_relative_pose, jitted."""
    g1 = jio.read_image_any_gray8(pair["a"])[:, :, 0]
    g2 = jio.read_image_any_gray8(pair["b"])[:, :, 0]
    ref = _ref_orb(800, 4)
    f1, f2 = ref(jnp.asarray(g1)), ref(jnp.asarray(g2))
    m = _ref_match(f1.descriptors, f2.descriptors, f1.mask, f2.mask)
    k = jnp.asarray(two_view.K_EUROC)
    x2 = f2.xy[jnp.maximum(m.idx, 0)]
    res = jax.jit(lambda key, a, b, mask: jtwoview.estimate_relative_pose(
        key, a, b, k, k, mask=mask))(jax.random.PRNGKey(0), f1.xy, x2,
                                     m.mask)
    return f1, f2, m, res


def test_two_view_pose_matches_reference(pair, ref_two_view):
    """``inliers: n,`` printed with n > 60 (tests/test_examples.py's
    gate). The example's pose stage fed the reference's matched points
    and draws: the same model, R within 1e-4 rad and t within 1e-3 of the
    reference's, n_inliers within ±2 (tests/test_torch_slice.py's two-view tolerance); end to
    end, the port's own matches and draw give inliers within 5% of the
    reference's and the same model."""
    out, res = run(two_view, "--frame-a", pair["a"], "--frame-b",
                   pair["b"])
    n_inl = int(out.split("inliers:")[1].split(",")[0])
    assert n_inl > 60 and n_inl == res["inliers"]
    f1, f2, m, ref = ref_two_view
    feats = [types.SimpleNamespace(xy=tensor(np.asarray(f.xy)))
             for f in (f1, f2)]
    tm = types.SimpleNamespace(idx=tensor(np.asarray(m.idx)),
                               mask=tensor(np.asarray(m.mask)))
    params = jtwoview.TwoViewParams()
    got = two_view.pose(feats[0], feats[1], tm, two_view.twoview.
                        TwoViewParams(), CPU, samples=_ref_samples(
                            jax.random.PRNGKey(0), np.asarray(m.mask),
                            params.n_hypotheses))
    assert bool(got.use_homography) == bool(ref.use_homography)
    assert _chord(got.rotation.numpy(), np.asarray(ref.rotation)) < 1e-4
    np.testing.assert_allclose(got.translation.numpy(),
                               np.asarray(ref.translation), atol=1e-3)
    assert abs(int(got.n_inliers) - int(ref.n_inliers)) <= 2
    assert res["homography"] == bool(ref.use_homography)
    assert abs(res["inliers"] - int(ref.n_inliers)) <= \
        0.05 * int(ref.n_inliers)


# ---------------------------------------------------------------------------
# pnp_demo, icp_registration
# ---------------------------------------------------------------------------


def test_pnp_demo_matches_reference():
    """``rotation error:`` printed under 1°. The example's scene equals
    the reference example's (pixels within 1e-3 px: float32 pose and
    distortion ops of two libraries); on the reference's undistorted
    pixels and draw the example's solve gives R within 1e-4 rad and t
    within 1e-3 of the reference's, n_inliers within ±2 (tests/test_torch_pnp_ransac.py's
    tolerance)."""
    out, res = run(pnp_demo)
    assert float(out.split("rotation error:")[1].split("°")[0]) < 1.0
    world, px, t_true, n_out = pnp_demo.scene(0.5, 0.2)
    rng = np.random.default_rng(0)
    xi = np.array([0.1, -0.05, 2.0, 0.1, -0.2, 0.05], np.float32)
    ref_t = np.asarray(jlg.se3_exp(jnp.asarray(xi)))
    cam = np.asarray(jlg.se3_apply(jnp.asarray(ref_t)[None],
                                   jnp.asarray(world)))
    xy_d = np.asarray(jcamera.distort_points_polynomial(
        jnp.asarray(cam[:, :2] / cam[:, 2:]), jnp.asarray(pnp_demo.DIST)))
    k = pnp_demo.K
    ref_px = xy_d * [k[0, 0], k[1, 1]] + [k[0, 2], k[1, 2]]
    ref_px += rng.normal(0, 0.5, ref_px.shape)
    out_idx = rng.choice(len(ref_px), n_out, replace=False)
    ref_px[out_idx] = rng.uniform([0, 0], [1280, 720], (n_out, 2))
    np.testing.assert_allclose(t_true, ref_t, atol=1e-6)
    np.testing.assert_allclose(px, ref_px, atol=1e-3)
    px_u = jcamera.undistort_points(jnp.asarray(ref_px, jnp.float32),
                                    jnp.asarray(k),
                                    jnp.asarray(pnp_demo.DIST))
    key = jax.random.PRNGKey(0)
    pose, _, n_inl = jax.jit(lambda w, p: jpnp.solve_pnp_ransac(
        key, w, p, jnp.asarray(k), threshold_px=3.0))(jnp.asarray(world),
                                                      px_u)
    draw = jransac.sample_minimal_sets(jax.random.split(key)[0], len(world),
                                       jnp.ones(len(world), bool), 256, 6)
    got, _, got_n = pnp_demo.solve(world, ref_px, CPU,
                                   sample_idx=tensor(np.asarray(draw)))
    assert _chord(got.rotation.numpy(), np.asarray(pose.rotation)) < 1e-4
    np.testing.assert_allclose(got.translation.numpy(),
                               np.asarray(pose.translation), atol=1e-3)
    assert abs(int(got_n) - int(n_inl)) <= 2
    assert abs(res["inliers"] - int(n_inl)) <= 2


def test_icp_registration_matches_reference():
    """``PGO: cost`` printed; the scans equal the reference example's to
    1e-6 (float32 pose ops of two libraries); the reference's icp_vanilla
    on the port's scans gives each pair's relative pose within 1e-5 (PR
    11's ICP tolerance) and the reference's PGO (jitted) on its chain the
    same poses within 1e-5."""
    out, res = run(icp_registration, "--n-scans", "3")
    assert "PGO: cost" in out
    base, clouds = icp_registration.synthetic_scans(
        3, np.random.default_rng(0))
    rng = np.random.default_rng(0)
    ref_base = rng.uniform(-1, 1, (1500, 3)).astype(np.float32)
    ref_base[:, 2] = 0.2 * np.sin(3 * ref_base[:, 0]) \
        + 0.1 * ref_base[:, 1] ** 2
    np.testing.assert_array_equal(base, ref_base)
    poses = [np.array([1, 0, 0, 0, 0, 0, 0], np.float32)]
    icp_run = jax.jit(lambda a, b: jicp.icp_vanilla(
        a, b, jicp.ICPParams(max_iterations=30)))
    for i in range(3):
        xi = np.array([0, 0, 0.06 * i, 0.08 * i, 0.02 * i, 0], np.float32)
        moved = np.asarray(jlg.se3_apply(jlg.se3_exp(jnp.asarray(xi))[None],
                                         jnp.asarray(ref_base)))
        want = (moved + rng.normal(0, 0.003, moved.shape)).astype(np.float32)
        np.testing.assert_allclose(clouds[i], want, atol=1e-6)
    for i in range(2):
        r = icp_run(jnp.asarray(clouds[i + 1]), jnp.asarray(clouds[i]))
        q = np.asarray(jlg.matrix_to_quat(r.rotation))
        rel = np.concatenate([q, np.asarray(r.translation)])
        np.testing.assert_allclose(res["relative"][i], rel, atol=1e-5)
        poses.append(np.asarray(jlg.se3_compose(jnp.asarray(rel),
                                                jnp.asarray(poses[-1]))))
    ei, ej = np.arange(2, dtype=np.int32), np.arange(1, 3, dtype=np.int32)
    ref = jax.jit(lambda p, m: jpgo.pose_graph_optimize(
        p, ei, ej, m, params=jpgo.PGOParams(max_iterations=10)))(
        jnp.asarray(np.stack(poses)), jnp.asarray(res["relative"]))
    np.testing.assert_allclose(res["poses"], np.asarray(ref.poses),
                               atol=1e-5)
    assert res["final_cost"] <= res["initial_cost"] + 1e-9
