"""The port's SLAM loop (kornia_tpu_torch/slam/: the map, evaluation,
checkpoints and ``MonocularSlam``) against the JAX package's
kornia_tpu/slam/ on the CPU.

The reference's whole loop runs once here (a module fixture, on
``TestMonocularVO.test_arc_trajectory``'s scenario, ~30 s on one CPU
core: its BA and tracking programs compile per shape bucket); the loop
closure's methods are held one by one on a seeded drifted map, and the
image front end on a short rendered sequence. RANSAC draws: the port is
handed the reference's own through ``draws=`` (:class:`RefDraws` takes one
``jax.random`` key where the reference's ``_next_key`` does and builds
the draw that the reference's RANSAC makes from it). The differences the
tolerances bound are recorded as junit properties (``record_property``),
so ``--junitxml`` reports what each run measured."""

import copy
import dataclasses
import functools
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from kornia_tpu import slam as jslam
from kornia_tpu.bow import Vocabulary as JVocabulary
from kornia_tpu.features import orb as jorb
from kornia_tpu.geometry import liegroup as jlg
from kornia_tpu.geometry import ransac as jransac
from kornia_tpu.slam import system as jsys

# the reference's own scenarios (the modules, so that none of their tests
# is collected here)
import test_slam as ts
import test_torch_track as ttrack

from kornia_tpu_torch import convert
from kornia_tpu_torch import slam as tslam
from kornia_tpu_torch.bow import Vocabulary
from kornia_tpu_torch.parallel.mesh import make_mesh
from kornia_tpu_torch.slam import system as tsys

# One intra-op thread: these tests run many small ops, and torch's pool
# of a thread per core spins against the other test processes.
torch.set_num_threads(1)

T = functools.partial(convert.tensor, device="cpu")
K = ts.K
ARC_CFG = dict(min_init_matches=30, keyframe_min_tracked_ratio=0.95,
               keyframe_min_interval=1, ba_window=4)
LOOP_CFG = dict(ARC_CFG, loop_min_kf_gap=8, loop_min_score=0.10,
                loop_min_matches=15)
# the reference's _next_key call sites, by the port's draw kinds
SITES = {"_initialize": "twoview", "_track": "track",
         "_try_loop_closure": "loop_pnp"}


class RefDraws:
    """``draws=`` for the port: the reference's key sequence
    (``PRNGKey(seed)``, one ``split`` per draw) and, from each key, the
    index sets the reference's RANSAC draws: two-view splits it into
    (kf, kh) (twoview.py:76) and each RANSAC samples from ``split(k)[0]``
    (ransac.py:87); PnP samples from ``split(key)[0]``."""

    def __init__(self, seed: int = 0):
        self.key = jax.random.PRNGKey(seed)
        self.kinds = []

    def __call__(self, kind, mask, sizes):
        self.key, sub = jax.random.split(self.key)
        self.kinds.append(kind)
        m = jnp.asarray(mask.cpu().numpy())
        n = m.shape[0]

        def draw(key, batch, size):
            return T(np.asarray(jransac.sample_minimal_sets(
                jax.random.split(key)[0], n, m, batch, size)))

        if kind == "twoview":
            kf, kh = jax.random.split(sub)
            (bf, sf), (bh, sh) = sizes
            return draw(kf, bf, sf), draw(kh, bh, sh)
        return draw(sub, *sizes)


def _record_sites(ref):
    """Wrap the reference system's ``_next_key``: the kinds of its draws,
    by the method that took the key."""
    kinds = []
    take = ref._next_key

    def next_key():
        kinds.append(SITES[sys._getframe(1).f_code.co_name])
        return take()

    ref._next_key = next_key
    return kinds


def _chord(q_a, q_b) -> float:
    """Rotation angle between two unit quaternions (sign-free)."""
    d = abs(float(np.dot(q_a / np.linalg.norm(q_a), q_b / np.linalg.norm(
        q_b))))
    return float(2 * np.arccos(min(d, 1.0)))


def _kf_ate(system, gt):
    """Keyframe camera centres against ``gt`` (sim3-aligned), by the
    port's own evaluation."""
    frames = [kf.frame_idx for kf in system.map.keyframes]
    est = tslam.poses7_to_t44(system.trajectory(), invert=True,
                              device="cpu")[:, :3, 3]
    ref = tslam.poses7_to_t44(gt[frames], invert=True, device="cpu")[:, :3, 3]
    return tslam.absolute_trajectory_error(est, ref).rmse


def _assert_maps_equal(a, b):
    """Two SlamMaps (either package) hold the same arrays and lists."""
    assert len(a.keyframes) == len(b.keyframes)
    for ka, kb in zip(a.keyframes, b.keyframes):
        assert (ka.kf_id, ka.frame_idx) == (kb.kf_id, kb.frame_idx)
        for name in ("pose", "xy", "descriptors", "point_ids"):
            x, y = getattr(ka, name), getattr(kb, name)
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)
    for name in ("point_xyz", "point_desc", "point_valid"):
        assert getattr(a, name).dtype == getattr(b, name).dtype
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name))
    assert a.point_obs == b.point_obs
    assert len(a.edges) == len(b.edges)
    for ea, eb in zip(a.edges, b.edges):
        assert ea[:2] == eb[:2] and ea[3] == eb[3]
        np.testing.assert_array_equal(ea[2], eb[2])


@pytest.fixture(scope="module", autouse=True)
def jitted_reference():
    """The reference's device stages called under jax.jit, one program
    each, as the package means them to run: ORB, estimate_relative_pose,
    solve_pnp_ransac (its ``_track_step_jit`` jits it too),
    bundle_adjust_schur and pose_graph_optimize. Eager on the CPU they
    compile op by op, which makes this file much slower."""
    with pytest.MonkeyPatch.context() as mp:
        for mod, name, static in (
                (jorb, "orb_detect_and_describe", dict(static_argnums=1)),
                (jsys.tv, "estimate_relative_pose",
                 dict(static_argnames=("params",))),
                (jsys.pnp_mod, "solve_pnp_ransac", dict(static_argnames=(
                    "threshold_px", "n_hypotheses", "sample_size",
                    "lo_iters", "method", "scoring", "refine_iters"))),
                (jsys.ba_mod, "bundle_adjust_schur",
                 dict(static_argnames=("params",))),
                (jsys.pgo_mod, "pose_graph_optimize",
                 dict(static_argnames=("params",)))):
            mp.setattr(mod, name, jax.jit(getattr(mod, name), **static))
        yield


# --------------------------------------------------------------------------
# the whole loop: TestMonocularVO.test_arc_trajectory's scenario
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def arc(tmp_path_factory):
    """The reference's loop over the arc (25 frames of observations, a
    60° arc), its draw sites recorded and its map saved; then the port's
    loop on the same observations with the reference's draws."""
    rng = np.random.default_rng(11)
    pts, desc = ts._make_scene(rng)
    gt = ts._camera_poses_circle(25, full=60.0 / 360.0)
    obs = [ts._observe(pts, desc, pose, K, 0.3, rng)[:2] for pose in gt]
    ref = jslam.MonocularSlam(K, jslam.SlamConfig(**ARC_CFG))
    ref_sites = _record_sites(ref)
    for xy, d in obs:
        ref.process_observations(xy, d)
    path = str(tmp_path_factory.mktemp("arc") / "reference_map.npz")
    jslam.save_map(path, ref.map)
    draws = RefDraws(0)
    port = tslam.MonocularSlam(K, tslam.SlamConfig(**ARC_CFG), device="cpu",
                               draws=draws)
    for xy, d in obs:
        port.process_observations(xy, d)
    return dict(ref=ref, port=port, gt=gt, pts=pts, desc=desc, path=path,
                ref_sites=ref_sites, port_draws=draws.kinds)


def test_arc_loop_matches_reference(arc, record_property):
    """Frame by frame: state, n_tracked, is_keyframe and the keyframe
    count equal (the port runs on the reference's draws; no keyframe
    decision flips on this scenario, so they are compared at every frame);
    poses within 1e-3 rad and 1e-3 units (float32 rounding of two
    summation orders, compounded over 24 local BAs: measured 2.2e-5 rad
    and 5.1e-4, at the last frames); both ATEs under the reference test's
    0.05 · 3.0 and within 1e-3 of each other (measured 0.00498 and
    0.00533)."""
    ref, port = arc["ref"], arc["port"]
    assert len(ref.results) == len(port.results) == 25
    posed = [(a.pose, b.pose) for a, b in zip(ref.results, port.results)
             if a.pose is not None and b.pose is not None]
    record_property("rot_rad_max", max(_chord(a[:4], b[:4])
                                       for a, b in posed))
    record_property("trans_max", max(float(np.abs(a[4:] - b[4:]).max())
                                     for a, b in posed))
    for a, b in zip(ref.results, port.results):
        assert (a.frame_idx, a.state.value, a.n_tracked, a.is_keyframe,
                a.loop_closed_with) == (b.frame_idx, b.state.value,
                                        b.n_tracked, b.is_keyframe,
                                        b.loop_closed_with), a.frame_idx
        assert (a.pose is None) == (b.pose is None)
        if a.pose is not None:
            assert _chord(a.pose[:4], b.pose[:4]) <= 1e-3, a.frame_idx
            np.testing.assert_allclose(b.pose[4:], a.pose[4:], atol=1e-3)
    assert port.state == tslam.TrackingState.TRACKING
    assert len(port.map.keyframes) == len(ref.map.keyframes)
    assert port.map.n_points == ref.map.n_points
    assert sum(r.pose is not None for r in port.results) >= 20
    ate_p = _kf_ate(port, arc["gt"])
    ate_r = _kf_ate(ref, arc["gt"])
    record_property("ate_port", ate_p)
    record_property("ate_reference", ate_r)
    assert ate_p < 0.05 * 3.0 and ate_r < 0.05 * 3.0
    assert abs(ate_p - ate_r) <= 1e-3


def test_draws_in_reference_key_order(arc):
    """The port calls ``draws`` exactly where the reference takes a key:
    the same kinds in the same order and number (the reference's
    ``_next_key`` wrapped, its calling method named)."""
    assert arc["port_draws"] == arc["ref_sites"]
    assert arc["port_draws"][0] == "twoview"
    assert arc["port_draws"].count("track") == 23    # frames 2-24


def test_arc_map_bookkeeping_equal(arc, record_property):
    """The two loops' maps: the same observation lists, point ids, edges
    and validity; local_point_ids and observations_for_ba (cameras, point
    ids, uv) equal for every window; keyframe poses within 1e-3 and points
    within 1e-2 (a point's depth along its rays is less constrained than
    the poses: measured 4.8e-3 at most, 0.5% of its depth)."""
    ref, port = arc["ref"].map, arc["port"].map
    record_property("points_max", float(np.abs(port.point_xyz
                                               - ref.point_xyz).max()))
    assert port.point_obs == ref.point_obs
    np.testing.assert_array_equal(port.point_valid, ref.point_valid)
    np.testing.assert_array_equal(port.point_desc, ref.point_desc)
    for ka, kb in zip(ref.keyframes, port.keyframes):
        np.testing.assert_array_equal(kb.point_ids, ka.point_ids)
        np.testing.assert_allclose(kb.pose, ka.pose, atol=1e-3)
    np.testing.assert_allclose(port.point_xyz, ref.point_xyz, atol=1e-2)
    assert [e[:2] + (e[3],) for e in port.edges] == [
        e[:2] + (e[3],) for e in ref.edges]
    for n in (1, 4, 30):
        np.testing.assert_array_equal(port.local_point_ids(n),
                                      ref.local_point_ids(n))
    for ids in ([0, 1], list(range(20, 25)), list(range(25))):
        for got, want in zip(port.observations_for_ba(ids),
                             ref.observations_for_ba(ids)):
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)


# --------------------------------------------------------------------------
# checkpoints
# --------------------------------------------------------------------------


def test_checkpoint_loads_across_packages(arc, tmp_path):
    """A map written by the reference loads in the port and one written by
    the port loads in the reference, every array and list equal; the port's
    own round trip is exact too."""
    from_ref = tslam.load_map(arc["path"])
    _assert_maps_equal(from_ref, arc["ref"].map)
    p = str(tmp_path / "port_map.npz")
    tslam.save_map(p, arc["port"].map)
    _assert_maps_equal(jslam.load_map(p), arc["port"].map)
    _assert_maps_equal(tslam.load_map(p), arc["port"].map)
    assert not list(tmp_path.glob("*.tmp.npz"))
    np.savez(str(tmp_path / "v2.npz"), version=np.int64(2))
    with pytest.raises(ValueError):
        tslam.load_map(str(tmp_path / "v2.npz"))


def test_resume_tracking_from_reference_map(arc):
    """The port loads the map the reference's loop saved and tracks on
    along the arc (as test_slam.py's TestCheckpoint.test_resume_tracking):
    every one of 4 more frames gets a pose, centre within 0.05 of the
    truth in the map's own frame."""
    sys2 = tslam.MonocularSlam(K, tslam.SlamConfig(**ARC_CFG), device="cpu")
    sys2.map = tslam.load_map(arc["path"])
    sys2.state = tslam.TrackingState.TRACKING
    sys2._frame_idx = arc["ref"]._frame_idx
    rng = np.random.default_rng(12)
    gt = ts._camera_poses_circle(29, full=60.0 / 360.0 * 29 / 25)
    np.testing.assert_allclose(gt[:25], arc["gt"], atol=1e-6)
    # the map's frame: the reference's keyframe centres aligned to gt
    kfs = arc["ref"].map.keyframes
    est = tslam.poses7_to_t44(np.stack([kf.pose for kf in kfs]),
                              invert=True, device="cpu")[:, :3, 3]
    truth = tslam.poses7_to_t44(gt[[kf.frame_idx for kf in kfs]],
                                invert=True, device="cpu")[:, :3, 3]
    s, r, t = tslam.umeyama_alignment(est, truth)
    ok = 0
    for pose in gt[25:]:
        xy, d, _ = ts._observe(arc["pts"], arc["desc"], pose, K, 0.2, rng)
        res = sys2.process_observations(xy, d)
        ok += res.pose is not None
        c = tslam.poses7_to_t44(res.pose[None], invert=True,
                                device="cpu")[0, :3, 3]
        c_gt = tslam.poses7_to_t44(pose[None], invert=True,
                                   device="cpu")[0, :3, 3]
        assert np.linalg.norm(s * r @ c + t - c_gt) < 0.05
    assert ok == 4
    assert sys2.state == tslam.TrackingState.TRACKING


# --------------------------------------------------------------------------
# the map and evaluation
# --------------------------------------------------------------------------


def test_slam_map_operations_equal():
    """The same add_keyframe / add_points / add_observation / add_edge
    calls through both packages: the same map, and local_point_ids and
    observations_for_ba equal for every window, with invalidated points
    left out; convert.slam_map carries the reference's map across."""
    maps = [_loop_map(mod)[0] for mod in (jslam, tslam)]
    for m in maps:
        m.point_valid[::7] = False
    ref, port = maps
    _assert_maps_equal(port, ref)
    _assert_maps_equal(convert.slam_map(dataclasses.asdict(ref)), ref)
    for n in (1, 3, 5, 17, 100):
        got = port.local_point_ids(n)
        np.testing.assert_array_equal(got, ref.local_point_ids(n))
        assert got.dtype == np.int64 and np.all(np.diff(got) > 0)
    for ids in ([0], [3, 4, 5, 6], list(range(17)), [16, 2, 9]):
        for min_obs in (1, 2, 3):
            for got, want in zip(port.observations_for_ba(ids, min_obs),
                                 ref.observations_for_ba(ids, min_obs)):
                assert got.dtype == want.dtype
                np.testing.assert_array_equal(got, want)
    assert tslam.SlamMap().local_point_ids(5).size == 0
    with pytest.raises(ValueError):
        convert.slam_map({"keyframes": []})


def test_evaluate_matches_reference():
    """umeyama_alignment, absolute_trajectory_error and
    relative_pose_error within 1e-12 (the same float64 numpy);
    poses7_to_t44 within 1e-6 (float32 Lie-group ops in both)."""
    rng = np.random.default_rng(3)
    src = rng.standard_normal((50, 3))
    q = rng.standard_normal(4)
    q /= np.linalg.norm(q)
    rot = np.asarray(jlg.quat_to_matrix(jnp.asarray(q, jnp.float32)),
                     np.float64)
    dst = 1.7 * src @ rot.T + [0.3, -1.0, 2.0] + rng.normal(0, 0.01,
                                                            src.shape)
    for with_scale in (True, False):
        s_r, r_r, t_r = jslam.umeyama_alignment(src, dst, with_scale)
        s_p, r_p, t_p = tslam.umeyama_alignment(src, dst, with_scale)
        assert abs(s_p - s_r) <= 1e-12
        np.testing.assert_allclose(r_p, r_r, atol=1e-12)
        np.testing.assert_allclose(t_p, t_r, atol=1e-12)
        for align in (True, False):
            a = jslam.absolute_trajectory_error(src, dst, align, with_scale)
            b = tslam.absolute_trajectory_error(src, dst, align, with_scale)
            for f in ("rmse", "mean", "median", "max", "scale"):
                assert abs(getattr(a, f) - getattr(b, f)) <= 1e-12
            np.testing.assert_allclose(b.errors, a.errors, atol=1e-12)
    with pytest.raises(ValueError):
        tslam.absolute_trajectory_error(src, dst[:-1])
    poses = ts._camera_poses_circle(12, full=0.7)
    poses[:, 4:] += rng.normal(0, 0.1, (12, 3))
    for invert in (False, True):
        got = tslam.poses7_to_t44(poses, invert=invert, device="cpu")
        want = jslam.poses7_to_t44(poses, invert=invert)
        assert got.dtype == np.float64 and got.shape == (12, 4, 4)
        np.testing.assert_allclose(got, want, atol=1e-6)
    est = tslam.poses7_to_t44(poses, invert=True, device="cpu")
    noisy = est.copy()
    noisy[:, :3, 3] += rng.normal(0, 0.02, (12, 3))
    for delta in (1, 3):
        a = jslam.relative_pose_error(noisy, est, delta)
        b = tslam.relative_pose_error(noisy, est, delta)
        for f in ("trans_rmse", "trans_mean", "rot_rmse_deg",
                  "rot_mean_deg"):
            assert abs(getattr(a, f) - getattr(b, f)) <= 1e-12


# --------------------------------------------------------------------------
# loop closure, method by method, on a seeded drifted map
# --------------------------------------------------------------------------


N_KF = 16


def _pose7(rot, t):
    q = np.asarray(jlg.matrix_to_quat(jnp.asarray(rot, jnp.float32)),
                   np.float64)
    return np.concatenate([q, t])


def _mat(pose7):
    rot = np.asarray(jlg.quat_to_matrix(jnp.asarray(pose7[:4], jnp.float32)),
                     np.float64)
    return rot, np.asarray(pose7[4:], np.float64)


def _loop_map(mod):
    """A map through ``mod``'s SlamMap API (numpy made from seed 5): 16
    keyframes around the full circle of ts._camera_poses_circle (22.5°
    apart, outward-looking), each one's estimate drifted by a world yaw
    of 0.008·i rad and a shift of 0.015·i; every scene point seen by two
    or more of them is a map point at its first keyframe's drifted
    position (+ 0.01 noise); odometry edges between neighbours; then
    keyframe 16 revisits keyframe 0's view with twice the last drift: a
    third of its features that see map points hang on duplicate points of
    their own, the rest are unmapped. Returns (map, scene points)."""
    rng = np.random.default_rng(5)
    pts, desc = ts._make_scene(rng, 900)
    gt = ts._camera_poses_circle(N_KF, full=1.0)
    gt = np.concatenate([gt, gt[:1]])
    drift = [0.008 * i for i in range(N_KF)] + [0.008 * 2 * N_KF]

    def drift_of(i):
        a = drift[i]
        rz = np.array([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0],
                       [0, 0, 1.0]])
        return rz, np.array([1.0, 0.5, 0.0]) * (drift[i] / 0.008) * 0.015

    m = mod.SlamMap()
    feats = []
    for i in range(N_KF + 1):
        xy, _, ids = ts._observe(pts, desc, gt[i], K, 0.3, rng)
        d = desc[ids] ^ ((rng.random((len(ids), 32)) < 0.01).astype(np.uint8)
                         << rng.integers(0, 8, (len(ids), 32)).astype(
                             np.uint8))
        r_gt, t_gt = _mat(gt[i])
        r_d, t_d = drift_of(i)
        # est = gt ∘ D⁻¹: the drifted camera sees D·X where gt sees X
        r_est = r_gt @ r_d.T
        t_est = t_gt - r_est @ t_d
        m.add_keyframe(i, _pose7(r_est, t_est), xy, d)
        feats.append(ids)
    seen = {}
    for i in range(N_KF):
        for row, p in enumerate(feats[i]):
            seen.setdefault(int(p), []).append((i, row))
    mapped = sorted(p for p, o in seen.items() if len(o) >= 2)
    xyz = []
    for p in mapped:
        r_d, t_d = drift_of(seen[p][0][0])
        xyz.append(r_d @ pts[p] + t_d + rng.normal(0, 0.01, 3))
    pids = m.add_points(np.asarray(xyz), desc[mapped],
                        [seen[p] for p in mapped])
    for pid, p in zip(pids, mapped):
        for kf_id, row in seen[p]:
            m.keyframes[kf_id].point_ids[row] = pid
    revisit = m.keyframes[N_KF]
    in_map = set(mapped)
    dups = [row for row, p in enumerate(feats[N_KF])
            if int(p) in in_map][::3]
    r_d, t_d = drift_of(N_KF)
    dup_ids = m.add_points(
        np.stack([r_d @ pts[feats[N_KF][row]] + t_d for row in dups]),
        revisit.descriptors[dups], [[(N_KF, row)] for row in dups])
    revisit.point_ids[dups] = dup_ids
    for i in range(N_KF):
        a, b = m.keyframes[i], m.keyframes[i + 1]
        r_a, t_a = _mat(a.pose)
        r_b, t_b = _mat(b.pose)
        r_ab = r_b @ r_a.T
        m.add_edge(i, i + 1, _pose7(r_ab, t_b - r_ab @ t_a))
    return m, pts


@pytest.fixture(scope="module")
def loop_setup():
    """The drifted map in the reference, the same map carried into the
    port by convert.slam_map, and one vocabulary (reference-built, k 8,
    depth 3, from the scene's descriptors, as test_slam.py builds it)
    carried by convert.vocabulary."""
    ref_map, pts = _loop_map(jslam)
    rng = np.random.default_rng(5)
    vocab = JVocabulary.build(ts._make_scene(rng, 900)[1], k=8, depth=3,
                              seed=1)
    port_vocab = convert.vocabulary(
        {name: getattr(vocab, name) for name in
         ("k", "depth", "children", "node_desc", "word_id", "word_weight")},
        device="cpu")
    return dict(map=ref_map, vocab=vocab, port_vocab=port_vocab)


def _systems(setup, ref_map, draws=None, **over):
    """A reference and a port system over copies of ``ref_map``, keyframes
    0-15 registered in their BoW databases."""
    cfg = dict(LOOP_CFG, **over)
    ref = jslam.MonocularSlam(K, jslam.SlamConfig(**cfg),
                              vocabulary=setup["vocab"])
    ref.map = copy.deepcopy(ref_map)
    port = tslam.MonocularSlam(K, tslam.SlamConfig(**cfg),
                               vocabulary=setup["port_vocab"],
                               device="cpu", draws=draws)
    port.map = convert.slam_map(dataclasses.asdict(ref_map))
    for s in (ref, port):
        s.state = type(s.state).TRACKING
        for kf in s.map.keyframes[:N_KF]:
            s._register_bow(kf)
    return ref, port


@pytest.fixture(scope="module")
def closed(loop_setup):
    """``_try_loop_closure`` of keyframe 16 in both packages, with PGO and
    global BA held back (``_run_pgo`` recorded, not run): the port on the
    reference's PnP draw."""
    draws = RefDraws(0)
    ref, port = _systems(loop_setup, loop_setup["map"], draws=draws,
                         global_ba_on_loop=False)
    pgo_calls = []
    for s in (ref, port):
        s._run_pgo = lambda s=s: pgo_calls.append(s)
    got = (ref._try_loop_closure(ref.map.keyframes[N_KF]),
           port._try_loop_closure(port.map.keyframes[N_KF]))
    return dict(ref=ref, port=port, loop=got, pgo_calls=pgo_calls,
                draws=draws.kinds)


def test_try_loop_closure_matches_reference(loop_setup, closed,
                                            record_property):
    """The same old keyframe (0, the revisited view), one weight-5 edge
    0 → 16 with the relative pose within 1e-4 (measured 8e-6), the same
    fused observations and merged duplicates (78 and 40; the PnP inliers
    are equal on this scene), and PGO reached once in each."""
    ref, port = closed["ref"], closed["port"]
    assert closed["loop"] == (0, 0)
    assert closed["draws"] == ["loop_pnp"]
    assert closed["pgo_calls"] == [ref, port]
    (ri, rj, r_rel, r_w), (pi, pj, p_rel, p_w) = ref.map.edges[-1], \
        port.map.edges[-1]
    assert (ri, rj, r_w) == (pi, pj, p_w) == (0, N_KF, 5.0)
    assert len(port.map.edges) == len(ref.map.edges) == N_KF + 1
    record_property("edge_max", float(np.abs(p_rel - r_rel).max()))
    np.testing.assert_allclose(p_rel, r_rel, atol=1e-4)
    assert port.map.point_obs == ref.map.point_obs
    np.testing.assert_array_equal(port.map.point_valid, ref.map.point_valid)
    merged = int((~ref.map.point_valid).sum())
    fused = sum(len(o) for o in ref.map.point_obs) - sum(
        len(o) for o in loop_setup["map"].point_obs)
    record_property("merged", merged)
    record_property("fused", fused)
    assert merged >= 10 and fused >= 10
    for ka, kb in zip(ref.map.keyframes, port.map.keyframes):
        np.testing.assert_array_equal(kb.point_ids, ka.point_ids)


def _record(module, name, sink):
    """Wrap ``module.name`` so that every result lands in ``sink``."""
    fn = getattr(module, name)

    def rec(*args, **kwargs):
        sink.append(fn(*args, **kwargs))
        return sink[-1]

    return rec


def test_run_pgo_matches_reference(loop_setup, closed, monkeypatch,
                                   record_property):
    """``_run_pgo`` (bucketed padding, PGOParams(max_iterations=15), the
    point drag) on the closed map: after 2 LM iterations (PGOParams
    patched in both) poses and dragged points within 1e-4 (measured
    1.4e-6 and 4.8e-6); after the full 15 the final cost within 1e-5
    relative (measured 5.0e-6: the cost is 1e-3 of the initial, near its
    float32 resolution) and below half the initial in both."""
    after_loop = closed["ref"].map
    for iters in (2, 15):
        with monkeypatch.context() as mp:
            costs = {"ref": [], "port": []}
            for mod, key in ((jsys, "ref"), (tsys, "port")):
                mp.setattr(mod.pgo_mod, "pose_graph_optimize",
                           _record(mod.pgo_mod, "pose_graph_optimize",
                                   costs[key]))
                if iters != 15:
                    params = mod.pgo_mod.PGOParams
                    mp.setattr(mod.pgo_mod, "PGOParams",
                               lambda params=params, **kw: params(
                                   max_iterations=iters))
            ref, port = _systems(loop_setup, after_loop)
            ref._run_pgo()
            port._run_pgo()
        (r_res,), (p_res,) = costs["ref"], costs["port"]
        r_poses = np.stack([kf.pose for kf in ref.map.keyframes])
        p_poses = np.stack([kf.pose for kf in port.map.keyframes])
        record_property(f"poses_max_{iters}",
                        float(np.abs(p_poses - r_poses).max()))
        record_property(f"points_max_{iters}", float(np.abs(
            port.map.point_xyz - ref.map.point_xyz).max()))
        record_property(f"cost_rel_{iters}", abs(
            float(p_res.final_cost) - float(r_res.final_cost))
            / float(r_res.final_cost))
        if iters == 2:
            np.testing.assert_allclose(p_poses, r_poses, atol=1e-4)
            np.testing.assert_allclose(port.map.point_xyz, ref.map.point_xyz,
                                       atol=1e-4)
        else:
            r_cost, p_cost = float(r_res.final_cost), float(p_res.final_cost)
            assert abs(p_cost - r_cost) <= 1e-5 * r_cost
            assert p_cost < 0.5 * float(p_res.initial_cost)
            assert r_cost < 0.5 * float(r_res.initial_cost)
        np.testing.assert_array_equal(port._last_pose, p_poses[-1])


def test_global_ba_matches_reference(loop_setup, closed, monkeypatch,
                                     record_property):
    """``global_ba`` (every keyframe, keyframes 0 and 1 fixed, Huber 2,
    12 iterations, the loop's buckets) on the closed map: the final cost
    within 1e-4 relative of the reference's (measured 8.9e-7) and below
    the initial. ``distributed=True`` over a 1-rank mesh (no process
    group) runs the keyframe-sharded solve (parallel.ba_dist) on the same
    map: its keyframe poses and points within the reference's own bounds
    for the distributed against the single-host global BA
    (tests/test_slam.py: 5e-3 and 2e-2)."""
    costs = {"ref": [], "port": []}
    for mod, key in ((jsys, "ref"), (tsys, "port")):
        monkeypatch.setattr(mod.ba_mod, "bundle_adjust_schur",
                            _record(mod.ba_mod, "bundle_adjust_schur",
                                    costs[key]))
    ref, port = _systems(loop_setup, closed["ref"].map)
    assert ref.global_ba() and port.global_ba()
    (r_res,), (p_res,) = costs["ref"], costs["port"]
    r_cost, p_cost = float(r_res.final_cost), float(p_res.final_cost)
    record_property("cost_rel", abs(p_cost - r_cost) / r_cost)
    assert abs(p_cost - r_cost) <= 1e-4 * r_cost
    assert p_cost < float(p_res.initial_cost)
    assert abs(float(p_res.initial_cost) - float(r_res.initial_cost)) <= \
        1e-5 * float(r_res.initial_cost)
    _, dist = _systems(loop_setup, closed["ref"].map)
    dist.mesh = make_mesh(["cpu"])
    assert dist.global_ba(distributed=True)
    assert costs["port"] == [p_res]     # not the single-host solve
    np.testing.assert_allclose(dist.trajectory(), port.trajectory(),
                               atol=5e-3)
    np.testing.assert_allclose(dist.map.point_xyz, port.map.point_xyz,
                               atol=2e-2)


def test_triangulate_new_matches_reference(loop_setup, record_property):
    """``_triangulate_new`` between keyframes 4 and 5 with their point ids
    cleared: the same accepted pairs (the same new observations; 44 here)
    and points within 1e-4 (float32 DLT, points ~10 units away: measured
    8.6e-6)."""
    base = copy.deepcopy(loop_setup["map"])
    for kf in base.keyframes:
        kf.point_ids[:] = -1
    ref, port = _systems(loop_setup, base)
    for s in (ref, port):
        s._triangulate_new(s.map.keyframes[5], s.map.keyframes[4])
    n0 = base.n_points
    record_property("new_points", ref.map.n_points - n0)
    record_property("points_max", float(np.abs(
        port.map.point_xyz[n0:] - ref.map.point_xyz[n0:]).max()))
    assert port.map.n_points == ref.map.n_points and ref.map.n_points - n0 \
        >= 30
    assert port.map.point_obs[n0:] == ref.map.point_obs[n0:]
    np.testing.assert_allclose(port.map.point_xyz[n0:],
                               ref.map.point_xyz[n0:], atol=1e-4)
    for i in (4, 5):
        np.testing.assert_array_equal(port.map.keyframes[i].point_ids,
                                      ref.map.keyframes[i].point_ids)


def test_loop_scenario_port_alone():
    """The port alone on TestGlobalBA._run_loop_scenario(11) (a full
    circle of 40 observation frames, 43 with the revisit; its own
    vocabulary from the scene's descriptors and its own torch draws):
    a loop fires, a weight-5 edge is in the graph, and the map-wide
    reprojection RMS after the loop's global BA is under 1.0 px, as the
    reference test holds the reference."""
    rng = np.random.default_rng(11)
    pts, desc = ts._make_scene(rng, 900)
    gt = ts._camera_poses_circle(40, full=1.0)
    vocab = Vocabulary.build(desc, k=8, depth=3, seed=1, device="cpu")
    s = tslam.MonocularSlam(K, tslam.SlamConfig(**LOOP_CFG), vocabulary=vocab,
                            device="cpu")
    for i in range(43):
        xy, d, _ = ts._observe(pts, desc, gt[i % 40], K, 0.3, rng)
        s.process_observations(xy, d)
    assert s.state == tslam.TrackingState.TRACKING
    assert any(r.loop_closed_with is not None for r in s.results)
    assert any(w == 5.0 for *_ij, w in s.map.edges)
    assert ts._reproj_rms(s) < 1.0


# --------------------------------------------------------------------------
# the image front end: process_frame on a rendered sequence
# --------------------------------------------------------------------------


def test_process_frame_matches_reference(record_property):
    """Six 240×320 frames of test_torch_track's two-plane scene (planes at
    depth ~5), the camera moving 0.15 along x (~7 px of parallax) and
    turning 0.4° a frame, OrbConfig(300, 4 levels) through both packages'
    process_frame, the port on the reference's draws: the bootstrap at
    the same frame, the same states and keyframes, n_tracked within ±3
    and poses within 2e-3. The two ORBs may differ where the pyramids
    differ by ±1 LSB: measured n_tracked equal and poses ≤ 1.5e-4 apart.
    The parallax is kept at ~7 px a frame: a two-view bootstrap with a
    few px of parallax is ill-conditioned in both packages, and float32
    rounding alone then moves their refined poses far apart."""
    rng = np.random.default_rng(0)
    texs = [ttrack._texture(rng), ttrack._texture(rng)]
    frames = [ttrack._render(ttrack._rot_xyz([0.0, -0.4 * i, 0.0]),
                             np.array([0.15 * i, 0.025 * i, 0.0]), texs)
              for i in range(6)]
    cfg = dict(n_features=300, min_init_matches=40, keyframe_min_interval=2)
    ref = jslam.MonocularSlam(ttrack.K, jslam.SlamConfig(**cfg))
    for f in frames:
        ref.process_frame(f)
    port = tslam.MonocularSlam(ttrack.K, tslam.SlamConfig(**cfg),
                               device="cpu", draws=RefDraws(0))
    for f in frames:
        port.process_frame(torch.from_numpy(f))
    assert [r.state for r in ref.results][:2] == [
        jslam.TrackingState.INITIALIZING, jslam.TrackingState.TRACKING]
    posed = [(a, b) for a, b in zip(ref.results, port.results)
             if a.pose is not None and b.pose is not None]
    record_property("pose_max", max(float(np.abs(a.pose - b.pose).max())
                                    for a, b in posed))
    record_property("n_tracked_diff_max", max(
        abs(a.n_tracked - b.n_tracked) for a, b in posed))
    for a, b in zip(ref.results, port.results):
        assert (a.state.value, a.is_keyframe) == (b.state.value,
                                                  b.is_keyframe), a.frame_idx
        assert abs(a.n_tracked - b.n_tracked) <= 3
        if a.pose is not None:
            assert _chord(a.pose[:4], b.pose[:4]) <= 2e-3
            np.testing.assert_allclose(b.pose[4:], a.pose[4:], atol=2e-3)
    assert len(port.map.keyframes) == len(ref.map.keyframes) >= 3


def test_monocular_slam_needs_a_card_by_default():
    """The default device is the card: without one MonocularSlam raises
    and does not carry on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises(RuntimeError):
        tslam.MonocularSlam(K)
    with pytest.raises(RuntimeError):
        tslam.poses7_to_t44(np.tile([1.0, 0, 0, 0, 0, 0, 0], (2, 1)))
