"""The port's distributed layer (kornia_tpu_torch/parallel) against the
reference's (kornia_tpu/parallel), on the CPU.

The reference runs its ``shard_map`` programs on a 4-device sub-mesh of
conftest's 8 virtual CPU devices (jitted here: eager ``shard_map`` takes
~12 s a call). The port runs on 4 spawned gloo CPU ranks
(``parallel.mesh.spawn``): one module-scoped spawn runs every case
inside the ranks (tests/torch_parallel_ranks.py) and returns each rank's
results, while this process computes the reference's. Inputs are the
reference tests' own generators (tests/test_optim.py's
``make_ba_scene(seed=3, n_poses=6, n_points=96, noise_px=0.5)``,
tests/test_parallel2.py's noisy circle graph and skewed traffic), made
with numpy from their seeds and fed to both packages.

Host plans and received rows are compared exactly. Solves are held to
the reference's own bounds for two reduction orders of one distributed
problem (tests/test_ba_dist.py: cost rtol 1e-3, poses atol 5e-4 (1e-3
with priors), points atol 5e-3; tests/test_parallel2.py: PGO poses atol
5e-3), and every rank's result must be bit-equal to rank 0's. One
8-rank case runs the port's counterpart of
``__graft_entry__.dryrun_multichip(8)``; the reference's own run takes
~41 s on this CPU (eager ``shard_map``), past this file's 60 s budget, so
it is held to the numbers that run recorded in MULTICHIP_r05.json.
"""

import concurrent.futures
import json
import os
import re

import numpy as np
import pytest
import torch

import jax
from jax.sharding import Mesh as JMesh

from kornia_tpu.optim import ba as jba
from kornia_tpu.optim import pgo as jpgo
from kornia_tpu.parallel import ba_dist as jbad
from kornia_tpu.parallel import exchange as jex
from kornia_tpu.parallel import pgo_dist as jpgod

import test_parallel2 as tp2
from test_optim import make_ba_scene

import torch_parallel_ranks as ranks
from kornia_tpu_torch import convert
from kornia_tpu_torch.features import matching, orb
from kornia_tpu_torch.geometry import liegroup as tlg
from kornia_tpu_torch.optim import ba as tba
from kornia_tpu_torch.parallel import ba_dist, exchange, pgo_dist
from kornia_tpu_torch.parallel import mesh as tmesh
from kornia_tpu_torch.slam import system as tslam
from kornia_tpu_torch.slam.map import SlamMap

torch.set_num_threads(1)

D = 4
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPAWN_TIMEOUT = 300.0


def _ref_mesh(d=D):
    return JMesh(np.asarray(jax.devices()[:d]), ("obs",))


def _host_fields(nt):
    """A reference NamedTuple's fields as numpy (tuples stay tuples)."""
    def host(v):
        if v is None or isinstance(v, (bool, int, str)):
            return v
        if isinstance(v, tuple):
            return v if all(isinstance(x, int) for x in v) else tuple(
                np.asarray(x) for x in v)
        return np.asarray(v)
    return {k: host(v) for k, v in nt._asdict().items()}


def _assert_same_fields(got, want):
    """Field for field: equal values and dtypes, exactly."""
    assert type(got) is type(want)
    for name in got._fields:
        g, w = getattr(got, name), getattr(want, name)
        if isinstance(w, tuple) and w and isinstance(w[0], np.ndarray):
            assert len(g) == len(w), name
            pairs = list(zip(g, w))
        else:
            pairs = [(g, w)]
        for a, b in pairs:
            if isinstance(b, np.ndarray):
                assert a.dtype == b.dtype, (name, a.dtype, b.dtype)
                np.testing.assert_array_equal(a, b, err_msg=name)
            else:
                assert a == b, (name, a, b)


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------


def _depth_for(scene):
    """tests/test_ba_dist.py's ``_depth_for``: each observation's true
    camera-frame depth (numpy over the port's se3_apply: float32 rounding
    of the same formula; both packages get these same values)."""
    (poses_gt, _, pts_gt, _, k, obs_cam, obs_pt, _, _) = scene
    pc = tlg.se3_apply(torch.as_tensor(poses_gt)[obs_cam],
                       torch.as_tensor(pts_gt)[obs_pt]).numpy()
    return pc[:, 2].astype(np.float32)


def _prior_args(scene):
    """tests/test_ba_dist.py's priors: no fixed pose, the first two
    camera centres anchored at σ 1e-3."""
    poses_gt = scene[0]
    rm = tlg.quat_to_matrix(torch.as_tensor(poses_gt[:, :4])).numpy()
    centers = -np.einsum("pji,pj->pi", rm, poses_gt[:, 4:])
    sigma = np.full(poses_gt.shape[0], np.nan, np.float32)
    sigma[:2] = 1e-3
    return dict(pose_prior_center=centers, pose_prior_sigma=sigma)


@pytest.fixture(scope="module")
def scene():
    return make_ba_scene(seed=3, n_poses=6, n_points=96, noise_px=0.5)


def _problems(scene):
    """The three BA problems of tests/test_ba_dist.py (plain, RGB-D depth,
    pose priors), each built by both packages from the same arrays:
    {name: (reference BAProblem, port BAProblem)}."""
    (_, poses_init, _, pts_init, k, obs_cam, obs_pt, obs_uv, fixed) = scene
    base = (poses_init, pts_init, k, obs_cam, obs_pt, obs_uv)
    extra = {
        "plain": dict(fixed_poses=fixed),
        "depth": dict(fixed_poses=fixed, obs_depth=_depth_for(scene),
                      obs_depth_w=np.full(len(obs_cam), 50.0, np.float32)),
        "priors": _prior_args(scene),
    }
    return {name: (jba.build_problem(*base, **kw),
                   tba.build_problem(*base, **kw, device="cpu"))
            for name, kw in extra.items()}


# name: (problem, layout, params kwargs, S budget or None, the solver
# mode it takes, the reference test it follows and that test's bounds:
# "cost" rtol to the reference, "poses" / "points" atol, "drop" the final
# cost below that share of the initial)
_IDENT = dict(max_iterations=10, loss="identity")
_PCG = dict(_IDENT, solver="pcg")
_MATFREE = dict(max_iterations=8, solver="pcg", cg_iters=40)
_HUBER = dict(max_iterations=12, loss="huber", loss_scale=2.0)
_SINGLE = dict(cost=1e-3, poses=5e-4, points=5e-3)
BA_CASES = {
    # test_dist_matches_single_host
    "chol_colo": ("plain", "colo", _IDENT, None, "chol", _SINGLE),
    # test_kf_sharded_exchange_matches_colocated
    "chol_kf": ("plain", "kf", _IDENT, None, "chol", _SINGLE),
    # test_dist_pcg_matches_dense holds the PCG by its cost (< 0.2 × the
    # initial, ≤ 1.3 × the dense solve's); held here to the reference's
    # PCG cost itself
    "cg_dense_kf": ("plain", "kf", _PCG, None, "cg_dense",
                    dict(cost=1e-3, drop=0.2)),
    # test_matfree_pcg_budget_fallback (_S_MAT_BYTES = 0)
    "cg_matfree_colo": ("plain", "colo", _MATFREE, 0, "cg_matfree",
                        dict(cost=1e-3, drop=0.2)),
    # test_dist_reduces_cost
    "huber_colo": ("plain", "colo", _HUBER, None, "chol",
                   dict(cost=1e-3, drop=0.2)),
    # test_kf_sharded_depth_matches_single_host
    "depth_kf": ("depth", "kf", _IDENT, None, "chol",
                 dict(cost=1e-3, poses=5e-4)),
    # test_pose_priors_distributed_match_single_host
    "priors_kf": ("priors", "kf", _IDENT, None, "chol",
                  dict(cost=1e-3, poses=1e-3)),
}


def _exchange_traffic(rng, d, m, n_cam=10, pts_per_shard=8):
    src = rng.integers(0, d, m)
    cam = rng.integers(0, n_cam, m).astype(np.int32)
    pt = rng.integers(0, d * pts_per_shard, m)
    uv = rng.random((m, 2)).astype(np.float32)
    return src, cam, pt, uv


def _skewed_traffic(rng, d=D, hot=600, cold=6, per=10, hot_pair=(1, 3)):
    """tests/test_parallel2.py's skewed co-visibility at D ranks: one hot
    (source, dest) pair of ``hot`` observations, ``cold`` between every
    other pair."""
    src, cam, pt = [hot_pair[0]] * hot, list(rng.integers(0, 4, hot)), \
        list(rng.integers(hot_pair[1] * per, (hot_pair[1] + 1) * per, hot))
    for s in range(d):
        for t in range(d):
            if (s, t) != hot_pair:
                src += [s] * cold
                cam += list(rng.integers(0, 4, cold))
                pt += list(rng.integers(t * per, (t + 1) * per, cold))
    uv = rng.random((len(src), 2)).astype(np.float32)
    return np.asarray(src), np.asarray(cam, np.int32), np.asarray(pt), uv


def _exchange_plans():
    """{name: (args, kwargs)} of build_exchange_plan on 4 shards."""
    rng = np.random.default_rng(1)
    traffic = _exchange_traffic(rng, D, 96)
    depth = rng.uniform(1, 5, 96).astype(np.float32)
    return {
        "a2a": (traffic + (D, 8), dict(mode="a2a")),
        "rounds": (traffic + (D, 8), dict(mode="rounds")),
        "depth": (traffic + (D, 8), dict(obs_depth=depth)),
        "skewed": (_skewed_traffic(np.random.default_rng(6)) + (D, 10), {}),
    }


def _frames():
    """tests/test_parallel2.py's front-end frames (24×32 noise blown up
    8×), 4 of them."""
    rng = np.random.default_rng(3)
    small = (rng.random((D, 24, 32)) * 255).astype(np.uint8)
    return np.stack([np.kron(s, np.ones((8, 8))).astype(np.uint8)
                     for s in small])


def _slam_map(scene):
    """A map of the BA scene's 6 keyframes (initial poses), its 96 points
    with their observations, and a pose graph: consecutive keyframes
    joined by their true relative poses and a weight-5 loop edge 5 → 0."""
    (poses_gt, poses_init, _, pts_init, _, obs_cam, obs_pt, obs_uv,
     _) = scene
    m = SlamMap()
    for c in range(len(poses_gt)):
        sel = obs_cam == c
        m.add_keyframe(c, poses_init[c], obs_uv[sel],
                       np.zeros((int(sel.sum()), 32), np.uint8))
    m.add_points(pts_init, np.zeros((len(pts_init), 32), np.uint8),
                 [[] for _ in pts_init])
    for c in range(len(poses_gt)):
        for fi, pid in enumerate(obs_pt[obs_cam == c]):
            m.add_observation(int(pid), c, fi)
    gt = torch.as_tensor(poses_gt)
    for a, b, w in [(i, i + 1, 1.0) for i in range(len(poses_gt) - 1)] \
            + [(len(poses_gt) - 1, 0, 5.0)]:
        rel = tlg.se3_compose(gt[b], tlg.se3_inverse(gt[a])).numpy()
        m.add_edge(a, b, rel, w)
    return m


# ---------------------------------------------------------------------------
# the reference's distributed results (computed while the ranks run)
# ---------------------------------------------------------------------------


def _ref_ba(problems):
    out = {}
    mesh = _ref_mesh()
    for name, (prob, layout, kw, s_mat, _, _) in BA_CASES.items():
        ref = problems[prob][0]
        params = jba.BAParams(**kw)
        sharded = (jbad.shard_problem(ref, D) if layout == "colo"
                   else jbad.shard_problem_by_keyframe(ref, D))
        fn = (jbad.bundle_adjust_schur_dist if layout == "colo"
              else jbad.bundle_adjust_schur_dist_kf)
        saved = jbad._S_MAT_BYTES
        if s_mat is not None:
            jbad._S_MAT_BYTES = s_mat
        try:
            res = jax.jit(lambda: fn(sharded, mesh, params))()
            out[name] = {"poses": np.asarray(res.poses),
                         "points": np.asarray(res.points),
                         "initial_cost": float(res.initial_cost),
                         "final_cost": float(res.final_cost)}
        finally:
            jbad._S_MAT_BYTES = saved
    return out


@pytest.fixture(scope="module")
def pgo_graph():
    return tp2._noisy_circle_graph(np.random.default_rng(2))


@pytest.fixture(scope="module")
def run(scene, pgo_graph):
    """Every rank's results (4 gloo CPU ranks) and the reference's."""
    problems = _problems(scene)
    ba_inputs = {}
    for name, (prob, layout, kw, s_mat, _, _) in BA_CASES.items():
        port = problems[prob][1]
        sharded = (ba_dist.shard_problem(port, D) if layout == "colo"
                   else ba_dist.shard_problem_by_keyframe(port, D))
        ba_inputs[name] = (layout, sharded, tba.BAParams(**kw),
                           ba_dist._S_MAT_BYTES if s_mat is None else s_mat)
    _, poses0, ei, ej, meas, w = pgo_graph
    plans = {name: exchange.build_exchange_plan(*a, **kw)
             for name, (a, kw) in _exchange_plans().items()}
    inputs = {"ba": ba_inputs,
              "pgo": pgo_dist.shard_pgo(poses0, ei, ej, meas, w,
                                        n_devices=D),
              "exchange": plans,
              "frames": (_frames(), orb.OrbConfig(n_features=128,
                                                  n_levels=2)),
              "slam": (scene[4], _slam_map(scene))}
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        fut = pool.submit(tmesh.spawn, ranks.cases, D, inputs,
                          devices=["cpu"] * D, timeout=SPAWN_TIMEOUT)
        ref = {"ba": _ref_ba(problems)}
        ref["pgo"] = jpgod.pose_graph_optimize_dist(
            jpgod.shard_pgo(poses0, ei, ej, meas, w, n_devices=D),
            _ref_mesh(), jpgo.PGOParams(max_iterations=15))
        ref["exchange"] = {
            name: [np.asarray(f) for f in jex.exchange_observations(
                jex.build_exchange_plan(*a, **kw), _ref_mesh())]
            for name, (a, kw) in _exchange_plans().items()}
        got = fut.result()
    return {"ranks": got, "ref": ref, "inputs": inputs,
            "problems": problems}


# ---------------------------------------------------------------------------
# host plans: field for field, exact
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("layout", ["colo", "kf"])
@pytest.mark.parametrize("prob", ["plain", "depth", "priors"])
@pytest.mark.parametrize("d", [4, 8])
def test_shard_problem_plans_equal_reference(scene, prob, layout, d):
    """shard_problem / shard_problem_by_keyframe of the same problem: every
    field of the port's host plan equals the reference's (carried over by
    convert.sharded_problem), dtypes too; the payload routes every real
    observation exactly once (its weight column sums to the problem's)."""
    ref, port = _problems(scene)[prob]
    if layout == "colo":
        want, got = jbad.shard_problem(ref, d), ba_dist.shard_problem(port, d)
    else:
        want = jbad.shard_problem_by_keyframe(ref, d)
        got = ba_dist.shard_problem_by_keyframe(port, d)
        payload = (got.payload if got.mode == "a2a"
                   else np.concatenate([x.reshape(-1, x.shape[-1])
                                        for x in got.payload]))
        assert float(payload[..., 4].sum()) == float(port.obs_w.sum())
    _assert_same_fields(got, convert.sharded_problem(_host_fields(want)))


@pytest.mark.parametrize("d", [1, 4, 8])
def test_shard_pgo_plan_equals_reference(pgo_graph, d):
    """shard_pgo of the noisy circle graph: every field equal."""
    _, poses0, ei, ej, meas, w = pgo_graph
    _assert_same_fields(
        pgo_dist.shard_pgo(poses0, ei, ej, meas, w, n_devices=d),
        convert.sharded_problem(_host_fields(
            jpgod.shard_pgo(poses0, ei, ej, meas, w, n_devices=d))))


def _plan_cases():
    rng = np.random.default_rng(7)
    uniform = _exchange_traffic(rng, 8, 640, pts_per_shard=10)
    hot = tp2.TestExchangeSkew()._skewed(np.random.default_rng(5))
    cases = {name: (a, kw) for name, (a, kw) in _exchange_plans().items()}
    cases["uniform_auto_8"] = (uniform + (8, 10), {})
    cases["hot_pair_auto_8"] = (hot[:4] + (8, 10), {})
    cases["empty"] = ((np.zeros(0, np.int64), np.zeros(0, np.int32),
                       np.zeros(0, np.int64), np.zeros((0, 2), np.float32),
                       D, 4), dict(mode="rounds"))
    return cases


@pytest.mark.parametrize("case", list(_plan_cases()))
def test_exchange_plan_equals_reference(case):
    """build_exchange_plan in a2a, rounds, with depth columns, auto on
    uniform traffic (stays a2a) and on tests/test_parallel2.py's hot pair
    (switches to rounds), and with no traffic: every field and the
    payload bytes equal the reference's; each shard's host receive order
    too."""
    args, kw = _plan_cases()[case]
    got = exchange.build_exchange_plan(*args, **kw)
    want = jex.build_exchange_plan(*args, **kw)
    _assert_same_fields(got, exchange.ExchangePlan(
        **_host_fields(want)))
    assert got.payload_bytes == want.payload_bytes
    if case == "uniform_auto_8":
        assert got.mode == "a2a"
    if case == "hot_pair_auto_8":
        assert got.mode == "rounds"
    d = args[4]
    for dest in range(d):
        np.testing.assert_array_equal(
            exchange.host_receive_order(got, dest, d),
            jex.host_receive_order(want, dest, d))


# ---------------------------------------------------------------------------
# on the ranks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", list(_exchange_plans()))
def test_exchange_rows_equal_reference(run, case):
    """exchange_observations on 4 ranks: every rank returns every shard's
    received rows, equal to the host receive order and to the reference's
    exchange, exactly; one all_to_all (a2a) or one per nonzero offset
    (rounds), plus the gathering all-gather."""
    plan = run["inputs"]["exchange"][case]
    want_rows = np.stack([exchange.host_receive_order(plan, dd, D)
                          for dd in range(D)])
    n_coll = 1 if plan.mode == "a2a" else sum(r % D != 0
                                              for r in plan.rounds)
    for res in run["ranks"]:
        fields, n = res["exchange"][case]
        assert n == n_coll + 1
        ref = run["ref"]["exchange"][case]
        assert len(fields) == len(ref) == (6 if case == "depth" else 4)
        for f, r in zip(fields, ref):
            np.testing.assert_array_equal(f, r)
        np.testing.assert_array_equal(fields[0], want_rows[..., 0])
        np.testing.assert_array_equal(fields[2], want_rows[..., 2:4])
    if case == "skewed":
        assert plan.mode == "rounds"


@pytest.mark.parametrize("case", list(BA_CASES))
def test_ba_dist_matches_reference(run, case):
    """bundle_adjust_schur_dist(_kf) on 4 ranks against the reference's
    distributed solve of the same case, under the bounds of the reference
    test the case follows (BA_CASES: cost rtol 1e-3; poses atol 5e-4, 1e-3
    with priors; points atol 5e-3; the cost below 0.2 × the initial), on
    what that test holds: it holds the PCG, Huber and priors cases by
    their costs (on this scene the monocular scale is a gauge the float32
    PCG wanders along: the reference's own cg_dense poses move by 6.2e-3
    between its 2-, 4- and 8-device meshes at equal cost). Every rank's
    poses, points and costs are bit-equal to rank 0's; the collectives per
    solve are the design's: the initial cost, 2 a LM iteration (+1 a CG
    step in cg_matfree), the closing all-gather, and the exchange's in the
    keyframe layout; the solver mode is the reference's static pick."""
    prob, layout, kw, _, mode, tol = BA_CASES[case]
    got = [r["ba"][case] for r in run["ranks"]]
    want = run["ref"]["ba"][case]
    for key in ("initial_cost", "final_cost"):
        np.testing.assert_allclose(got[0][key], want[key], rtol=tol["cost"])
    for key in ("poses", "points"):
        if key in tol:
            np.testing.assert_allclose(got[0][key], want[key], atol=tol[key])
    assert got[0]["final_cost"] < tol.get("drop", 0.5) * \
        got[0]["initial_cost"]
    for g in got[1:]:
        for key in ("poses", "points"):
            np.testing.assert_array_equal(g[key], got[0][key])
        assert g["final_cost"] == got[0]["final_cost"]
    assert all(g["mode"] == mode for g in got)
    sharded = run["inputs"]["ba"][case][1]
    per_iter = 2 + (kw["cg_iters"] if mode == "cg_matfree" else 0)
    n_ex = 0
    if layout == "kf":
        n_ex = 1 if sharded.mode == "a2a" else sum(
            r % D != 0 for r in sharded.rounds)
    assert got[0]["collectives"] == 1 + per_iter * kw["max_iterations"] \
        + 1 + n_ex


def test_pgo_dist_matches_reference(run, pgo_graph):
    """pose_graph_optimize_dist on 4 ranks (15 iterations) against the
    reference's distributed PGO: poses atol 5e-3 (tests/test_parallel2.py's
    bound; the optimum is float32-flat), the cost does not rise, every
    rank bit-equal; H and g in one all_reduce, the cost in another: 2 a
    LM iteration plus the initial cost."""
    got = [r["pgo"] for r in run["ranks"]]
    ref = run["ref"]["pgo"]
    np.testing.assert_allclose(got[0]["poses"], np.asarray(ref.poses),
                               atol=5e-3)
    np.testing.assert_allclose(got[0]["initial_cost"],
                               float(ref.initial_cost), rtol=1e-5)
    assert got[0]["final_cost"] <= got[0]["initial_cost"]
    for g in got[1:]:
        np.testing.assert_array_equal(g["poses"], got[0]["poses"])
        assert g["final_cost"] == got[0]["final_cost"]
    assert got[0]["collectives"] == 1 + 2 * 15


def test_frontend_dist_equals_single_process(run):
    """detect_and_describe_batch over 4 ranks (one frame a rank): every
    rank returns all 4 frames' features, each field bit-equal to the
    port's single-process ORB of that frame; match_batch of frame i
    against frame i − 1 bit-equal to match_descriptors."""
    frames, cfg = run["inputs"]["frames"]
    single = [orb.orb_detect_and_describe(f, cfg, device="cpu")
              for f in frames]
    for res in run["ranks"]:
        for i, name in enumerate(orb.OrbFeatures._fields):
            np.testing.assert_array_equal(
                res["features"][i],
                np.stack([getattr(s, name).numpy() for s in single]),
                err_msg=name)
        for j in range(D):
            m = matching.match_descriptors(
                single[j].descriptors, single[j - 1].descriptors,
                a_mask=single[j].mask, b_mask=single[j - 1].mask,
                max_distance=64, ratio=0.8, device="cpu")
            for i, f in enumerate(m):
                np.testing.assert_array_equal(res["matches"][i][j],
                                              f.numpy())
    assert int(run["ranks"][0]["features"][5].sum()) > 0


def test_monocular_slam_mesh_matches_single_process(run, scene):
    """MonocularSlam(mesh=) on rank 0 with ranks 1-3 in parallel.follow:
    global_ba (keyframe-sharded, distributed by default on a 4-rank mesh)
    then _run_pgo (edge-sharded) on the BA scene's map. The followers
    joined both solves; the keyframe poses and points match the same two
    calls of a single-process system within tests/test_slam.py's bounds
    for the distributed against the single-host global BA (poses 5e-3,
    points 2e-2)."""
    k, slam_map = run["inputs"]["slam"]
    single = tslam.MonocularSlam(k, device="cpu")
    single.map = slam_map
    assert single.global_ba()
    single._run_pgo()
    lead = run["ranks"][0]["slam"]
    assert lead["ok"]
    assert all(r["slam"]["jobs"] == 2 for r in run["ranks"][1:])
    np.testing.assert_allclose(lead["poses"], single.trajectory(), atol=5e-3)
    np.testing.assert_allclose(lead["points"], single.map.point_xyz,
                               atol=2e-2)


def test_one_rank_mesh_without_process_group(scene):
    """A 1-rank mesh made without a process group: the distributed BA
    runs its collectives as the identity and counts none, and equals the
    reference's 1-device distributed solve (tests/test_ba_dist.py's
    bounds)."""
    ref, port = _problems(scene)["plain"]
    params = dict(max_iterations=10, loss="identity")
    m = tmesh.make_mesh(["cpu"])
    assert (m.rank, m.size, m.devices.size) == (0, 1, 1)
    got = ba_dist.bundle_adjust_schur_dist_kf(
        ba_dist.shard_problem_by_keyframe(port, 1), m,
        tba.BAParams(**params))
    sharded = jbad.shard_problem_by_keyframe(ref, 1)
    want = jax.jit(lambda: jbad.bundle_adjust_schur_dist_kf(
        sharded, _ref_mesh(1), jba.BAParams(**params)))()
    assert m.counts == {"collectives": 0, "bytes": 0}
    np.testing.assert_allclose(float(got.final_cost), float(want.final_cost),
                               rtol=1e-3)
    np.testing.assert_allclose(got.poses.numpy(), np.asarray(want.poses),
                               atol=5e-4)
    np.testing.assert_allclose(got.points.numpy(), np.asarray(want.points),
                               atol=5e-3)


def test_spawn_reports_a_failing_rank():
    """A rank that raises makes spawn raise with its traceback (and stop
    the other ranks, which wait in a collective)."""
    with pytest.raises(RuntimeError, match="rank 1 fails on purpose"):
        tmesh.spawn(ranks.fail_on_rank, 2, 1, devices=["cpu"] * 2,
                    timeout=SPAWN_TIMEOUT)


def test_dryrun_multichip_8_ranks_matches_record():
    """The port's counterpart of ``dryrun_multichip(8)`` on 8 gloo CPU
    ranks, held to the reference's run recorded in MULTICHIP_r05.json:
    keypoints exact (512), the keyframe-sharded BA cost 116.8893 →
    45.2737 and PGO 0.0229 → 0.0000 each within 1e-3 relative plus half a
    unit of the record's 4th decimal (it prints 4 decimals); the
    co-located layout reaches the same cost (rtol 1e-3); every rank
    bit-equal."""
    with open(os.path.join(ROOT, "MULTICHIP_r05.json")) as f:
        tail = json.load(f)["tail"]
    n_kp, c0, c1, p0, p1 = (float(x) for x in re.search(
        r"front-end (\d+) kp, kf-sharded BA cost ([\d.]+) -> ([\d.]+), "
        r"PGO cost ([\d.]+) -> ([\d.]+)", tail).groups())
    got = tmesh.spawn(ranks.dryrun, 8, devices=["cpu"] * 8,
                      timeout=SPAWN_TIMEOUT)
    r0 = got[0]
    assert r0["n_det"] == n_kp == 512
    for value, want in ((r0["kf"]["initial_cost"], c0),
                        (r0["kf"]["final_cost"], c1),
                        (r0["pgo"][0], p0), (r0["pgo"][1], p1)):
        assert abs(value - want) <= 1e-3 * abs(want) + 5e-5, (value, want)
    np.testing.assert_allclose(r0["colo"]["final_cost"],
                               r0["kf"]["final_cost"], rtol=1e-3)
    for g in got[1:]:
        np.testing.assert_array_equal(g["kf"]["poses"], r0["kf"]["poses"])
        assert g["pgo"] == r0["pgo"] and g["n_det"] == r0["n_det"]
