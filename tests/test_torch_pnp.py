"""The port's tracking geometry (kornia_tpu_torch/geometry: linalg,
liegroup, the PnP solvers, ransac with a PnP model, refine) against the
JAX package on seed-made inputs; ``solve_pnp_ransac`` is in
test_torch_pnp_ransac.py, which shares the helpers below. RANSAC draws
come from ``jax.random`` in the reference; the port is handed the
reference's own draw through ``sample_idx=``. The reference runs jitted
on the CPU; the port on ``device="cpu"``."""

import functools

import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

import jax
import jax.numpy as jnp

from kornia_tpu.geometry import linalg as jla
from kornia_tpu.geometry import liegroup as jlg
from kornia_tpu.geometry import pnp as jpnp
from kornia_tpu.geometry import ransac as jransac
from kornia_tpu.geometry import refine as jrefine

from kornia_tpu_torch import convert
from kornia_tpu_torch.geometry import epipolar as tepi
from kornia_tpu_torch.geometry import linalg as tla
from kornia_tpu_torch.geometry import liegroup as tlg
from kornia_tpu_torch.geometry import pnp as tpnp
from kornia_tpu_torch.geometry import ransac as transac
from kornia_tpu_torch.geometry import refine as trefine

# One intra-op thread: these tests run many small ops, and torch's pool
# of a thread per core spins against the other test processes.
torch.set_num_threads(1)

T = functools.partial(convert.tensor, device="cpu")
K = np.array([[500.0, 0.0, 320.0], [0.0, 500.0, 240.0], [0.0, 0.0, 1.0]],
             np.float32)
R_GT = Rotation.from_euler("xyz", [5, -8, 3], degrees=True).as_matrix()
T_GT = np.array([0.3, -0.1, 0.2])


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _rot_angle(r_a, r_b):
    """Rotation angle(s) between r_a and r_b, radians, batched, by the
    Frobenius chord (stable for small angles, unlike an arccos of the
    trace of float32 matrices)."""
    d = np.linalg.norm(np.asarray(r_a, np.float64) - np.asarray(r_b,
                                                                np.float64),
                       axis=(-2, -1))
    return 2 * np.arcsin(np.minimum(d / (2 * np.sqrt(2)), 1.0))


def _project(world, r=R_GT, t=T_GT):
    cam = world @ r.T + t
    return cam[..., :2] / cam[..., 2:] * [K[0, 0], K[1, 1]] + [K[0, 2],
                                                                K[1, 2]]


def _scene(seed, n=160, pad=32, noise=0.5, outliers=0.25):
    """n world points in front of the camera, their pixels under the known
    pose with noise and a share of uniform outliers, then ``pad`` padded
    rows (mask False)."""
    rng = np.random.default_rng(seed)
    world = rng.uniform([-2, -2, 4], [2, 2, 8], (n + pad, 3))
    px = _project(world) + rng.normal(0, noise, (n + pad, 2))
    n_out = int(n * outliers)
    px[:n_out] = rng.uniform([0, 0], [640, 480], (n_out, 2))
    mask = np.arange(n + pad) < n
    world[~mask] = 0.0
    px[~mask] = 0.0
    return world.astype(np.float32), px.astype(np.float32), mask


def _minimal_sets(seed, b=64, s=6):
    """b clean (noise-free) s-point sets under the known pose."""
    rng = np.random.default_rng(seed)
    world = rng.uniform([-2, -2, 4], [2, 2, 8], (b, s, 3))
    return world.astype(np.float32), _project(world).astype(np.float32)


# ---------------------------------------------------------------------------
# linalg
# ---------------------------------------------------------------------------


def _sym_batch(seed):
    """Random SPD matrices, then ones with a repeated largest eigenvalue
    (2, 5, 5) and rank-2 ones (0, 1, 4), each under a random rotation.
    A repeated smallest pair is outside the closed form's contract (the
    reference's too: its smallest vector is then not isolated)."""
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(32, 3, 3))
    spd = a @ np.swapaxes(a, -1, -2) + 0.1 * np.eye(3)
    rots = Rotation.random(16, random_state=seed).as_matrix()
    spectra = [(2, 5, 5), (0, 1, 4)] * 8
    special = np.stack([r @ np.diag(s) @ r.T for r, s in zip(rots,
                                                             spectra)])
    return np.concatenate([spd, special]).astype(np.float32)


def test_eigh3x3_matches_reference():
    """Eigenvalues within 1e-4 of the reference's (relative to the
    largest; Cardano's arccos near a double root loses √ε: 6.9e-5 on
    this batch), every decomposition reconstructs S within 1e-4
    relative and is orthonormal within 1e-5, and where an eigenvalue is
    isolated (gap > 1e-2 of the largest) its vector is the reference's
    within 1e-5 (up to sign)."""
    s = _sym_batch(0)
    ev_r, vec_r = jax.jit(jla.eigh3x3)(jnp.asarray(s))
    ev, vec = tla.eigh3x3(T(s))
    ev, vec, ev_r, vec_r = _np(ev), _np(vec), _np(ev_r), _np(vec_r)
    scale = np.abs(ev_r).max(-1, keepdims=True) + 1e-6
    assert (np.abs(ev - ev_r) / scale).max() <= 1e-4
    rec = vec @ (ev[..., :, None] * np.swapaxes(vec, -1, -2))
    assert (np.abs(rec - s).max((-1, -2)) / scale[:, 0]).max() <= 1e-4
    np.testing.assert_allclose(np.swapaxes(vec, -1, -2) @ vec,
                               np.broadcast_to(np.eye(3), vec.shape),
                               atol=1e-5)
    gaps = np.diff(ev_r, axis=-1) / scale
    isolated = np.stack([gaps[:, 0], np.minimum(gaps[:, 0], gaps[:, 1]),
                         gaps[:, 1]], -1) > 1e-2
    dots = np.abs(np.sum(vec * vec_r, axis=-2))
    assert (1.0 - dots[isolated]).max() <= 1e-5
    assert isolated.sum() >= 100


def test_svd3_matches_reference():
    """On 32 full-rank matrices: σ within 2e-5 of the reference's (relative
    to σ₀) and u·diag(σ)·vt reconstructs M within 3e-5 relative. On 16
    rank-2 ones: σ₁, σ₂ within 2e-5, σ₃ ≤ 2e-3·σ₀ in both (√λ₃ of
    float32 MᵀM noise), the reconstruction within 2e-3 relative. vt
    orthonormal within 1e-5 throughout, u within 2e-5 wherever the
    reference's u is (where σ₃'s noise crosses the 1e-3·σ₀ cut, the third
    column of both is σ₃⁻¹·M·v₃, not orthogonal)."""
    rng = np.random.default_rng(1)
    full = rng.normal(size=(32, 3, 3))
    r2 = rng.normal(size=(16, 3, 2)) @ rng.normal(size=(16, 2, 3))
    m = np.concatenate([full, r2]).astype(np.float32)
    u_r, s_r, _ = (_np(x) for x in jax.jit(jla.svd3)(jnp.asarray(m)))
    u, s, vt = (_np(x) for x in tla.svd3(T(m)))
    s0 = s_r[:, :1]
    err = np.abs(s - s_r) / s0
    assert err[:32].max() <= 2e-5 and err[32:, :2].max() <= 2e-5
    assert (s[32:, 2] <= 2e-3 * s0[32:, 0]).all()
    assert (s_r[32:, 2] <= 2e-3 * s0[32:, 0]).all()
    rec = np.abs(u @ (s[..., :, None] * vt) - m).max((-1, -2)) / s0[:, 0]
    assert rec[:32].max() <= 3e-5 and rec[32:].max() <= 2e-3
    eye = np.broadcast_to(np.eye(3), m.shape)
    ok_r = np.abs(np.swapaxes(u_r, -1, -2) @ u_r - eye).max((-1, -2)) <= 1e-5
    assert ok_r.sum() >= 46
    np.testing.assert_allclose((np.swapaxes(u, -1, -2) @ u)[ok_r],
                               eye[ok_r], atol=2e-5)
    np.testing.assert_allclose(vt @ np.swapaxes(vt, -1, -2), eye, atol=1e-5)


def test_inv4x4_matches_reference():
    """Adjugate inverse within 1e-5 relative of the reference's."""
    rng = np.random.default_rng(2)
    m = (rng.normal(size=(64, 4, 4)) + 3 * np.eye(4)).astype(np.float32)
    ref = _np(jax.jit(jla.inv4x4)(jnp.asarray(m)))
    got = _np(tla.inv4x4(T(m)))
    np.testing.assert_allclose(got, ref, rtol=1e-5,
                               atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("with_scale", [False, True])
def test_rigid_transform_3d_matches_reference(weighted, with_scale):
    """Umeyama/Kabsch on 20 points (a batch of 8 sets, the reference
    vmapped): R within 1e-5 rad, t within 1e-5, s within 1e-5 relative of
    the reference's."""
    rng = np.random.default_rng(3)
    src = rng.normal(size=(8, 20, 3)).astype(np.float32)
    rots = Rotation.random(8, random_state=3).as_matrix()
    scale = 1.7 if with_scale else 1.0
    dst = (scale * np.einsum("bij,bnj->bni", rots, src)
           + rng.normal(size=(8, 1, 3)) + rng.normal(0, 0.01, src.shape))
    dst = dst.astype(np.float32)
    w = (rng.uniform(0.2, 1.0, (8, 20)) if weighted
         else np.ones((8, 20))).astype(np.float32)
    ref = jax.jit(jax.vmap(lambda a, b, c: jla.rigid_transform_3d(
        a, b, c, with_scale=with_scale)))(jnp.asarray(src), jnp.asarray(dst),
                                          jnp.asarray(w))
    got = tla.rigid_transform_3d(T(src), T(dst), T(w) if weighted else None,
                                 with_scale=with_scale)
    assert _rot_angle(_np(got[0]), _np(ref[0])).max() <= 1e-5
    np.testing.assert_allclose(_np(got[1]), _np(ref[1]), atol=1e-5)
    np.testing.assert_allclose(_np(got[2]), _np(ref[2]), rtol=1e-5)


@pytest.mark.parametrize("n", [4, 10, 12])
def test_solve_and_det_unrolled_match_reference(n):
    """Unrolled Gauss-Jordan solve and LU determinant on (64, n, n): the
    solve within 1e-4 relative of the reference's and of float64 numpy,
    the determinant within 1e-4 relative; a singular matrix's
    determinant within 1e-5 of 0."""
    rng = np.random.default_rng(4 + n)
    a = rng.normal(size=(64, n, n)).astype(np.float32)
    a[0, -1] = a[0, 0]                  # singular
    b = rng.normal(size=(64, n, 2)).astype(np.float32)
    x_r = _np(jax.jit(jla.solve_unrolled)(jnp.asarray(a[1:]),
                                          jnp.asarray(b[1:])))
    x = _np(tla.solve_unrolled(T(a[1:]), T(b[1:])))
    x64 = np.linalg.solve(a[1:].astype(np.float64), b[1:].astype(np.float64))
    sc = np.abs(x64).max((-1, -2), keepdims=True)
    assert (np.abs(x - x_r) / sc).max() <= 1e-4
    assert (np.abs(x - x64) / sc).max() <= 1e-4
    d_r = _np(jax.jit(jla.det_unrolled)(jnp.asarray(a)))
    d = _np(tla.det_unrolled(T(a)))
    d64 = np.linalg.det(a.astype(np.float64))
    np.testing.assert_allclose(d[1:], d_r[1:], rtol=1e-4)
    np.testing.assert_allclose(d[1:], d64[1:], rtol=1e-4)
    assert abs(d[0]) <= 1e-5 * np.median(np.abs(d64[1:]))


def test_cramer_null_vector_on_det_unrolled():
    """The two-view Cramer null vector takes its minors' determinants from
    linalg.det_unrolled (it was bit-equal to the LU the two-view module
    had, on every call of the two-view tests): on the 8×8 minors of
    8-point systems within 1e-5 relative of the reference's det_unrolled,
    and the null vector annihilates A within 2e-5."""
    rng = np.random.default_rng(5)
    a = rng.normal(size=(32, 8, 9)).astype(np.float32)
    minors = np.stack([np.delete(a, j, axis=-1) for j in range(9)], 1)
    ref = _np(jax.jit(jla.det_unrolled)(jnp.asarray(minors)))
    got = _np(tla.det_unrolled(T(minors)))
    np.testing.assert_allclose(got, ref, rtol=1e-5,
                               atol=1e-6 * np.abs(ref).max())
    v = _np(tepi._nullvec_cramer(T(a)))
    np.testing.assert_allclose(np.einsum("bij,bj->bi", a, v), 0.0,
                               atol=2e-5)


def test_solve_quartic_matches_reference():
    """Ferrari roots in complex64 with two Newton steps, on quartics with
    four real roots and on random ones: as root sets within 1e-3 of the
    reference's for ≥ 99% of them, and every root of the port a root of
    the polynomial (|p(x)| ≤ 1e-3 of the coefficient scale × (1 + |x|)⁴)
    for ≥ 99%."""
    rng = np.random.default_rng(6)
    real = np.stack([np.poly(r) for r in rng.uniform(-3, 3, (500, 4))])
    rand = rng.normal(size=(500, 5))
    c = np.concatenate([real, rand]).astype(np.float32)
    ref = _np(jax.jit(jla.solve_quartic)(jnp.asarray(c)))
    got = _np(tla.solve_quartic(T(c)))
    assert got.dtype == np.complex64
    # match as sets: each port root to its nearest reference root
    d = np.abs(got[:, :, None] - ref[:, None, :]).min(-1).max(-1)
    assert np.mean(d <= 1e-3) >= 0.99
    x = got.astype(np.complex128)
    p = np.stack([np.polyval(ci, xi) for ci, xi in zip(c, x)])
    tol = 1e-3 * np.abs(c).max(-1, keepdims=True) * (1 + np.abs(x)) ** 4
    assert np.mean(np.all(np.abs(p) <= tol, -1)) >= 0.99


def test_hnormalize_and_transform_points_match_reference():
    """Bit-equal division by the last coordinate (|z| < 1e-12 → 1e-12);
    transform_points within 1e-6."""
    rng = np.random.default_rng(7)
    x = rng.normal(size=(50, 4)).astype(np.float32)
    x[0, -1] = 0.0
    np.testing.assert_array_equal(_np(tla.hnormalize(T(x))),
                                  _np(jla.hnormalize(jnp.asarray(x))))
    m = rng.normal(size=(3, 4, 4)).astype(np.float32)
    pts = rng.normal(size=(3, 20, 3)).astype(np.float32)
    np.testing.assert_allclose(
        _np(tla.transform_points(T(m), T(pts))),
        _np(jla.transform_points(jnp.asarray(m), jnp.asarray(pts))),
        atol=1e-6)


# ---------------------------------------------------------------------------
# liegroup
# ---------------------------------------------------------------------------


def _lie_inputs(seed=8):
    """Batches of 16 for every argument kind; tangents include angles
    below the Taylor guard (θ² < 1e-8)."""
    rng = np.random.default_rng(seed)
    f = np.float32

    def tangent(n, dim, rot=slice(0, 3)):
        x = rng.normal(0, 0.8, (16, dim))
        x[:3, rot] *= 1e-6                       # small-angle branches
        return x.astype(f)

    quat = Rotation.random(16, random_state=seed).as_quat()[:, [3, 0, 1, 2]]
    quat2 = Rotation.random(16, random_state=seed + 1).as_quat()[
        :, [3, 0, 1, 2]]
    rot = Rotation.from_quat(quat[:, [1, 2, 3, 0]]).as_matrix()
    t3 = rng.normal(size=(16, 3))
    pose = np.concatenate([quat, t3], -1)
    pose2 = np.concatenate([quat2, rng.normal(size=(16, 3))], -1)
    mat44 = np.concatenate([np.concatenate([rot, t3[:, :, None]], -1),
                            np.tile([[[0, 0, 0, 1.0]]], (16, 1, 1))], -2)
    se2 = np.concatenate([np.stack([np.cos(a := rng.uniform(-3, 3, 16)),
                                    np.sin(a)], -1),
                          rng.normal(size=(16, 2))], -1)
    se2b = np.concatenate([np.stack([np.cos(b := rng.uniform(-3, 3, 16)),
                                     np.sin(b)], -1),
                           rng.normal(size=(16, 2))], -1)
    sim3 = np.concatenate([pose, rng.uniform(0.5, 2, (16, 1))], -1)
    sim3b = np.concatenate([pose2, rng.uniform(0.5, 2, (16, 1))], -1)
    rx = np.concatenate([quat, rng.uniform(0.5, 2, (16, 1))], -1)
    rxb = np.concatenate([quat2, rng.uniform(0.5, 2, (16, 1))], -1)
    sim3_tan = tangent(16, 7, slice(3, 6))
    sim3_tan[3:6, 6] *= 1e-7                     # small-σ branches
    angle = rng.uniform(-3, 3, 16)
    angle[:2] *= 1e-6
    return {
        "q": quat, "q2": quat2, "v3": rng.normal(size=(16, 3)),
        "pts": rng.normal(size=(16, 5, 3)), "w": tangent(16, 3),
        "m33": rot, "skew": np.asarray(jlg.so3_hat(jnp.asarray(
            tangent(16, 3), jnp.float32))),
        "pose": pose, "pose2": pose2, "xi6": tangent(16, 6, slice(3, 6)),
        "m44": mat44, "t3": t3, "angle": angle,
        "z2": np.stack([np.cos(angle), np.sin(angle)], -1),
        "xi3": tangent(16, 3, slice(2, 3)), "se2": se2, "se2b": se2b,
        "pts2": rng.normal(size=(16, 2)), "sim3": sim3, "sim3b": sim3b,
        "xi7": sim3_tan, "rx": rx, "rxb": rxb,
        "xi4": tangent(16, 4, slice(0, 3)),
        "rxpts": rng.normal(size=(16, 5, 3)),
    }


_LIE = {
    "quat_mul": ("q", "q2"), "quat_conj": ("q",), "quat_normalize": ("q",),
    "quat_rotate": ("q", "v3"), "quat_to_matrix": ("q",),
    "so3_hat": ("w",), "so3_vee": ("skew",), "so3_exp": ("w",),
    "so3_log": ("q",), "so3_exp_matrix": ("w",), "so3_log_matrix": ("m33",),
    "so3_left_jacobian": ("w",), "so3_inverse_left_jacobian": ("w",),
    "se3_from_qt": ("q", "t3"), "se3_quat": ("pose",),
    "se3_trans": ("pose",), "se3_compose": ("pose", "pose2"),
    "se3_inverse": ("pose",), "se3_exp": ("xi6",), "se3_log": ("pose",),
    "se3_retract": ("pose", "xi6"), "se3_to_matrix": ("pose",),
    "se3_from_matrix": ("m44",), "se3_adjoint": ("pose",),
    "so2_exp": ("angle",), "so2_log": ("z2",), "se2_exp": ("xi3",),
    "se2_log": ("se2",), "se2_compose": ("se2", "se2b"),
    "se2_inverse": ("se2",), "se2_apply": ("se2", "pts2"),
    "sim3_compose": ("sim3", "sim3b"), "sim3_inverse": ("sim3",),
    "sim3_exp": ("xi7",), "sim3_log": ("sim3",),
    "rxso3_compose": ("rx", "rxb"), "rxso3_inverse": ("rx",),
    "rxso3_exp": ("xi4",), "rxso3_log": ("rx",), "rxso3_matrix": ("rx",),
    "rxso3_apply": ("rx", "rxpts"), "se3_apply": ("pose", "v3"),
    "sim3_apply": ("sim3", "v3"),
}


@pytest.fixture(scope="module")
def lie_cases():
    """The inputs as float32, and every reference output from one jitted
    program (one compile instead of one eager dispatch per op)."""
    inputs = {k: np.asarray(v, np.float32) for k, v in _lie_inputs().items()}

    def every(a):
        return {name: getattr(jlg, name)(*[a[x] for x in argn])
                for name, argn in _LIE.items()}

    ref = jax.jit(every)({k: jnp.asarray(v) for k, v in inputs.items()})
    return inputs, {k: _np(v) for k, v in ref.items()}


@pytest.mark.parametrize("name", sorted(_LIE))
def test_liegroup_matches_reference(lie_cases, name):
    """Every liegroup function on a batch of 16 (Taylor branches
    included): within 2e-5 absolute (+ 2e-5 relative) of the reference."""
    inputs, ref = lie_cases
    got = _np(getattr(tlg, name)(*[T(inputs[a]) for a in _LIE[name]]))
    assert got.shape == ref[name].shape
    np.testing.assert_allclose(got, ref[name], atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("name,n", [("quat_identity", 4),
                                    ("se3_identity", 7),
                                    ("sim3_identity", 8),
                                    ("rxso3_identity", 5)])
def test_liegroup_identities(name, n):
    """Identities equal the reference's exactly, for a batch shape too."""
    for shape in ((), (2, 3)):
        got = _np(getattr(tlg, name)(shape, device="cpu"))
        assert got.shape == shape + (n,)
        np.testing.assert_array_equal(got, _np(getattr(jlg, name)(shape)))


@pytest.mark.parametrize("branch,rotvec", [
    ("trace > 0", [0.3, -0.2, 0.1]),
    ("m00 largest", [np.pi * 0.97, 0.1, -0.05]),
    ("m11 largest", [0.05, np.pi * 0.97, 0.1]),
    ("m22 largest", [-0.1, 0.05, np.pi * 0.97]),
])
def test_matrix_to_quat_branches(branch, rotvec):
    """matrix_to_quat through each of Shepperd's four branches: within
    1e-6 of the reference and of scipy's quaternion (w ≥ 0)."""
    r = Rotation.from_rotvec(rotvec).as_matrix().astype(np.float32)
    m00, m11, m22 = np.diag(r)
    tr = m00 + m11 + m22
    taken = ("trace > 0" if tr > 0 else "m00 largest"
             if m00 >= m11 and m00 >= m22 else "m11 largest"
             if m11 >= m22 else "m22 largest")
    assert taken == branch
    ref = _np(jlg.matrix_to_quat(jnp.asarray(r)))
    got = _np(tlg.matrix_to_quat(T(r)))
    np.testing.assert_allclose(got, ref, atol=1e-6)
    q = Rotation.from_matrix(r).as_quat()[[3, 0, 1, 2]]
    np.testing.assert_allclose(got, q * np.sign(q[0]), atol=1e-6)


# ---------------------------------------------------------------------------
# PnP solvers
# ---------------------------------------------------------------------------


def _solver_case(name):
    s = 4 if name in ("pnp_p3p", "pnp_ap3p") else 6
    world, px = _minimal_sets(9, b=128, s=s)
    ref = jax.jit(getattr(jpnp, name))(jnp.asarray(world), jnp.asarray(px),
                                       jnp.asarray(K))
    got = getattr(tpnp, name)(T(world), T(px), T(K))
    return (_rot_angle(_np(got.rotation), _np(ref.rotation)),
            _rot_angle(_np(got.rotation), R_GT),
            _rot_angle(_np(ref.rotation), R_GT))


@pytest.mark.parametrize("name,agree,solved", [
    # EPnP on 6 clean points (on these 128 sets 0.984 agree and solve,
    # the reference solves 0.984)
    ("pnp_epnp", 0.9, 0.9),
    # AP3P: well conditioned (0.984; the reference solves 1.0)
    ("pnp_ap3p", 0.95, 0.95),
    # Grunert P3P aligns the three points with a rank-2 Kabsch fit whose
    # third singular value sits near svd3's 1e-3·σ₀ cut, so float32
    # rounding decides the reflection of some roots, in the reference as
    # well (here it solves 0.719 of them, the port 0.750; they agree on
    # 0.664)
    ("pnp_p3p", 0.6, 0.6),
    # DLT on 6 points (12 unknowns) is ill conditioned in float32 in both
    # (the reference solves 0.688, the port 0.648)
    ("pnp_dlt", 0.6, 0.6),
])
def test_pnp_solvers_match_reference(name, agree, solved):
    """A batch of 128 clean minimal sets under the known pose: the share
    of sets whose rotation is within 1e-3 rad of the reference's is ≥
    ``agree``, the share within 1e-3 rad of the truth is ≥ ``solved`` and
    not below the reference's share less 0.06."""
    d_ref, d_gt, d_ref_gt = _solver_case(name)
    assert np.mean(d_ref <= 1e-3) >= agree
    assert np.mean(d_gt <= 1e-3) >= solved
    assert np.mean(d_gt <= 1e-3) >= np.mean(d_ref_gt <= 1e-3) - 0.06


def test_pnp_dlt_overdetermined_matches_reference():
    """DLT on 40 clean points: R within 1e-4 rad of the reference's and of
    the truth, t within 1e-3."""
    rng = np.random.default_rng(10)
    world = rng.uniform([-2, -2, 4], [2, 2, 8], (4, 40, 3)).astype(
        np.float32)
    px = _project(world).astype(np.float32)
    ref = jax.jit(jpnp.pnp_dlt)(jnp.asarray(world), jnp.asarray(px),
                                jnp.asarray(K))
    got = tpnp.pnp_dlt(T(world), T(px), T(K))
    assert _rot_angle(_np(got.rotation), _np(ref.rotation)).max() <= 1e-4
    assert _rot_angle(_np(got.rotation), R_GT).max() <= 1e-4
    np.testing.assert_allclose(_np(got.translation), np.broadcast_to(
        T_GT, (4, 3)), atol=1e-3)


def test_reprojection_residuals_match_reference():
    """(B, N) squared reprojection errors of 8 poses, within 1e-4
    relative; a point behind the camera scores 1e12 in both."""
    world, px, _ = _scene(11, n=40, pad=0)
    world[0] = [0.0, 0.0, -30.0]
    rots = np.tile(R_GT, (8, 1, 1))
    ts = np.tile(T_GT, (8, 1)) + np.random.default_rng(11).normal(
        0, 0.05, (8, 3))
    pose_r = jpnp.PnPResult(jnp.asarray(rots, jnp.float32),
                            jnp.asarray(ts, jnp.float32))
    pose_t = tpnp.PnPResult(T(rots.astype(np.float32)),
                            T(ts.astype(np.float32)))
    ref = _np(jpnp.reprojection_residuals(pose_r, jnp.asarray(world),
                                          jnp.asarray(px), jnp.asarray(K)))
    got = _np(tpnp.reprojection_residuals(pose_t, T(world), T(px), T(K)))
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)
    assert (got[:, 0] == 1e12).all() and (ref[:, 0] == 1e12).all()


# ---------------------------------------------------------------------------
# RANSAC with a PnP model, refine
# ---------------------------------------------------------------------------


def _ref_draw(key, mask, sample_size, n_hyp=256):
    """The reference's own draw inside ransac: split(key)[0]."""
    return jransac.sample_minimal_sets(
        jax.random.split(key)[0], len(mask), jnp.asarray(mask), n_hyp,
        sample_size)


def test_ransac_pnp_model_magsac_matches_reference():
    """The generic ransac with a PnPResult model (a NamedTuple mapped
    field by field), EPnP minimal and weighted solvers, MAGSAC scoring, 64
    hypotheses, 2 LO refits, the reference's draw: the model's R within
    1e-4 rad and t within 1e-3 of the reference's, n_inliers within ±2."""
    world, px, mask = _scene(12)
    key = jax.random.PRNGKey(12)
    kj = jnp.asarray(K)

    def ref_fn(w, p, m):
        return jransac.ransac(
            key, w, p,
            solver_fn=lambda a, b, weights=None: jpnp.pnp_epnp(a, b, kj,
                                                               weights),
            residual_fn=lambda md, _a, _b: jpnp.reprojection_residuals(
                md, w, p, kj),
            sample_size=6, threshold=3.0, mask=m, n_hypotheses=64,
            lo_iters=2, scoring="magsac")

    ref = jax.jit(ref_fn)(jnp.asarray(world), jnp.asarray(px),
                          jnp.asarray(mask))
    tw, tp, tk = T(world), T(px), T(K)
    got = transac.ransac(
        None, tw, tp,
        solver_fn=lambda a, b, weights=None: tpnp.pnp_epnp(a, b, tk,
                                                           weights),
        residual_fn=lambda md, _a, _b: tpnp.reprojection_residuals(
            md, tw, tp, tk),
        sample_size=6, threshold=3.0, mask=T(mask), n_hypotheses=64,
        lo_iters=2, scoring="magsac",
        sample_idx=T(np.asarray(_ref_draw(key, mask, 6, 64))))
    assert isinstance(got.model, tpnp.PnPResult)
    assert _rot_angle(_np(got.model.rotation),
                      _np(ref.model.rotation)) <= 1e-4
    np.testing.assert_allclose(_np(got.model.translation),
                               _np(ref.model.translation), atol=1e-3)
    assert abs(int(got.n_inliers) - int(ref.n_inliers)) <= 2


def test_refine_pose_reprojection_matches_reference():
    """From the known pose perturbed by 2° and 5 cm, over the true
    inliers: 10 LM steps give R within 1e-5 rad and t within 1e-4 of the
    reference's, and the known pose within 2e-3 rad."""
    world, px, mask = _scene(14)
    inl = mask & (np.arange(len(mask)) >= 40)
    r0 = (Rotation.from_rotvec([0.02, -0.02, 0.01]).as_matrix()
          @ R_GT).astype(np.float32)
    t0 = (T_GT + [0.05, -0.03, 0.04]).astype(np.float32)
    ref = jax.jit(lambda *a: jrefine.refine_pose_reprojection(
        *a, iters=10, threshold_px=3.0))(
        jnp.asarray(r0), jnp.asarray(t0), jnp.asarray(world),
        jnp.asarray(px), jnp.asarray(K), jnp.asarray(inl))
    got = trefine.refine_pose_reprojection(r0, t0, world, px, K, inl,
                                           iters=10, threshold_px=3.0,
                                           device="cpu")
    assert _rot_angle(_np(got[0]), _np(ref[0])) <= 1e-5
    np.testing.assert_allclose(_np(got[1]), _np(ref[1]), atol=1e-4)
    assert _rot_angle(_np(got[0]), R_GT) <= 2e-3
