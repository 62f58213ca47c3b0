"""The ported slice as a whole: frame pair → ORB → Hamming match →
two-view relative pose, port (on the CPU, plain kernel versions) against
the JAX package, at a small size: 240×320 frames, OrbConfig(n_features=512,
n_levels=4), TwoViewParams(n_hypotheses=64, refine_iters=4)."""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from kornia_tpu.features import matching as jmatch
from kornia_tpu.features import orb as jorb
from kornia_tpu.geometry import ransac as jransac
from kornia_tpu.geometry import twoview as jtv

from kornia_tpu_torch import convert
from kornia_tpu_torch.features import matching as tmatch
from kornia_tpu_torch.features import orb as torb
from kornia_tpu_torch.geometry import twoview as ttv

# One intra-op thread: these tests run many small ops, and torch's pool
# of a thread per core spins against the other test processes.
torch.set_num_threads(1)

tensor = functools.partial(convert.tensor, device="cpu")
tensors = functools.partial(convert.tensors, device="cpu")

CFG = jorb.OrbConfig(n_features=512, n_levels=4)
TCFG = convert.orb_config(dataclasses.asdict(CFG))
PARAMS = jtv.TwoViewParams(n_hypotheses=64, refine_iters=4)
TPARAMS = convert.twoview_params(dataclasses.asdict(PARAMS))
H, W = 240, 320
K = np.array([[229.3, 0.0, 160.2], [0.0, 228.6, 120.4], [0.0, 0.0, 1.0]])


def _angle(r_a, r_b):
    d = np.linalg.norm(np.asarray(r_a, np.float64) - np.asarray(r_b,
                                                                  np.float64))
    return float(2 * np.arcsin(min(d / (2 * np.sqrt(2)), 1.0)))


def _dir(t_a, t_b):
    a = np.asarray(t_a, np.float64) / np.linalg.norm(t_a)
    b = np.asarray(t_b, np.float64) / np.linalg.norm(t_b)
    return float(2 * np.arcsin(min(np.linalg.norm(a - b) / 2, 1.0)))


def _texture(rng, n=160, up=8):
    small = rng.random((n + 1, n + 1)) * 255.0
    f = (np.arange(n * up) + 0.5) / up - 0.5
    i0 = np.clip(np.floor(f).astype(int), 0, n - 1)
    a = np.clip(f - i0, 0.0, 1.0)
    rows = small[i0] * (1 - a)[:, None] + small[i0 + 1] * a[:, None]
    return rows[:, i0] * (1 - a)[None] + rows[:, i0 + 1] * a[None]


def render_scene(seed=0):
    """Two views of two textured, non-coplanar planes z = 5 ∓ X with a
    known relative pose (camera 2 = R·X + t). Returns (img1, img2, R, t)."""
    rng = np.random.default_rng(seed)
    texs = [_texture(rng), _texture(rng)]
    planes = [np.array([1.0, 0.0, 1.0]), np.array([-1.0, 0.0, 1.0])]
    a = np.deg2rad([1.0, -2.0, 0.5])
    rx = np.array([[1, 0, 0], [0, np.cos(a[0]), -np.sin(a[0])],
                   [0, np.sin(a[0]), np.cos(a[0])]])
    ry = np.array([[np.cos(a[1]), 0, np.sin(a[1])], [0, 1, 0],
                   [-np.sin(a[1]), 0, np.cos(a[1])]])
    rz = np.array([[np.cos(a[2]), -np.sin(a[2]), 0],
                   [np.sin(a[2]), np.cos(a[2]), 0], [0, 0, 1]])
    r = rz @ ry @ rx
    c2 = np.array([0.8, 0.1, 0.05])
    vv, uu = np.mgrid[0:H, 0:W].astype(np.float64)
    pix = np.stack([uu, vv, np.ones_like(uu)], -1) @ np.linalg.inv(K).T

    def view(rot, origin):
        d = pix @ rot
        best = np.full((H, W), np.inf)
        img = np.zeros((H, W))
        for n, tex in zip(planes, texs):
            s = (5.0 - origin @ n) / (d @ n)
            s = np.where(s > 0, s, np.inf)
            p = origin + s[..., None] * d
            u = np.clip((p[..., 0] + 6.0) * 100.0, 0, tex.shape[0] - 1.001)
            v = np.clip((p[..., 1] + 6.0) * 100.0, 0, tex.shape[0] - 1.001)
            u0, v0 = np.floor(u).astype(int), np.floor(v).astype(int)
            du, dv = u - u0, v - v0
            val = (tex[v0, u0] * (1 - du) * (1 - dv)
                   + tex[v0, u0 + 1] * du * (1 - dv)
                   + tex[v0 + 1, u0] * (1 - du) * dv
                   + tex[v0 + 1, u0 + 1] * du * dv)
            img = np.where(s < best, val, img)
            best = np.minimum(best, s)
        return np.clip(np.round(img), 0, 255).astype(np.uint8)

    t = -r @ c2
    return (view(np.eye(3), np.zeros(3)), view(r, c2), r,
            t / np.linalg.norm(t))


def _ref_front(a, b):
    def forward(ga, gb):
        fa = jorb.orb_detect_and_describe(ga, CFG)
        fb = jorb.orb_detect_and_describe(gb, CFG)
        m = jmatch.match_descriptors(fa.descriptors, fb.descriptors,
                                     a_mask=fa.mask, b_mask=fb.mask,
                                     max_distance=64, ratio=0.8)
        return fa, fb, m
    return jax.jit(forward)(jnp.asarray(a), jnp.asarray(b))


def _port_front(a, b):
    fa = torb.orb_detect_and_describe(a, TCFG, device="cpu")
    fb = torb.orb_detect_and_describe(b, TCFG, device="cpu")
    m = tmatch.match_descriptors(fa.descriptors, fb.descriptors,
                                 a_mask=fa.mask, b_mask=fb.mask,
                                 max_distance=64, ratio=0.8, device="cpu")
    return fa, fb, m


def _ref_samples(key, mask):
    kf, kh = jax.random.split(key)
    m = jnp.asarray(mask)
    n = len(mask)
    idx_f = jransac.sample_minimal_sets(jax.random.split(kf)[0], n, m,
                                        PARAMS.n_hypotheses, 8)
    idx_h = jransac.sample_minimal_sets(jax.random.split(kh)[0], n, m,
                                        PARAMS.n_hypotheses, 4)
    return tensor(np.asarray(idx_f)), tensor(
        np.asarray(idx_h))


@pytest.fixture(scope="module")
def scene():
    img1, img2, r, t = render_scene()
    ref = _ref_front(img1, img2)
    got = _port_front(img1, img2)
    return img1, img2, r, t, ref, got


def test_entry_pair_front_end():
    """__graft_entry__.entry()'s seed-0 noise pair: the port's (xy_a, xy_b,
    idx, mask). On noise frames the pyramid differs from the reference in
    a handful of ±1-LSB pixels only; measured: 0 and 6 of 512 keypoint
    slots differ (frame a, frame b), the (empty) match sets agree.
    Bounds: ≤ 2% of keypoint slots, ≤ 1% of match entries."""
    rng = np.random.default_rng(0)
    a = rng.integers(0, 256, (H, W), np.uint8)
    b = rng.integers(0, 256, (H, W), np.uint8)
    fa, fb, m = _ref_front(a, b)
    ga, gb, gm = _port_front(a, b)
    for ref_f, got_f in ((fa, ga), (fb, gb)):
        same = ((got_f.xy.numpy() == np.asarray(ref_f.xy)).all(1)
                & (got_f.mask.numpy() == np.asarray(ref_f.mask)))
        assert (~same).mean() <= 0.02
    assert (gm.idx.numpy() != np.asarray(m.idx)).mean() <= 0.01
    assert (gm.mask.numpy() != np.asarray(m.mask)).mean() <= 0.01


def test_slice_front_end_on_scene(scene):
    """On the textured scene: keypoint slots differ in ≤ 5% (the pyramid's
    ±1-LSB pixels shift Harris quantisation ranges, see
    test_torch_features), and the match sets agree on ≥ 90% of queries."""
    img1, img2, r, t, (fa, fb, m), (ga, gb, gm) = scene
    for ref_f, got_f in ((fa, ga), (fb, gb)):
        same = ((got_f.xy.numpy() == np.asarray(ref_f.xy)).all(1)
                & (got_f.mask.numpy() == np.asarray(ref_f.mask)))
        assert (~same).mean() <= 0.05
    assert (gm.idx.numpy() == np.asarray(m.idx)).mean() >= 0.9
    assert int(gm.mask.sum()) >= 100


def test_slice_pose_given_reference_matches(scene):
    """Two-view fed the reference's matched points and the reference's
    draws through convert: the same model choice, R within 1e-4 rad, t
    direction within 1e-3 rad, n_inliers within ±2."""
    img1, img2, r, t, (fa, fb, m), _ = scene
    x1, x2, mk = jmatch.matched_points(fa.xy, fb.xy, m)
    key = jax.random.PRNGKey(0)
    ref = jtv.estimate_relative_pose(key, x1, x2, jnp.asarray(K, jnp.float32),
                                     jnp.asarray(K, jnp.float32), mask=mk,
                                     params=PARAMS)
    st = tensors({"x1": np.asarray(x1), "x2": np.asarray(x2),
                          "mask": np.asarray(mk)})
    got = ttv.estimate_relative_pose(
        st["x1"], st["x2"], K, K, mask=st["mask"], params=TPARAMS,
        samples=_ref_samples(key, np.asarray(mk)), device="cpu")
    assert bool(got.use_homography) == bool(ref.use_homography)
    assert _angle(got.rotation.numpy(), np.asarray(ref.rotation)) < 1e-4
    assert _dir(got.translation.numpy(), np.asarray(ref.translation)) < 1e-3
    assert abs(int(got.n_inliers) - int(ref.n_inliers)) <= 2


def test_slice_end_to_end_recovers_pose(scene):
    """The port end to end (its own matches, the reference's key for the
    draws): recovers the known pose within 0.5° / 5° with ≥ 50 inliers,
    and lands within 0.1° of the reference's own end-to-end estimate."""
    img1, img2, r, t, (fa, fb, m), (ga, gb, gm) = scene
    x1, x2, mk = tmatch.matched_points(ga.xy, gb.xy, gm)
    key = jax.random.PRNGKey(0)
    got = ttv.estimate_relative_pose(
        x1, x2, K, K, mask=mk, params=TPARAMS,
        samples=_ref_samples(key, mk.numpy()), device="cpu")
    rx1, rx2, rmk = jmatch.matched_points(fa.xy, fb.xy, m)
    ref = jtv.estimate_relative_pose(key, rx1, rx2,
                                     jnp.asarray(K, jnp.float32),
                                     jnp.asarray(K, jnp.float32), mask=rmk,
                                     params=PARAMS)
    assert np.degrees(_angle(got.rotation.numpy(), r)) <= 0.5
    assert np.degrees(_dir(got.translation.numpy(), t)) <= 5.0
    assert int(got.n_inliers) >= 50
    assert np.degrees(_angle(got.rotation.numpy(),
                             np.asarray(ref.rotation))) <= 0.1
    assert torch.isfinite(got.points3d).all()
