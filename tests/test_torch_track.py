"""The port's per-frame tracking step (kornia_tpu_torch/slam/system.py
``track_step``: packed Hamming match → matched map points → PnP RANSAC →
reprojection LM) and its packed matcher, against the JAX package's
``_track_step_jit`` and ``match_descriptors_packed``. The scene is made
with numpy: two textured planes, a map lifted exactly from two views, a
third view at a known pose. RANSAC draws come from ``jax.random`` in the
reference; the port is handed the reference's own draw."""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from kornia_tpu.features import matching as jmatch
from kornia_tpu.geometry import ransac as jransac
from kornia_tpu.slam import system as jsys

from kornia_tpu_torch import convert
from kornia_tpu_torch.features import matching as tmatch
from kornia_tpu_torch.features import orb as torb
from kornia_tpu_torch.slam import system as tsys

# One intra-op thread: these tests run many small ops, and torch's pool
# of a thread per core spins against the other test processes.
torch.set_num_threads(1)

T = functools.partial(convert.tensor, device="cpu")
H, W = 240, 320
K = np.array([[229.3, 0.0, 160.2], [0.0, 228.6, 120.4], [0.0, 0.0, 1.0]])
PLANES = [np.array([1.0, 0.0, 1.0]), np.array([-1.0, 0.0, 1.0])]  # n·X = 5


def _rot_xyz(deg):
    ang = np.deg2rad(deg)
    cx, cy, cz = np.cos(ang)
    sx, sy, sz = np.sin(ang)
    rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    return rz @ ry @ rx


VIEWS = [(np.eye(3), np.zeros(3)),
         (_rot_xyz([1.0, -2.0, 0.5]), np.array([0.8, 0.1, 0.05])),
         (_rot_xyz([-1.5, 1.5, -0.5]), np.array([-0.2, 0.1, 0.1]))]


def _texture(rng, n=160, up=8):
    small = rng.random((n + 1, n + 1)) * 255.0
    f = (np.arange(n * up) + 0.5) / up - 0.5
    i0 = np.clip(np.floor(f).astype(int), 0, n - 1)
    a = np.clip(f - i0, 0.0, 1.0)
    rows = small[i0] * (1 - a)[:, None] + small[i0 + 1] * a[:, None]
    return rows[:, i0] * (1 - a)[None] + rows[:, i0 + 1] * a[None]


def _cast(px, rot, origin):
    """World points where the rays of pixels (..., 2) of the camera
    x = rot·(X − origin) first meet the planes, and the plane index."""
    ray = np.concatenate([px, np.ones_like(px[..., :1])], -1) @ \
        np.linalg.inv(K).T
    d = ray @ rot                                    # rows: rotᵀ·ray
    s_all = np.stack([(5.0 - origin @ n) / (d @ n) for n in PLANES])
    s_all = np.where(s_all > 0, s_all, np.inf)
    which = np.argmin(s_all, 0)
    s = np.min(s_all, 0)
    return origin + s[..., None] * d, which


def _render(rot, origin, texs):
    vv, uu = np.mgrid[0:H, 0:W].astype(np.float64)
    p, which = _cast(np.stack([uu, vv], -1), rot, origin)
    img = np.zeros((H, W))
    for i, tex in enumerate(texs):
        u = np.clip((p[..., 0] + 6.0) * 100.0, 0, tex.shape[0] - 1.001)
        v = np.clip((p[..., 1] + 6.0) * 100.0, 0, tex.shape[0] - 1.001)
        u0, v0 = np.floor(u).astype(int), np.floor(v).astype(int)
        du, dv = u - u0, v - v0
        val = (tex[v0, u0] * (1 - du) * (1 - dv)
               + tex[v0, u0 + 1] * du * (1 - dv)
               + tex[v0 + 1, u0] * (1 - du) * dv
               + tex[v0 + 1, u0 + 1] * du * dv)
        img = np.where(which == i, val, img)
    return np.clip(np.round(img), 0, 255).astype(np.uint8)


@pytest.fixture(scope="module")
def track_inputs():
    """The step's inputs as numpy, padded as the SLAM loop pads them: the
    map (views 1 and 2, 256 ORB features each, each keypoint lifted to
    its exact 3-D point, descriptors packed) in a bucket of 512 rows, the
    third view's features in a bucket of 256."""
    rng = np.random.default_rng(0)
    texs = [_texture(rng), _texture(rng)]
    cfg = torb.OrbConfig(n_features=256, n_levels=4)
    feats = []
    for rot, origin in VIEWS:
        f = torb.orb_detect_and_describe(_render(rot, origin, texs), cfg,
                                         device="cpu")
        m = f.mask.numpy()
        feats.append((f.xy.numpy()[m].astype(np.float64),
                      tsys._pack(f.descriptors[f.mask]).numpy()))
    xyz = np.concatenate([_cast(xy, rot, origin)[0]
                          for (xy, _), (rot, origin) in zip(feats[:2],
                                                            VIEWS[:2])])
    desc = np.concatenate([d for _, d in feats[:2]])
    nm = tsys._bucket(len(desc), 256)
    fxy, fdesc = feats[2]
    nf = tsys._bucket(len(fdesc), 256)

    def pad(a, n):
        return tsys._pad_rows(torch.as_tensor(a), n).numpy()

    return dict(
        frame_desc=pad(fdesc, nf), frame_mask=np.arange(nf) < len(fdesc),
        frame_xy=pad(fxy.astype(np.float32), nf),
        map_desc=pad(desc, nm), map_mask=np.arange(nm) < len(desc),
        map_xyz=pad(xyz.astype(np.float32), nm), k=K.astype(np.float32))


def _angle(r_a, r_b):
    d = np.linalg.norm(np.asarray(r_a, np.float64)
                       - np.asarray(r_b, np.float64))
    return float(2 * np.arcsin(min(d / (2 * np.sqrt(2)), 1.0)))


def _packed(seed, n, m):
    """n query and m train packed descriptors; the first n // 2 queries are
    train rows with a few bits flipped, so matches exist."""
    rng = np.random.default_rng(seed)
    b = rng.integers(0, 256, (m, 32)).astype(np.uint8)
    a = rng.integers(0, 256, (n, 32)).astype(np.uint8)
    pick = rng.choice(m, n // 2, replace=False)
    a[: n // 2] = b[pick] ^ (rng.random((n // 2, 32)) < 0.02).astype(
        np.uint8) << rng.integers(0, 8, (n // 2, 32)).astype(np.uint8)
    return a, b


def test_unpack_descriptor_bits_bit_equal():
    a, _ = _packed(1, 64, 64)
    got = tmatch.unpack_descriptor_bits(T(a)).numpy()
    ref = np.asarray(jmatch.unpack_descriptor_bits(jnp.asarray(a)))
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, np.unpackbits(a, axis=1))


@pytest.mark.parametrize("ratio,cross_check", [(0.8, True), (0.75, True),
                                               (None, False)])
def test_match_descriptors_packed_bit_equal(ratio, cross_check):
    """idx, mask and dist equal to the reference's bit for bit, padded
    rows masked out on both sides."""
    a, b = _packed(2, 300, 500)
    am = np.arange(300) < 280
    bm = np.arange(500) < 470
    ref = jax.jit(functools.partial(
        jmatch.match_descriptors_packed, max_distance=64.0, ratio=ratio,
        cross_check=cross_check))(jnp.asarray(a), jnp.asarray(b),
                                  jnp.asarray(am), jnp.asarray(bm))
    got = tmatch.match_descriptors_packed(a, b, am, bm, max_distance=64.0,
                                          ratio=ratio,
                                          cross_check=cross_check,
                                          device="cpu")
    np.testing.assert_array_equal(got.idx.numpy(), np.asarray(ref.idx))
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(ref.mask))
    np.testing.assert_array_equal(got.dist.numpy(), np.asarray(ref.dist))
    assert int(got.mask.sum()) >= 100


@pytest.mark.parametrize("width", [256, 24])
def test_pack_bit_equal_to_packbits(width):
    """_pack on a tensor equals np.packbits(bits, axis=1), for non-zero
    values other than 1 too."""
    bits = np.random.default_rng(3).integers(0, 3, (40, width)).astype(
        np.uint8)
    got = tsys._pack(T(bits)).numpy()
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, np.packbits(bits, axis=1))


def test_bucket_and_pad_rows_as_reference():
    for n in (0, 1, 255, 256, 257, 1000, 2049):
        assert tsys._bucket(n, 256) == jsys._bucket(n, 256)
    x = np.arange(15, dtype=np.float32).reshape(5, 3)
    for n in (3, 5, 8):
        np.testing.assert_array_equal(
            tsys._pad_rows(T(x), n, fill=-1.0).numpy(),
            jsys._pad_rows(x, n, fill=-1.0))


def test_slam_config_carried_over():
    """convert.slam_config takes the reference's SlamConfig as it is."""
    ref = jsys.SlamConfig(n_features=500, match_ratio=0.7)
    got = convert.slam_config(dataclasses.asdict(ref))
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)
    assert dataclasses.asdict(tsys.SlamConfig()) == dataclasses.asdict(
        jsys.SlamConfig())


def test_track_step_matches_reference(track_inputs):
    """track_step against _track_step_jit on the same padded inputs and
    the reference's draw (256 × 6 from split(key)[0] over its match mask):
    match idx and mask equal, R within 1e-4 rad and t within 1e-3 of the
    reference's, n_inliers within ±2, the inlier masks within 2 rows."""
    x = track_inputs
    key = jax.random.PRNGKey(7)
    cfg = jsys.SlamConfig()
    ref = jsys._track_step_jit(
        key, *(jnp.asarray(x[k]) for k in ("frame_desc", "frame_mask",
                                           "frame_xy", "map_desc",
                                           "map_mask", "map_xyz", "k")),
        cfg.match_max_distance, cfg.match_ratio, cfg.pnp_threshold_px)
    r_pose, r_inl, r_n, r_idx, r_mask = ref
    draw = jransac.sample_minimal_sets(jax.random.split(key)[0],
                                       len(x["frame_mask"]), r_mask, 256, 6)
    got = tsys.track_step(**x, sample_idx=T(np.asarray(draw)), device="cpu")
    np.testing.assert_array_equal(got.match_idx.numpy(), np.asarray(r_idx))
    np.testing.assert_array_equal(got.match_mask.numpy(),
                                  np.asarray(r_mask))
    assert _angle(got.pose.rotation.numpy(),
                  np.asarray(r_pose.rotation)) <= 1e-4
    np.testing.assert_allclose(got.pose.translation.numpy(),
                               np.asarray(r_pose.translation), atol=1e-3)
    assert abs(int(got.n_inliers) - int(r_n)) <= 2
    assert (got.inliers.numpy() != np.asarray(r_inl)).sum() <= 2
    assert int(got.match_mask.sum()) >= 60


def test_track_step_own_generator_recovers_pose(track_inputs):
    """The port alone, its own torch.Generator draw: the third view's
    known pose within 0.1° and its centre within 0.02 (the planes are at
    depth ≈ 5), with n_inliers ≥ half the matches."""
    gen = torch.Generator().manual_seed(0)
    got = tsys.track_step(**track_inputs, generator=gen, device="cpu")
    rot, origin = VIEWS[2]
    r = got.pose.rotation.double().numpy()
    t = got.pose.translation.double().numpy()
    assert np.degrees(_angle(r, rot)) <= 0.1
    assert np.linalg.norm(-r.T @ t - origin) <= 0.02
    assert int(got.n_inliers) >= 0.5 * int(got.match_mask.sum())
    assert not got.inliers.numpy()[~got.match_mask.numpy()].any()
