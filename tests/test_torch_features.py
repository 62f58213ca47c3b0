"""The port's ORB front end (kornia_tpu_torch/features, ops/resize,
ops/filters) against the JAX package, stage by stage: every stage is fed
the reference's previous stage through kornia_tpu_torch.convert, so one
LSB upstream cannot cascade. Inputs are seed-made with numpy."""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from kornia_tpu.features import fast as jfast
from kornia_tpu.features import matching as jmatch
from kornia_tpu.features import orb as jorb
from kornia_tpu.features import responses as jresp
from kornia_tpu.ops import filters as jfilt
from kornia_tpu.ops import resize as jres

from kornia_tpu_torch import convert
from kornia_tpu_torch.features import fast as tfast
from kornia_tpu_torch.features import matching as tmatch
from kornia_tpu_torch.features import orb as torb
from kornia_tpu_torch.features import responses as tresp
from kornia_tpu_torch.ops import cuda_kernels as ck
from kornia_tpu_torch.ops import filters as tfilt
from kornia_tpu_torch.ops import resize as tres

# One intra-op thread: these tests run many small ops, and torch's pool
# of a thread per core spins against the other test processes.
torch.set_num_threads(1)

tensor = functools.partial(convert.tensor, device="cpu")

CFG = jorb.OrbConfig(n_features=512, n_levels=4)
TCFG = convert.orb_config(dataclasses.asdict(CFG))


def _entry_frames():
    """The seed-0 240×320 pair of __graft_entry__.entry()."""
    rng = np.random.default_rng(0)
    a = rng.integers(0, 256, (240, 320), np.uint8)
    b = rng.integers(0, 256, (240, 320), np.uint8)
    return a, b


def _smooth_frame(seed, shape=(240, 320)):
    """Seeded noise upsampled ×8: corners with a spread of scores."""
    rng = np.random.default_rng(seed)
    small = rng.random((shape[0] // 8 + 2, shape[1] // 8 + 2))
    big = np.kron(small, np.ones((8, 8)))[:shape[0], :shape[1]]
    blur = np.asarray(jfilt.gaussian_blur(
        jnp.asarray(big.astype(np.float32))[..., None], (5, 5), 1.5))[..., 0]
    return np.clip(blur * 255, 0, 255).astype(np.uint8)


def _ref_pyramid(gray):
    levels = [jnp.asarray(gray)]
    h, w = gray.shape
    for i in range(1, CFG.n_levels):
        s = CFG.scale_factor ** i
        levels.append(jres.resize(levels[-1], (int(round(h / s)),
                                               int(round(w / s)))))
    return [np.asarray(lv) for lv in levels]


@pytest.fixture(scope="module")
def ref_levels():
    return _ref_pyramid(_entry_frames()[0])


# --------------------------------------------------------------------------
# ops
# --------------------------------------------------------------------------


@pytest.mark.parametrize("n_in,n_out", [(320, 267), (240, 200), (752, 627),
                                        (480, 400)])
def test_resize_matrix_equal(n_in, n_out):
    np.testing.assert_array_equal(tres._resize_matrix(n_in, n_out),
                                  jres._resize_matrix(n_in, n_out,
                                                      "bilinear", False))


def test_pyramid_levels(ref_levels):
    """Each level resized from the reference's previous level. u8 rounds
    after an fp32 band matmul (resize.py:177-180); a different summation
    order can tip an exact .5, so a few ±1-LSB pixels are allowed: at most
    8 per level (measured 0-3 on this frame), never more than 1 LSB."""
    for prev, ref in zip(ref_levels[:-1], ref_levels[1:]):
        got = tres.resize(tensor(prev), ref.shape).numpy()
        diff = np.abs(got.astype(int) - ref.astype(int))
        assert diff.max() <= 1
        assert (diff > 0).sum() <= 8


@pytest.mark.parametrize("ksize,sigma", [((7, 7), 2.0), ((5, 5), 1.0),
                                         ((3, 3), 0.0)])
def test_gaussian_blur_exact(ref_levels, ksize, sigma):
    """Same shift-add order, each product rounded before its add: exact."""
    g = ref_levels[1].astype(np.float32)
    ref = np.asarray(jfilt.gaussian_blur(jnp.asarray(g)[..., None], ksize,
                                         sigma))[..., 0]
    got = tfilt.gaussian_blur(tensor(g), ksize, sigma).numpy()
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(tfilt.gaussian_kernel1d(ksize[0], sigma),
                                  jfilt.gaussian_kernel1d(ksize[0], sigma))


def test_harris_response_exact(ref_levels):
    g = ref_levels[2].astype(np.float32)
    ref = np.asarray(jresp.harris_response(jnp.asarray(g), grad="central"))
    got = tresp.harris_response(tensor(g), grad="central").numpy()
    np.testing.assert_array_equal(got, ref)


# --------------------------------------------------------------------------
# FAST
# --------------------------------------------------------------------------


@pytest.mark.parametrize("thr", [7.0, 20.0])
def test_fast_score_and_nms_exact(ref_levels, thr):
    img = ref_levels[0]
    ref = np.asarray(jfast.fast_score(jnp.asarray(img), thr))
    got = tfast.fast_score(tensor(img), thr)
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(
        tfast.nms_maxpool(got).numpy(),
        np.asarray(jfast.nms_maxpool(jnp.asarray(ref))))


@pytest.mark.parametrize("seed", [1, 2])
def test_two_tier_gate_exact(seed):
    img = _smooth_frame(seed, (100, 130))     # not multiples of the cell
    s_lo = np.asarray(jfast.nms_maxpool(jfast.fast_score(
        jnp.asarray(img), 7.0)))
    ref = np.asarray(jfast._two_tier_gate(jnp.asarray(s_lo), 20.0, 35))
    got = tfast._two_tier_gate(tensor(s_lo), 20.0, 35)
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("per_cell", [1, 3, 8])
def test_cell_topk_packed_exact(per_cell):
    """Same keypoints in the same cells-major order, ties (integer ranks)
    to the lowest row-major position."""
    rng = np.random.default_rng(per_cell)
    rank = rng.integers(0, 6, (80, 110)).astype(np.float32)  # many ties
    rxy, rsc = jfast.cell_topk_packed(jnp.asarray(rank), 35, per_cell)
    txy, tsc = tfast.cell_topk_packed(tensor(rank), 35, per_cell)
    np.testing.assert_array_equal(txy.numpy(), np.asarray(rxy))
    np.testing.assert_array_equal(tsc.numpy(), np.asarray(rsc))
    gxy, gsc = tfast._cell_topk_general(tensor(rank), 35, per_cell)
    jxy, jsc = jfast._cell_topk_general(jnp.asarray(rank), 35, per_cell)
    np.testing.assert_array_equal(gxy.numpy(), np.asarray(jxy))
    np.testing.assert_array_equal(gsc.numpy(), np.asarray(jsc))


def test_stable_topk_pins_lower_index_on_ties():
    """lax.top_k puts the lower index first on ties; so must the port
    (torch.topk does not promise it). -inf fills the invalid slots."""
    x = np.array([3, 5, 5, 1, 5, -np.inf, 3, 5, -np.inf], np.float32)
    jv, ji = jax.lax.top_k(jnp.asarray(x), 7)
    tv, ti = tfast.stable_topk(tensor(x), 7)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert ti.tolist() == [1, 2, 4, 7, 0, 6, 3]
    rng = np.random.default_rng(3)
    big = rng.integers(0, 50, 4000).astype(np.float32)
    big[rng.random(4000) < 0.3] = -np.inf
    jv, ji = jax.lax.top_k(jnp.asarray(big), 900)
    tv, ti = tfast.stable_topk(tensor(big), 900)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


@pytest.mark.parametrize("seed", [3, 4])
def test_fast_harris_cells_exact(seed):
    img = _smooth_frame(seed)
    h_ref = jresp.harris_response(jnp.asarray(img).astype(jnp.float32),
                                  grad="central")
    ref = jfast.fast_harris_cells(jnp.asarray(img), h_ref, per_cell=3)
    got = tfast.fast_harris_cells(tensor(img),
                                  tensor(np.asarray(h_ref)),
                                  per_cell=3)
    for name in ("xy", "score", "mask"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(ref, name)))


def test_fast_detect_cells_exact():
    img = _smooth_frame(5)
    ref = jfast.fast_detect_cells(jnp.asarray(img), per_cell=4)
    got = tfast.fast_detect_cells(tensor(img), per_cell=4)
    for name in ("xy", "score", "mask"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(ref, name)))


# --------------------------------------------------------------------------
# ORB stages
# --------------------------------------------------------------------------


def test_level_budgets_equal():
    for cfg in (jorb.OrbConfig(), CFG, jorb.OrbConfig(n_features=800)):
        tcfg = convert.orb_config(dataclasses.asdict(cfg))
        assert torb._level_budgets(tcfg) == jorb._level_budgets(cfg)
    assert jorb._level_budgets(jorb.OrbConfig()) == [
        435, 362, 302, 251, 209, 175, 145, 121]


@pytest.mark.parametrize("frame,rescore", [("entry", True),
                                           ("smooth", True),
                                           ("smooth", False)])
def test_select_level_exact(frame, rescore):
    """Per-level selected xy, score and mask, fed the reference's level,
    with Harris ranking (the default) and with FAST scores alone."""
    gray = _entry_frames()[1] if frame == "entry" else _smooth_frame(6)
    cfg = dataclasses.replace(CFG, harris_rescore=rescore)
    tcfg = convert.orb_config(dataclasses.asdict(cfg))
    levels = _ref_pyramid(gray)
    budgets = jorb._level_budgets(cfg)
    for lv, b in zip(levels, budgets):
        rxy, rval, rvalid = jorb._select_level(jnp.asarray(lv), b, cfg)
        txy, tval, tvalid = torb._select_level(tensor(lv), b, tcfg)
        np.testing.assert_array_equal(txy.numpy(), np.asarray(rxy))
        np.testing.assert_array_equal(tvalid.numpy(), np.asarray(rvalid))
        np.testing.assert_array_equal(tval.numpy(), np.asarray(rval))


@pytest.mark.parametrize("frame,rescore", [("entry", True),
                                           ("smooth", True),
                                           ("smooth", False)])
def test_orb_select_plain_equals_reference(frame, rescore):
    """torb.orb_select's plain version, all levels at once on K1's maps (the
    route ORB takes on the card, here through the plain versions), level by
    level equal to the reference's _select_level."""
    from kornia_tpu_torch.ops import cuda_kernels as ck

    gray = _entry_frames()[1] if frame == "entry" else _smooth_frame(8)
    cfg = dataclasses.replace(CFG, harris_rescore=rescore)
    tcfg = convert.orb_config(dataclasses.asdict(cfg))
    levels = _ref_pyramid(gray)
    budgets = jorb._level_budgets(cfg)
    tl = [tensor(lv) for lv in levels]
    got = torb.orb_select(tl, tfast.fast_harris_levels(
        tl, tcfg.fast_threshold_low), budgets, tcfg.cell_size,
        tcfg.fast_threshold_high, tcfg.harris_rescore)
    assert len(got) == len(levels)
    for (txy, tval, tvalid), lv, b in zip(got, levels, budgets):
        rxy, rval, rvalid = jorb._select_level(jnp.asarray(lv), b, cfg)
        np.testing.assert_array_equal(txy.numpy(), np.asarray(rxy))
        np.testing.assert_array_equal(tvalid.numpy(), np.asarray(rvalid))
        np.testing.assert_array_equal(tval.numpy(), np.asarray(rval))


def _ref_describe_inputs(gray):
    levels = _ref_pyramid(gray)
    budgets = jorb._level_budgets(CFG)
    sels = [jorb._select_level(jnp.asarray(lv), b, CFG)
            for lv, b in zip(levels, budgets)]
    xy_ints = [np.asarray(jnp.round(s[0]).astype(jnp.int32)) for s in sels]
    grays = [lv.astype(np.float32) for lv in levels]
    blurs = [np.asarray(jfilt.gaussian_blur(jnp.asarray(g)[..., None],
                                            (7, 7), 2.0))[..., 0]
             for g in grays]
    return grays, blurs, xy_ints


@pytest.fixture(scope="module")
def describe_ref():
    grays, blurs, xy_ints = _ref_describe_inputs(_smooth_frame(7))
    win_g = np.asarray(jorb._extract_windows_packed_paired(
        [jnp.asarray(g) for g in grays], [jnp.asarray(x) for x in xy_ints]))
    win_b = np.asarray(jorb._extract_windows_packed_paired(
        [jnp.asarray(b) for b in blurs], [jnp.asarray(x) for x in xy_ints]))
    ang = np.asarray(jorb.orientation_from_windows_paired(
        jnp.asarray(win_g)))
    desc = np.asarray(jorb.brief_from_windows_paired(
        jnp.asarray(win_b), jnp.asarray(ang), CFG.pattern_seed,
        CFG.pattern))
    return dict(grays=grays, blurs=blurs, xy_ints=xy_ints, win_g=win_g,
                win_b=win_b, ang=ang, desc=desc)


def test_describe_windows_exact(describe_ref):
    r = describe_ref
    for frames, want in ((r["grays"], r["win_g"]), (r["blurs"], r["win_b"])):
        got = torb._extract_windows_packed_paired(
            [tensor(f) for f in frames],
            [tensor(x) for x in r["xy_ints"]])
        np.testing.assert_array_equal(got.numpy(), want)


def test_orientation_within_1e5(describe_ref):
    """Intensity-centroid angles from the reference's windows. The two
    moment sums run in another order than XLA's, so atan2 sees inputs a
    few ULP apart: within 1e-5 rad."""
    got = torb.orientation_from_windows_paired(
        tensor(describe_ref["win_g"])).numpy()
    diff = np.abs(got - describe_ref["ang"])
    diff = np.minimum(diff, 2 * np.pi - diff)
    assert diff.max() <= 1e-5


def test_brief_given_reference_angles(describe_ref):
    """Descriptors from the reference's windows and angles. cos/sin of the
    same angle differ by one ULP between XLA and PyTorch on about 5% of
    inputs, and a tap exactly at .5 after rotation would round the other
    way; none does here (measured 0 flipped bits of 131072), so the bits
    are equal."""
    got = torb.brief_from_windows_paired(
        tensor(describe_ref["win_b"]), tensor(describe_ref["ang"]),
        torb._pattern_on(TCFG.pattern, TCFG.pattern_seed, "cpu")).numpy()
    np.testing.assert_array_equal(got, describe_ref["desc"])


@pytest.mark.parametrize("half_w", [32, None])
@pytest.mark.parametrize("pattern", ["rublee2011", "seeded"])
def test_brief_tap_coords_equal(pattern, half_w):
    """Both layouts: the paired half window (half_w=32, 40 rows) and the
    unpaired (48, 128) window (half_w=None)."""
    ang = np.random.default_rng(8).uniform(-np.pi, np.pi, 64).astype(
        np.float32)
    rr, rc = jorb._brief_tap_coords(jnp.asarray(ang), 7, pattern,
                                    half_w=half_w)
    tr, tc = torb._brief_tap_coords(tensor(ang), 7, pattern,
                                    half_w=half_w)
    # rounding of a rotated tap may flip on a one-ULP cos/sin difference;
    # allow 1 of the 64×512 taps to move by one
    for t, r in ((tr, rr), (tc, rc)):
        d = np.abs(t.numpy() - np.asarray(r))
        assert d.max() <= 1 and (d > 0).sum() <= 1


def test_pack_unpack_descriptors():
    bits = np.random.default_rng(9).integers(0, 2, (20, 256)).astype(
        np.uint8)
    packed = torb.pack_descriptors(tensor(bits))
    np.testing.assert_array_equal(
        packed.numpy(), np.asarray(jorb.pack_descriptors(jnp.asarray(bits))))
    np.testing.assert_array_equal(torb.unpack_descriptors(packed).numpy(),
                                  bits)
    np.testing.assert_array_equal(
        np.asarray(jorb.unpack_descriptors(jnp.asarray(packed.numpy()))),
        bits)


# --------------------------------------------------------------------------
# matching
# --------------------------------------------------------------------------


def _bits_pair(seed, n=300, m=280):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 2, (n, 256)).astype(np.uint8)
    b = rng.integers(0, 2, (m, 256)).astype(np.uint8)
    # plant near-duplicates so the ratio and cross checks both bite
    src = rng.choice(n, m // 2, replace=False)
    flip = rng.random((m // 2, 256)) < 0.08
    b[: m // 2] = a[src] ^ flip
    b[m // 2 + 5: m // 2 + 10] = b[: 5]           # exact ties
    am = rng.random(n) > 0.05
    bm = rng.random(m) > 0.05
    return a, b, am, bm


@pytest.mark.parametrize("ratio", [0.8, None])
def test_match_descriptors_exact(ratio):
    a, b, am, bm = _bits_pair(10)
    ref = jmatch.match_descriptors(jnp.asarray(a), jnp.asarray(b),
                                   jnp.asarray(am), jnp.asarray(bm),
                                   max_distance=64, ratio=ratio)
    got = tmatch.match_descriptors(a, b, am, bm, max_distance=64,
                                   ratio=ratio, device="cpu")
    np.testing.assert_array_equal(got.idx.numpy(), np.asarray(ref.idx))
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(ref.mask))
    np.testing.assert_array_equal(got.dist.numpy(), np.asarray(ref.dist))
    d_ref = jmatch.hamming_distance_matrix(jnp.asarray(a), jnp.asarray(b),
                                           jnp.asarray(am), jnp.asarray(bm))
    d = tmatch.hamming_distance_matrix(tensor(a), tensor(b),
                                       tensor(am),
                                       tensor(bm))
    np.testing.assert_array_equal(d.numpy(), np.asarray(d_ref))
    xa, xb, mk = tmatch.matched_points(tensor(a[:, :2]),
                                       tensor(b[:, :2]), got)
    ra, rb, rm = jmatch.matched_points(jnp.asarray(a[:, :2]),
                                       jnp.asarray(b[:, :2]), ref)
    np.testing.assert_array_equal(xb.numpy(), np.asarray(rb))


def test_orb_end_to_end_within_bounds():
    """The whole ORB on a textured frame, port vs reference. On smooth
    frames the pyramid differs in ~60-85 ±1-LSB pixels per level (a
    bilinear tap lands on an exact .5 more often than on noise), which
    shifts a level's Harris quantisation range and so some in-cell ranks:
    measured 0.4-2.3% of keypoint slots differ on three seeds, bounded
    here at 5%. Angles of equal slots agree to 1e-2 rad and at most 1% of
    their descriptor bits flip."""
    gray = _smooth_frame(11)
    ref = jax.jit(lambda g: jorb.orb_detect_and_describe(g, CFG))(
        jnp.asarray(gray))
    got = torb.orb_detect_and_describe(gray, TCFG, device="cpu")
    same = ((got.xy.numpy() == np.asarray(ref.xy)).all(1)
            & (got.mask.numpy() == np.asarray(ref.mask)))
    assert (~same).mean() <= 0.05
    np.testing.assert_array_equal(got.octave.numpy(), np.asarray(ref.octave))
    both = same & np.asarray(ref.mask)
    da = np.abs(got.angle.numpy() - np.asarray(ref.angle))[both]
    assert np.minimum(da, 2 * np.pi - da).max() <= 1e-2
    flips = (got.descriptors.numpy() != np.asarray(ref.descriptors))[both]
    assert flips.mean() <= 0.01
