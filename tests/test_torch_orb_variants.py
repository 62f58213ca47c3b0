"""The port's other ORB describe forms (unpaired windows, lane-gather BRIEF,
per-keypoint gathers, the quadtree pipeline) and ``harris_at_windows``
against the JAX package. Stage tests feed the port the reference's previous
stage (its pyramid, keypoints and angles), so one LSB upstream cannot
cascade; the end-to-end tests carry the bound of the paired path's
(tests/test_torch_features.py). Inputs are seed-made with numpy.

On the CPU the reference's ``brief_from_windows`` takes its lane-gather
formulation (four ``lane_gather`` calls in Pallas interpret mode)."""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from kornia_tpu.features import orb as jorb
from kornia_tpu.features import quadtree as jquad
from kornia_tpu.features import responses as jresp
from kornia_tpu.ops import filters as jfilt
from kornia_tpu.ops import resize as jres

from kornia_tpu_torch import convert
from kornia_tpu_torch.features import orb as torb
from kornia_tpu_torch.features import quadtree as tquad
from kornia_tpu_torch.features import responses as tresp
from kornia_tpu_torch.ops import cuda_kernels as ck

# One intra-op thread: these tests run many small ops, and torch's pool
# of a thread per core spins against the other test processes.
torch.set_num_threads(1)

tensor = functools.partial(convert.tensor, device="cpu")

# an odd budget sum: the reference itself takes the unpaired path
CFG = jorb.OrbConfig(n_features=255, n_levels=3)
TCFG = convert.orb_config(dataclasses.asdict(CFG))
SHAPE = (160, 208)


def _smooth_frame(seed, shape=SHAPE):
    """Seeded noise upsampled ×8 and blurred: corners with a spread of
    scores."""
    rng = np.random.default_rng(seed)
    small = rng.random((shape[0] // 8 + 2, shape[1] // 8 + 2))
    big = np.kron(small, np.ones((8, 8)))[:shape[0], :shape[1]]
    blur = np.asarray(jfilt.gaussian_blur(
        jnp.asarray(big.astype(np.float32))[..., None], (5, 5), 1.5))[..., 0]
    return np.clip(blur * 255, 0, 255).astype(np.uint8)


def _angle_diff(a, b):
    d = np.abs(a - b)
    return np.minimum(d, 2 * np.pi - d)


@pytest.fixture(scope="module")
def ref():
    """The reference's describe stage on one frame, stage by stage."""
    gray = _smooth_frame(31)
    levels = [jnp.asarray(gray)]
    h, w = gray.shape
    for i in range(1, CFG.n_levels):
        s = CFG.scale_factor ** i
        levels.append(jres.resize(levels[-1], (int(round(h / s)),
                                               int(round(w / s)))))
    budgets = jorb._level_budgets(CFG)
    sels = [jorb._select_level(lv, b, CFG) for lv, b in zip(levels, budgets)]
    xys = [s[0] for s in sels]
    xy_ints = [jnp.round(xy).astype(jnp.int32) for xy in xys]
    grays = [lv.astype(jnp.float32) for lv in levels]
    blurs = [jfilt.gaussian_blur(g[..., None], (7, 7), 2.0)[..., 0]
             for g in grays]
    win_g = jorb._extract_windows_packed(grays, xy_ints)
    win_b = jorb._extract_windows_packed(blurs, xy_ints)
    ang = jorb.orientation_from_windows(win_g)
    out = dict(
        grays=grays, blurs=blurs, xys=xys, xy_ints=xy_ints, win_g=win_g,
        win_b=win_b, ang=ang,
        desc=jorb.brief_from_windows(win_b, ang, CFG.pattern_seed,
                                     CFG.pattern),
        ang_ic=[jorb.orientation_ic(g, xy) for g, xy in zip(grays, xys)])
    out["desc_ic"] = [
        jorb.brief_describe(b, xy, a, CFG.pattern_seed, CFG.pattern)
        for b, xy, a in zip(blurs, xys, out["ang_ic"])]

    def to_np(v):
        return [np.asarray(x) for x in v] if isinstance(v, list) \
            else np.asarray(v)

    return {k: to_np(v) for k, v in out.items()}


def _tensors(arrays):
    return [tensor(a) for a in arrays]


def test_unpaired_packed_windows_exact(ref):
    """Bit-equal to the reference's stacked-canvas extraction."""
    for frames, want in ((ref["grays"], ref["win_g"]),
                         (ref["blurs"], ref["win_b"])):
        got = torb._extract_windows_packed(_tensors(frames),
                                           _tensors(ref["xy_ints"]))
        assert got.shape == (255, 48, 128)
        np.testing.assert_array_equal(got.numpy(), want)


def test_single_frame_windows_exact(ref):
    """``_extract_windows`` per level, the quadtree pipeline's extraction."""
    for g, xy in zip(ref["grays"], ref["xy_ints"]):
        want = np.asarray(jorb._extract_windows(jnp.asarray(g),
                                                jnp.asarray(xy)))
        got = torb._extract_windows(tensor(g), tensor(xy))
        np.testing.assert_array_equal(got.numpy(), want)


def test_orientation_from_windows_within_1e5(ref):
    """The two moment sums run in another order than XLA's, so atan2 sees
    inputs a few ULP apart: within 1e-5 rad."""
    got = torb.orientation_from_windows(tensor(ref["win_g"]))
    assert _angle_diff(got.numpy(), ref["ang"]).max() <= 1e-5


@pytest.mark.parametrize("brief", ["sample", "lane_gather"])
def test_brief_from_windows_given_reference_angles(ref, brief):
    """Both formulations, fed the reference's windows and angles: the bits
    are equal (no rotated tap lands on an exact .5 here)."""
    got = torb.brief_from_windows(
        tensor(ref["win_b"]), tensor(ref["ang"]),
        TCFG.pattern_seed, TCFG.pattern, brief)
    np.testing.assert_array_equal(got.numpy(), ref["desc"])


def test_brief_from_windows_rejects_unknown_formulation(ref):
    with pytest.raises(ValueError, match="BRIEF formulation"):
        torb.brief_from_windows(tensor(ref["win_b"][:2]),
                                tensor(ref["ang"][:2]), brief="xla")


def test_gather_path_given_reference(ref):
    """``orientation_ic`` within 1e-5 rad (summation order) and
    ``brief_describe`` bit-equal given the reference's angles, per level;
    the gather path's descriptors equal the window path's, as in the
    reference."""
    descs = []
    for g, b, xy, a, d in zip(ref["grays"], ref["blurs"], ref["xys"],
                              ref["ang_ic"], ref["desc_ic"]):
        got_a = torb.orientation_ic(tensor(g), tensor(xy))
        assert _angle_diff(got_a.numpy(), a).max() <= 1e-5
        got_d = torb.brief_describe(tensor(b), tensor(xy),
                                    tensor(a), TCFG.pattern_seed,
                                    TCFG.pattern)
        np.testing.assert_array_equal(got_d.numpy(), d)
        descs.append(got_d.numpy())
    patches = torb._gather_patches(tensor(ref["grays"][0]),
                                   tensor(ref["xy_ints"][0]), 15)
    np.testing.assert_array_equal(
        patches.numpy(), np.asarray(jorb._gather_patches(
            jnp.asarray(ref["grays"][0]), jnp.asarray(ref["xy_ints"][0]),
            15)))
    same = np.concatenate(descs) == ref["desc"]
    assert same.mean() >= 0.999     # angles differ by ULPs between the paths


def test_seeded_pattern_layouts_differ_only_at_the_clipped_row():
    """A seeded-pattern tap rotated to row +20 is clipped to row 39 of the
    40-row paired window but kept in the 48-row unpaired one; everywhere
    else the two layouts address the same pixel. Each is as the reference
    has it (test_brief_tap_coords_equal). Seed 1 holds a (14, 14) tap,
    which reaches 19.8 px; the default seed 7 and the learned pattern stay
    within ±19 rows."""
    ang = np.random.default_rng(32).uniform(-np.pi, np.pi, 256)
    ang[:4] = np.pi / 4 + np.arange(4) * np.pi / 2
    ang = tensor(ang.astype(np.float32))
    clipped_taps = {}
    for pattern, seed in (("seeded", 1), ("seeded", 7), ("rublee2011", 7)):
        ru, cu = torb._brief_tap_coords(ang, seed, pattern)
        rp, cp = torb._brief_tap_coords(ang, seed, pattern, half_w=32)
        np.testing.assert_array_equal((cu - 64).numpy(), (cp - 32).numpy())
        dy_u, dy_p = (ru - 24).numpy(), (rp - 20).numpy()
        clipped = dy_u >= 20
        np.testing.assert_array_equal(dy_u[~clipped], dy_p[~clipped])
        assert (dy_u[clipped] == 20).all() and (dy_p[clipped] == 19).all()
        clipped_taps[pattern, seed] = int(clipped.sum())
    assert clipped_taps["seeded", 1] > 0
    assert clipped_taps["seeded", 7] == clipped_taps["rublee2011", 7] == 0


@pytest.fixture(scope="module")
def port_forms():
    gray = _smooth_frame(33)
    even = dataclasses.replace(TCFG, n_features=256)
    return gray, even, {
        name: torb.orb_detect_and_describe(gray, even, device="cpu", **kw)
        for name, kw in (("auto", {}), ("paired", dict(describe="paired")),
                         ("unpaired", dict(describe="unpaired")),
                         ("lane_gather", dict(brief="lane_gather")),
                         ("gather", dict(describe="gather")))}


def test_describe_forms_agree_on_the_port(port_forms):
    """The same frame through every form: keypoints are the same, paired,
    unpaired and lane-gather descriptors bit-equal; the gather form's
    angles come from gathered patches (another summation order), so a few
    of its bits may flip."""
    _, _, f = port_forms
    for name in ("paired", "unpaired", "lane_gather", "gather"):
        assert torch.equal(f[name].xy, f["auto"].xy)
        assert torch.equal(f[name].mask, f["auto"].mask)
    assert torch.equal(f["paired"].descriptors, f["auto"].descriptors)
    assert torch.equal(f["unpaired"].descriptors, f["paired"].descriptors)
    assert torch.equal(f["unpaired"].angle, f["paired"].angle)
    assert torch.equal(f["lane_gather"].descriptors,
                       f["unpaired"].descriptors)
    flips = (f["gather"].descriptors != f["unpaired"].descriptors)
    assert flips.float().mean() <= 1e-3


def test_describe_argument_rules(port_forms):
    gray, even, _ = port_forms
    odd = dataclasses.replace(TCFG, n_features=255)
    for cfg, kw, msg in (
            (even, dict(describe="packed"), "describe form"),
            (even, dict(brief="xla"), "BRIEF formulation"),
            (odd, dict(describe="paired"), "even keypoint count"),
            (even, dict(describe="paired", brief="lane_gather"),
             "only in the unpaired")):
        with pytest.raises(ValueError, match=msg):
            torb.orb_detect_and_describe(gray, cfg, device="cpu", **kw)


def test_odd_budget_sum_takes_the_unpaired_form(port_forms):
    """An odd feature count no longer raises: "auto" is the unpaired form
    there."""
    gray, _, _ = port_forms
    odd = dataclasses.replace(TCFG, n_features=255)
    auto = torb.orb_detect_and_describe(gray, odd, device="cpu")
    unp = torb.orb_detect_and_describe(gray, odd, device="cpu",
                                       describe="unpaired")
    assert auto.descriptors.shape == (255, 256)
    for a, b in zip(auto, unp):
        assert torch.equal(a, b)


def _end_to_end_bounds(got, want):
    """The paired path's bound (tests/test_torch_features.py): at most 5%
    of keypoint slots differ (pyramid ±1 LSB shifts the Harris
    quantisation); on equal slots angles within 1e-2 rad and at most 1% of
    descriptor bits flipped."""
    same = ((got.xy.numpy() == np.asarray(want.xy)).all(1)
            & (got.mask.numpy() == np.asarray(want.mask)))
    assert (~same).mean() <= 0.05
    np.testing.assert_array_equal(got.octave.numpy(),
                                  np.asarray(want.octave))
    both = same & np.asarray(want.mask)
    assert both.sum() >= 50
    assert _angle_diff(got.angle.numpy(),
                       np.asarray(want.angle))[both].max() <= 1e-2
    flips = (got.descriptors.numpy() != np.asarray(want.descriptors))[both]
    assert flips.mean() <= 0.01


def test_orb_unpaired_end_to_end_within_bounds():
    gray = _smooth_frame(34)
    want = jorb.orb_detect_and_describe(jnp.asarray(gray), CFG)
    got = torb.orb_detect_and_describe(gray, TCFG, device="cpu")
    _end_to_end_bounds(got, want)


def test_orb_gather_end_to_end_within_bounds(monkeypatch):
    """The reference reaches its per-keypoint gather path only through
    KORNIA_TPU_ORB; the port takes ``describe="gather"``."""
    gray = _smooth_frame(35)
    monkeypatch.setenv("KORNIA_TPU_ORB", "gather")
    want = jorb.orb_detect_and_describe(jnp.asarray(gray), CFG)
    got = torb.orb_detect_and_describe(gray, TCFG, device="cpu",
                                       describe="gather")
    _end_to_end_bounds(got, want)


def test_distribute_quadtree_copy_equal():
    """The port's own numpy copy selects what the reference's selects."""
    rng = np.random.default_rng(36)
    for n, target in ((400, 60), (30, 60), (200, 199), (0, 5)):
        xy = rng.uniform(0, [320, 240], (n, 2))
        sc = rng.random(n)
        np.testing.assert_array_equal(
            tquad.distribute_quadtree(xy, sc, target, 320, 240),
            jquad.distribute_quadtree(xy, sc, target, 320, 240))
    xy = rng.uniform(0, [320, 240], (50, 2))
    assert tquad.occupancy(xy, 320, 240) == jquad.occupancy(xy, 320, 240)


def test_orb_quadtree_end_to_end_within_bounds():
    """Host-orchestrated quadtree ORB on a noise frame (the pyramid of a
    noise frame differs from the reference's in 0-3 pixels per level):
    FAST runs through the plain composition on both sides, the quadtree on
    the host, the describe through per-level windows."""
    gray = np.random.default_rng(37).integers(0, 256, SHAPE, np.uint8)
    cfg = dataclasses.replace(CFG, n_features=120)
    tcfg = convert.orb_config(dataclasses.asdict(cfg))
    want = jorb.orb_detect_and_describe_quadtree(jnp.asarray(gray), cfg)
    got = torb.orb_detect_and_describe_quadtree(gray, tcfg, device="cpu")
    assert got.descriptors.shape == (120, 256)
    assert int(got.mask.sum()) == int(np.asarray(want.mask).sum()) > 0
    _end_to_end_bounds(got, want)
    same = (got.xy.numpy() == np.asarray(want.xy)).all(1)
    np.testing.assert_allclose(got.score.numpy()[same],
                               np.asarray(want.score)[same])
    lg = torb.orb_detect_and_describe_quadtree(gray, tcfg, device="cpu",
                                               brief="lane_gather")
    assert torch.equal(lg.descriptors, got.descriptors)


def test_harris_at_windows_and_harris_at():
    """``harris_at_windows`` against the reference's (one
    extract_windows_pallas call in interpret mode): the 5×5 weighted sums
    run in another order than XLA's einsum, rtol 1e-5 of the response
    (atol 1e-5 of the largest for values that cancel to near zero).
    ``harris_at`` samples the dense Sobel map: same tolerance. Away from
    the borders the windowed value is the dense central-gradient map's."""
    gray = _smooth_frame(38).astype(np.float32)
    rng = np.random.default_rng(39)
    xy = np.stack([rng.integers(0, SHAPE[1], 40),
                   rng.integers(0, SHAPE[0], 40)], 1).astype(np.int32)
    xy[:4] = [[0, 0], [SHAPE[1] - 1, SHAPE[0] - 1], [0, 77], [100, 0]]
    want = np.asarray(jresp.harris_at_windows(jnp.asarray(gray),
                                              jnp.asarray(xy)))
    got = tresp.harris_at_windows(tensor(gray),
                                  tensor(xy)).numpy()
    tol = dict(rtol=1e-5, atol=1e-5 * np.abs(want).max())
    np.testing.assert_allclose(got, want, **tol)
    want_at = np.asarray(jresp.harris_at(jnp.asarray(gray),
                                         jnp.asarray(xy.astype(np.float32))))
    got_at = tresp.harris_at(tensor(gray),
                             tensor(xy.astype(np.float32))).numpy()
    np.testing.assert_allclose(got_at, want_at, rtol=1e-5,
                               atol=1e-5 * np.abs(want_at).max())
    dense = tresp.harris_response(tensor(gray), grad="central")
    inner = ((xy[:, 0] >= 4) & (xy[:, 0] < SHAPE[1] - 4)
             & (xy[:, 1] >= 4) & (xy[:, 1] < SHAPE[0] - 4))
    at = dense.numpy()[xy[inner, 1], xy[inner, 0]]
    np.testing.assert_allclose(got[inner], at, rtol=1e-4,
                               atol=1e-4 * np.abs(at).max())


def test_sobel_exact():
    gray = _smooth_frame(40)
    from kornia_tpu_torch.ops import filters as tfilt
    for dx, dy, k in ((1, 0, 3), (0, 1, 3), (1, 0, 5)):
        want = np.asarray(jfilt.sobel(jnp.asarray(gray), dx, dy, k))
        got = tfilt.sobel(tensor(gray), dx, dy, k).numpy()
        np.testing.assert_array_equal(got, want)


def test_unpaired_wrappers_count_no_cpu_launch(port_forms):
    ck.reset_launch_counts()
    gray, even, _ = port_forms
    torb.orb_detect_and_describe(gray, even, device="cpu",
                                 brief="lane_gather")
    assert all(v == 0 for v in ck.LAUNCHES.values())


def test_quadtree_default_device_needs_a_card(port_forms):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CUDA entry point runs")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        torb.orb_detect_and_describe_quadtree(port_forms[0])
