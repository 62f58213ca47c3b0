"""The port's CUDA kernels (kornia_tpu_torch/ops/cuda_kernels.py) against
the JAX package.

On the CPU every wrapper runs its plain PyTorch version; those are held
here to the JAX reference: the XLA composition the CPU reference runs, and
the Pallas kernel itself in interpret mode. The CUDA kernels themselves
are held to their plain versions on the card by tests/test_torch_cuda.py.
"""

import dataclasses
import functools
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from kornia_tpu.features import fast as jfast
from kornia_tpu.features import orb as jorb
from kornia_tpu.features import responses as jresp
from kornia_tpu.ops import optical_flow as jflow
from kornia_tpu.ops import pallas_kernels as pk

from kornia_tpu_torch import convert
from kornia_tpu_torch.features import fast as tfast
from kornia_tpu_torch.features import orb as torb
from kornia_tpu_torch.ops import cuda_kernels as ck

# One intra-op thread: these tests run many small ops, and torch's pool
# of a thread per core spins against the other test processes.
torch.set_num_threads(1)

tensor = functools.partial(convert.tensor, device="cpu")


def _img(seed, shape):
    return np.random.default_rng(seed).integers(0, 256, shape, np.uint8)


def _levels(seed, shapes):
    return [_img(seed + i, s) for i, s in enumerate(shapes)]


def _keypoints(seed, shapes, counts):
    """Per-level int32 keypoints inside each level, border points first."""
    rng = np.random.default_rng(seed)
    out = []
    for (h, w), n in zip(shapes, counts):
        border = np.array([[0, 0], [w - 1, h - 1], [w - 1, 0], [0, h - 1]],
                          np.int32)[:n]
        inner = np.stack([rng.integers(0, w, n - len(border)),
                          rng.integers(0, h, n - len(border))], 1)
        out.append(np.concatenate([border, inner]).astype(np.int32))
    return out


# --------------------------------------------------------------------------
# K1: FAST score + NMS + Harris
# --------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(64, 96), (53, 97), (17, 23), (1, 1),
                                   (2, 7), (4, 9)])
def test_fast_harris_plain_matches_reference(shape):
    """Score and NMS maps are exact (the V measure is integer on u8), and
    so is the Harris map: the port keeps the reference's padding and its
    separately rounded multiply/add order, and XLA on the CPU contracts
    nothing into FMAs here (measured: 0 differing pixels). Levels of 1, 2
    and 4 px: the window's reflect padding repeats as jnp.pad's does."""
    img = _img(1, shape)
    s_ref = np.asarray(jfast.nms_maxpool(jfast.fast_score(
        jnp.asarray(img), 7.0)))
    h_ref = np.asarray(jresp.harris_response(
        jnp.asarray(img).astype(jnp.float32), k=0.04, block_size=5,
        sigma=1.0, grad="central"))
    score, hmap = tfast.fast_harris(tensor(img), 7.0)
    np.testing.assert_array_equal(score.numpy(), s_ref)
    np.testing.assert_array_equal(hmap.numpy(), h_ref)


def test_fast_harris_plain_matches_pallas_interpret():
    """Against the Pallas kernel (interpret mode): the score/NMS map is
    exact everywhere; Harris is compared ≥ 3 px from the border, where the
    Pallas kernel's zero padding cannot reach, to the FMA-association
    tolerance the JAX package's own test states (≤ 3e-6 of the map's
    range; ORB reads no other pixels)."""
    img = _img(2, (48, 80))
    s_pl, h_pl = pk.fast_score_pallas(jnp.asarray(img), 7.0, 9, nms=True,
                                      harris=True)
    score, hmap = tfast.fast_harris(tensor(img), 7.0)
    np.testing.assert_array_equal(score.numpy(), np.asarray(s_pl))
    hp = np.asarray(h_pl)[3:-3, 3:-3]
    ht = hmap.numpy()[3:-3, 3:-3]
    assert np.abs(ht - hp).max() <= 3e-6 * np.abs(hp).max()


def test_fast_harris_counts_no_cpu_launch():
    ck.reset_launch_counts()
    tfast.fast_harris(tensor(_img(3, (32, 32))), 7.0)
    assert ck.LAUNCHES["fast_harris"] == 0


@pytest.mark.parametrize("shapes", [
    [(120, 160), (100, 133), (83, 111)],
    [(1, 1), (7, 7), (17, 33), (31, 63)],
    [(33, 65)]])
def test_fast_harris_levels_plain_equals_per_level(shapes):
    """The all-levels call gives, level by level, what the one-level call
    gives, in the levels' order, tiny levels (no FAST border zone at all)
    included; it counts no launch on the CPU."""
    levels = [tensor(a) for a in _levels(4, shapes)]
    ck.reset_launch_counts()
    got = tfast.fast_harris_levels(levels, 7.0)
    assert ck.LAUNCHES["fast_harris"] == 0
    assert len(got) == len(levels)
    for (score, hmap), lv in zip(got, levels):
        s1, h1 = tfast.fast_harris(lv, 7.0)
        assert score.shape == hmap.shape == lv.shape
        assert torch.equal(score, s1) and torch.equal(hmap, h1)
    assert tfast.fast_harris_levels([], 7.0) == []


@pytest.fixture(scope="module")
def ref_pyramid():
    """A 3-level pyramid of a seeded 120×160 frame, made by the reference's
    resize, with its maps from the Pallas kernel (interpret mode) and from
    the XLA composition."""
    from kornia_tpu.ops import resize as jres
    lv = [jnp.asarray(_img(5, (120, 160)))]
    for i in (1, 2):
        lv.append(jres.resize(lv[-1], (int(round(120 / 1.2 ** i)),
                                       int(round(160 / 1.2 ** i)))))
    pallas = [pk.fast_score_pallas(x, 7.0, 9, nms=True, harris=True)
              for x in lv]
    xla = [(jfast.nms_maxpool(jfast.fast_score(x, 7.0)),
            jresp.harris_response(x.astype(jnp.float32), k=0.04,
                                  block_size=5, sigma=1.0, grad="central"))
           for x in lv]
    got = tfast.fast_harris_levels([tensor(np.asarray(x)) for x in lv],
                                   7.0)
    return got, pallas, xla, [np.asarray(x) for x in lv]


@pytest.mark.parametrize("level", [0, 1, 2])
def test_fast_harris_levels_matches_pallas_interpret_and_xla(ref_pyramid,
                                                             level):
    """Each level of the all-levels call: score/NMS and Harris equal to the
    XLA composition at every pixel; against the Pallas kernel the score/NMS
    map is exact and Harris ≥ 3 px from the border agrees to the
    FMA-association tolerance of the one-level test above."""
    got, pallas, xla, _ = ref_pyramid
    score, hmap = (t.numpy() for t in got[level])
    np.testing.assert_array_equal(score, np.asarray(xla[level][0]))
    np.testing.assert_array_equal(hmap, np.asarray(xla[level][1]))
    np.testing.assert_array_equal(score, np.asarray(pallas[level][0]))
    hp = np.asarray(pallas[level][1])[3:-3, 3:-3]
    assert np.abs(hmap[3:-3, 3:-3] - hp).max() <= 3e-6 * np.abs(hp).max()


@pytest.mark.parametrize("describe", ["paired", "unpaired", "gather"])
def test_orb_features_equal_the_per_level_route(ref_pyramid, monkeypatch,
                                                describe):
    """ORB's keypoints in every describe form, from one all-levels K1 call,
    equal at every slot (xy, score, mask, octave) those of the reference's
    per-level route, ``_select_level`` with its own FAST + Harris pass per
    level, on the reference's 3-level pyramid of the same frame."""
    levels = ref_pyramid[3]
    cfg = jorb.OrbConfig(n_features=300, n_levels=len(levels))
    tcfg = convert.orb_config(dataclasses.asdict(cfg))
    budgets = jorb._level_budgets(cfg)
    monkeypatch.setattr(torb, "_pyramid", lambda g, c: [
        tensor(lv) for lv in levels])
    calls = []
    all_levels = tfast.fast_harris_levels

    def counted(lvs, thr):
        calls.append(len(lvs))
        return all_levels(lvs, thr)

    monkeypatch.setattr(torb, "fast_harris_levels", counted)
    got = torb.orb_detect_and_describe(levels[0], tcfg, device="cpu",
                                       describe=describe)
    assert calls == [len(levels)]
    sels = [jorb._select_level(jnp.asarray(lv), b, cfg)
            for lv, b in zip(levels, budgets)]
    want = {"xy": jnp.concatenate([s[0] * cfg.scale_factor**i
                                   for i, s in enumerate(sels)]),
            "score": jnp.concatenate([s[1] for s in sels]),
            "mask": jnp.concatenate([s[2] for s in sels])}
    for field, ref in want.items():
        np.testing.assert_array_equal(getattr(got, field).numpy(),
                                      np.asarray(ref), field)
    np.testing.assert_array_equal(got.octave.numpy(),
                                  np.repeat(np.arange(len(levels)), budgets))


# 17 seed-made levels of a 1.1-scale pyramid: the 17th is 42 x 56
_SHAPES_17 = [(int(round(192 / 1.1 ** i)), int(round(256 / 1.1 ** i)))
              for i in range(17)]


@pytest.fixture(scope="module")
def levels17():
    """The 17 levels, the OrbConfig that takes them and the reference's
    selection of the 17th level (one JAX compile)."""
    levels = [_img(60 + i, s) for i, s in enumerate(_SHAPES_17)]
    cfg = jorb.OrbConfig(n_features=300, n_levels=17, scale_factor=1.1)
    budget = jorb._level_budgets(cfg)[16]
    ref = jorb._select_level(jnp.asarray(levels[16]), budget, cfg)
    return levels, cfg, [np.array(a) for a in ref]


@pytest.mark.parametrize("form", [dict(describe="paired"),
                                  dict(describe="unpaired"),
                                  dict(brief="lane_gather"),
                                  dict(describe="gather")],
                         ids=["paired", "unpaired", "lane_gather", "gather"])
def test_orb_17_levels_in_chunks_equal_the_per_level_route(levels17,
                                                           monkeypatch, form):
    """ORB with 17 levels returns: one ``fast_harris_levels`` call that
    goes to K1 in chunks of 16 and 1 levels, and every feature in every
    describe form equal to the per-level route's (``_select_level(...,
    maps=None)``, one K1 call per level); the 17th level's selection is
    the reference's ``_select_level``, slot for slot."""
    levels, cfg, ref17 = levels17
    tcfg = convert.orb_config(dataclasses.asdict(cfg))
    monkeypatch.setattr(torb, "_pyramid", lambda g, c: [
        tensor(lv) for lv in levels])
    calls, chunks = [], []
    all_levels, chunk = tfast.fast_harris_levels, tfast._fast_harris_chunk

    def counted(lvs, thr):
        calls.append(len(lvs))
        return all_levels(lvs, thr)

    def counted_chunk(lvs, thr):
        chunks.append(len(lvs))
        return chunk(lvs, thr)

    monkeypatch.setattr(torb, "fast_harris_levels", counted)
    monkeypatch.setattr(tfast, "_fast_harris_chunk", counted_chunk)
    got = torb.orb_detect_and_describe(levels[0], tcfg, device="cpu",
                                       **form)
    assert calls == [17] and chunks == [16, 1]
    budgets = torb._level_budgets(tcfg)
    sels = [torb._select_level(tensor(lv), b, tcfg)
            for lv, b in zip(levels, budgets)]
    for field, i in (("xy", 0), ("score", 1), ("mask", 2)):
        want = torch.cat([sl[i] * tcfg.scale_factor ** lv if i == 0
                          else sl[i] for lv, sl in enumerate(sels)])
        assert torch.equal(getattr(got, field), want), field
    monkeypatch.setattr(torb, "fast_harris_levels", lambda lvs, thr: [
        all_levels([lv], thr)[0] for lv in lvs])
    per_level = torb.orb_detect_and_describe(levels[0], tcfg, device="cpu",
                                             **form)
    for field in got._fields:
        assert torch.equal(getattr(got, field), getattr(per_level, field)), \
            field
    n17 = budgets[16]
    for a, want in zip((got.xy[-n17:], got.score[-n17:], got.mask[-n17:]),
                       (torch.from_numpy(ref17[0]) * tcfg.scale_factor ** 16,
                        *ref17[1:])):
        np.testing.assert_array_equal(a.numpy(), np.asarray(want))


@pytest.mark.parametrize("levels,match", [
    ([np.zeros((8, 8), np.uint8), np.zeros(8, np.uint8)], "2-D"),
    ([np.zeros((8, 8), np.uint8), np.zeros((8, 8), np.float32)], "uint8"),
    ([np.zeros((2, 8, 8), np.uint8)], "2-D")])
def test_fast_harris_levels_rejects_bad_input_on_cpu(levels, match):
    """The CPU route checks what the card route checks: each level a 2-D
    uint8 tensor (any number of levels is taken, in chunks of 16)."""
    with pytest.raises(ValueError, match=match):
        tfast.fast_harris_levels([tensor(a) for a in levels], 7.0)


# --------------------------------------------------------------------------
# K2: paired windows
# --------------------------------------------------------------------------

_SHAPES = [(60, 80), (50, 67), (42, 56)]


@pytest.mark.parametrize("counts", [(6, 5, 5), (7, 6, 3)])
def test_windows_paired_plain_matches_reference(counts):
    """Bit-equal to the reference's non-TPU branch (orb.py:382-386). Odd
    level budgets make pairs straddle two levels; each half must read its
    own level; border keypoints read edge-replicated pixels."""
    frames = [f.astype(np.float32) for f in _levels(4, _SHAPES)]
    xys = _keypoints(5, _SHAPES, counts)
    ref = np.asarray(jorb._extract_windows_packed_paired(
        [jnp.asarray(f) for f in frames], [jnp.asarray(x) for x in xys]))
    canvas, starts = ck.prepare_window_canvas(
        [tensor(f) for f in frames])
    xy = torch.cat([tensor(x) + torch.tensor([0, s],
                                                     dtype=torch.int32)
                    for x, s in zip(xys, starts)])
    got = ck.windows_paired(canvas, xy, max(w for _, w in _SHAPES))
    assert got.shape == ref.shape
    np.testing.assert_array_equal(got.numpy(), ref)


def test_windows_paired_plain_matches_pallas_interpret():
    """Against extract_windows_prepared_paired itself (interpret mode) on
    its own aligned canvas: the same windows."""
    frames = [f.astype(np.float32) for f in _levels(6, _SHAPES)]
    xys = _keypoints(7, _SHAPES, (5, 5, 6))
    pads = [pk.prepare_window_source(jnp.asarray(f), 40, 20, 64)
            for f in frames]
    wmax = max(int(p.shape[1]) for p in pads)
    pads = [jnp.pad(p, ((0, 0), (0, wmax - int(p.shape[1])))) for p in pads]
    pstarts = np.cumsum([0] + [int(p.shape[0]) for p in pads])
    xy_pl = jnp.concatenate([jnp.asarray(x) + jnp.asarray([0, s], jnp.int32)
                             for x, s in zip(xys, pstarts)])
    ref = np.asarray(pk.extract_windows_prepared_paired(
        jnp.concatenate(pads), (int(pstarts[-1]), 80), xy_pl, 40))
    canvas, starts = ck.prepare_window_canvas(
        [tensor(f) for f in frames])
    xy = torch.cat([tensor(x) + torch.tensor([0, s],
                                                     dtype=torch.int32)
                    for x, s in zip(xys, starts)])
    np.testing.assert_array_equal(ck.windows_paired(canvas, xy, 80).numpy(),
                                  ref)


# --------------------------------------------------------------------------
# K3: BRIEF tap sampling
# --------------------------------------------------------------------------


def _taps(seed, k2):
    rng = np.random.default_rng(seed)
    win = rng.random((k2, 40, 128)).astype(np.float32)
    rows = rng.integers(0, 40, (k2, 1024)).astype(np.int32)
    cols = rng.integers(0, 128, (k2, 1024)).astype(np.int32)
    return win, rows, cols


def test_brief_sample_plain_matches_take_along_axis():
    """Bit-equal to the take_along_axis branch (orb.py:422-423)."""
    win, rows, cols = _taps(8, 13)
    ref = np.asarray(jnp.take_along_axis(
        jnp.asarray(win).reshape(13, -1), jnp.asarray(rows * 128 + cols),
        axis=1))
    got = ck.brief_sample(tensor(win), tensor(rows),
                          tensor(cols))
    np.testing.assert_array_equal(got.numpy(), ref)


def test_brief_sample_plain_matches_pallas_interpret():
    win, rows, cols = _taps(9, 11)
    ref = np.asarray(pk.brief_sample_pallas(
        jnp.asarray(win), jnp.asarray(rows), jnp.asarray(cols)))
    got = ck.brief_sample(tensor(win), tensor(rows),
                          tensor(cols))
    np.testing.assert_array_equal(got.numpy(), ref)


_ROTATED_CASES = [(layout, k) for layout in ("paired", "unpaired")
                  for k in (0, 2, 64)] + [("unpaired", 7)]


def _rotated_inputs(layout, k, pattern, seed):
    rng = np.random.default_rng(31)
    paired = layout == "paired"
    win = tensor(rng.standard_normal(
        (k // 2 if paired else k, 40 if paired else 48, 128)).astype(
        np.float32))
    ang = rng.uniform(-np.pi, np.pi, k).astype(np.float32)
    ang[:2] = (0.0, np.pi / 4)[:k]
    return win, tensor(ang), torb._pattern_on(pattern, seed, "cpu")


@pytest.mark.parametrize("pattern,seed", [("rublee2011", 7), ("seeded", 7),
                                          ("seeded", 1)])
@pytest.mark.parametrize("layout,k", _ROTATED_CASES)
def test_brief_rotated_plain_samples_match_the_index_form(layout, k, pattern,
                                                          seed):
    """``_brief_rotated_plain(out="samples")`` equals the index form it
    replaces on the path, ``_brief_sample_plain(windows,
    *_brief_tap_coords(...))``, exactly: both layouts, the learned pattern
    and two seeded ones (seed 1 has the (14, 14) tap that reaches the
    paired layout's row clip), K = 0, an odd K on the unpaired layout."""
    win, ang, pat = _rotated_inputs(layout, k, pattern, seed)
    paired = layout == "paired"
    rows, cols = torb._brief_tap_coords(ang, seed, pattern,
                                        half_w=32 if paired else None)
    if paired:
        lane = torch.tensor([0, 64], dtype=torch.int32)
        rows = rows.reshape(k // 2, 1024)
        cols = (cols.reshape(k // 2, 2, 512)
                + lane[None, :, None]).reshape(k // 2, 1024)
    want = ck._brief_sample_plain(win, rows, cols).reshape(k, 512)
    args = (win, torch.cos(ang), torch.sin(ang), pat, layout)
    got = ck._brief_rotated_plain(*args, out="samples")
    assert got.shape == (k, 512) and got.dtype == torch.float32
    assert torch.equal(got, want)
    bits = ck.brief_rotated(*args)
    assert bits.shape == (k, 256) and bits.dtype == torch.uint8
    assert torch.equal(bits, (want[:, :256] < want[:, 256:]).to(torch.uint8))


@pytest.mark.parametrize("pattern,seed", [("rublee2011", 7), ("seeded", 1)])
@pytest.mark.parametrize("layout", ["paired", "unpaired"])
def test_brief_rotated_bits_match_reference(layout, pattern, seed):
    """``out="bits"`` through the port's two callers equals the reference's
    ``brief_from_windows_paired`` / ``brief_from_windows`` on the same
    windows and angles, exactly (0 of 64 x 256 bits flip here; a one-ULP
    cos/sin difference could move a tap that rotates onto an exact .5)."""
    win, ang, _ = _rotated_inputs(layout, 64, pattern, seed)
    if layout == "paired":
        want = jorb.brief_from_windows_paired(
            jnp.asarray(win.numpy()), jnp.asarray(ang.numpy()), seed, pattern)
        got = torb.brief_from_windows_paired(
            win, ang, torb._pattern_on(pattern, seed, win.device))
    else:
        want = jorb.brief_from_windows(
            jnp.asarray(win.numpy()), jnp.asarray(ang.numpy()), seed, pattern)
        got = torb.brief_from_windows(win, ang, seed, pattern)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_brief_rotated_rejects_bad_shapes_and_counts_no_cpu_launch():
    win, ang, pat = _rotated_inputs("paired", 4, "rublee2011", 7)
    c, s = torch.cos(ang), torch.sin(ang)
    ck.reset_launch_counts()
    ck.brief_rotated(win, c, s, pat, "paired")
    assert ck.LAUNCHES["brief_rotated"] == ck.LAUNCHES["brief_sample"] == 0
    with pytest.raises(ValueError, match="do not fill"):
        ck.brief_rotated(win, c[:3], s[:3], pat, "paired")
    with pytest.raises(ValueError, match="must be"):
        ck.brief_rotated(win, c, s, pat, "unpaired")
    with pytest.raises(ValueError, match="unknown layout"):
        ck.brief_rotated(win, c, s, pat, "both")
    with pytest.raises(ValueError, match="unknown output"):
        ck.brief_rotated(win, c, s, pat, "paired", out="bytes")
    with pytest.raises(ValueError, match="pattern"):
        ck.brief_rotated(win, c, s, pat[:128], "paired")


@pytest.mark.parametrize("form", ["affine", "persp"])
def test_remap_coefs_as_tensor_list_and_numpy_agree(form):
    """``ck.remap`` takes the nine coefficients as a tensor, a list or a
    numpy array (any float type) and gives identical results."""
    img = tensor(_img(32, (40, 56, 3)))
    vals = [0.94, -0.34, 20.5, 0.34, 0.94, -12.25, 0.0, 0.0, 1.0]
    if form == "persp":
        vals[6:8] = [1e-3, -8e-4]
    want = ck.remap(img, (33, 47), form,
                    coefs=torch.tensor(vals, dtype=torch.float32))
    for coefs in (vals, np.asarray(vals), np.asarray(vals, np.float32),
                  torch.tensor(vals, dtype=torch.float64).reshape(3, 3)):
        assert torch.equal(ck.remap(img, (33, 47), form, coefs=coefs), want)
    assert want.shape == (33, 47, 3) and want.dtype == torch.uint8


# --------------------------------------------------------------------------
# K4: one window per keypoint
# --------------------------------------------------------------------------


def _frame_and_keypoints(seed, h, w, k=21):
    """The shapes of tests/test_pallas_kernels.py:86-99: a float frame and
    k keypoints, the first four on the corners and edges."""
    rng = np.random.default_rng(seed)
    img = rng.standard_normal((h, w)).astype(np.float32)
    xs = rng.integers(0, w, k)
    ys = rng.integers(0, h, k)
    xs[:4] = [0, w - 1, 1, w - 2]
    ys[:4] = [0, h - 1, h - 1, 0]
    return img, np.stack([xs, ys], 1).astype(np.int32)


@pytest.mark.parametrize("h,w", [(240, 320), (97, 131)])
def test_windows_plain_matches_pallas_interpret_and_slices(h, w):
    """A single frame, (48, 24, 64): bit-equal to extract_windows_pallas
    (interpret mode) and to the vmapped dynamic_slice branch
    (orb.py:155-162), corner keypoints and a ragged frame included."""
    img, xy = _frame_and_keypoints(20, h, w)
    got = ck.windows(tensor(img), tensor(xy)).numpy()
    assert got.shape == (21, 48, 128)
    np.testing.assert_array_equal(got, np.asarray(
        pk.extract_windows_pallas(jnp.asarray(img), jnp.asarray(xy))))
    np.testing.assert_array_equal(got, np.asarray(
        jorb._extract_windows(jnp.asarray(img), jnp.asarray(xy))))


def test_windows_plain_clips_keypoints_outside_the_frame():
    """xy is clipped to the frame first (pallas_kernels.py:409)."""
    img, xy = _frame_and_keypoints(21, 50, 70, 6)
    far = xy.copy()
    far[0] = (-9, -3)
    far[1] = (200, 300)
    xy[0] = (0, 0)
    xy[1] = (69, 49)
    np.testing.assert_array_equal(
        ck.windows(tensor(img), tensor(far)).numpy(),
        ck.windows(tensor(img), tensor(xy)).numpy())


def test_windows_plain_taps_layout_matches_slices():
    """The LK taps layout (24 rows, 8 above, 64 left) against the
    dynamic_slice fallback (optical_flow.py:306-323)."""
    img, xy = _frame_and_keypoints(22, 64, 96, 33)
    want = np.asarray(jflow._extract_taps_windows(
        jflow._prepare_taps_source(jnp.asarray(img)), jnp.asarray(xy)))
    got = ck.windows(tensor(img), tensor(xy), 24, 8, 64)
    np.testing.assert_array_equal(got.numpy(), want)


def test_windows_plain_packed_canvas_matches_reference():
    """The level-stacked canvas call: bit-equal to the reference's non-TPU
    branch (orb.py:330-347) and to extract_windows_prepared (interpret
    mode) on the reference's own aligned canvas."""
    frames = [f.astype(np.float32) for f in _levels(23, _SHAPES)]
    xys = _keypoints(24, _SHAPES, (7, 6, 4))
    jf = [jnp.asarray(f) for f in frames]
    ref = np.asarray(jorb._extract_windows_packed(
        jf, [jnp.asarray(x) for x in xys]))
    canvas, starts = ck.prepare_window_canvas(
        [tensor(f) for f in frames], 48, 24)
    xy = torch.cat([tensor(x) + torch.tensor([0, s],
                                                     dtype=torch.int32)
                    for x, s in zip(xys, starts)])
    got = ck.windows(canvas, xy, 48, prepared=(starts[-1], 80)).numpy()
    np.testing.assert_array_equal(got, ref)
    pads = [pk.prepare_window_source(f, 48, 24, 64) for f in jf]
    wmax = max(int(p.shape[1]) for p in pads)
    pads = [jnp.pad(p, ((0, 0), (0, wmax - int(p.shape[1])))) for p in pads]
    pstarts = np.cumsum([0] + [int(p.shape[0]) for p in pads])
    xy_pl = jnp.concatenate([jnp.asarray(x) + jnp.asarray([0, s], jnp.int32)
                             for x, s in zip(xys, pstarts)])
    np.testing.assert_array_equal(got, np.asarray(pk.extract_windows_prepared(
        jnp.concatenate(pads), (int(pstarts[-1]), 80), xy_pl, 48)))


def test_prepare_window_canvas_default_is_the_paired_layout():
    frames = [tensor(f.astype(np.float32))
              for f in _levels(25, _SHAPES)]
    a, sa = ck.prepare_window_canvas(frames)
    b, sb = ck.prepare_window_canvas(frames, ck.PAIR_WIN_H, ck.PAIR_CY)
    assert sa == sb and torch.equal(a, b)
    assert sa[1] == _SHAPES[0][0] + 40
    c, sc = ck.prepare_window_canvas(frames, 48, 24)
    assert sc[1] == _SHAPES[0][0] + 48
    assert torch.equal(c[24:24 + 60, 64:64 + 80], frames[0])


# --------------------------------------------------------------------------
# K5: lane gather
# --------------------------------------------------------------------------


@pytest.mark.parametrize("n,g", [(12, 48), (7, 3)])
def test_lane_gather_broadcast_matches_pallas_interpret(n, g):
    """The broadcast-index mode ((n, 128) index rows, each serving g
    source rows) equals lane_gather (interpret mode) on the expanded
    (n * g, 128) index, and the general call on it."""
    rng = np.random.default_rng(27)
    src = rng.standard_normal((n * g, 128)).astype(np.float32)
    idx = rng.integers(-3, 131, (n, 128)).astype(np.int32)
    full = np.repeat(idx, g, axis=0)
    ref = np.asarray(pk.lane_gather(jnp.asarray(src), jnp.asarray(full)))
    got = ck.lane_gather(tensor(src), tensor(idx))
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(
        got.numpy(), ck.lane_gather(tensor(src),
                                    tensor(full)).numpy())


@pytest.mark.parametrize("n_src,n_idx", [(96, 5), (96, 0), (10, 20)])
def test_lane_gather_rejects_index_rows_that_do_not_divide(n_src, n_idx):
    with pytest.raises(ValueError, match="do not divide"):
        ck.lane_gather(torch.zeros(n_src, 128),
                       torch.zeros(n_idx, 128, dtype=torch.int32))


@pytest.mark.parametrize("n", [5, 512, 700])
def test_lane_gather_plain_matches_pallas_interpret(n):
    """Bit-equal to lane_gather (interpret mode), indices outside
    [0, 127] included: both clip them (pallas_kernels.py:359)."""
    rng = np.random.default_rng(26)
    src = rng.standard_normal((n, 128)).astype(np.float32)
    idx = rng.integers(0, 128, (n, 128)).astype(np.int32)
    idx[0, :4] = [-5, 128, 1000, -1]
    ref = np.asarray(pk.lane_gather(jnp.asarray(src), jnp.asarray(idx)))
    got = ck.lane_gather(tensor(src), tensor(idx))
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(
        got.numpy(), np.take_along_axis(src, np.clip(idx, 0, 127), 1))


def test_lane_gather_rejects_non_128_lanes():
    with pytest.raises(ValueError, match="128 lanes"):
        ck.lane_gather(torch.zeros(8, 64), torch.zeros(8, 64,
                                                       dtype=torch.int32))


# --------------------------------------------------------------------------
# K6: fused preprocess
# --------------------------------------------------------------------------

_MEAN = (0.485, 0.456, 0.406)
_STD = (0.229, 0.224, 0.225)


@pytest.mark.parametrize("shape,out_hw,norm", [
    ((96, 128, 3), (64, 64), (_MEAN, _STD)),
    ((37, 53, 3), (50, 81), (_MEAN, _STD)),           # upsampling, odd
    ((64, 128, 3), (64, 128), ((0.0,) * 3, (1.0,) * 3)),
])
def test_fused_preprocess_plain_matches_pallas_interpret(shape, out_hw, norm):
    """Against fused_preprocess_pallas (interpret mode). Both run the two
    band products in float32; they differ by the summation order and FMA
    use of two products with at most two non-zero terms each, and of the
    epilogue: atol 1e-5 in normalised units (values reach ±2.7)."""
    img = _img(27, shape)
    ref = np.asarray(pk.fused_preprocess_pallas(
        jnp.asarray(img), out_hw[0], out_hw[1], *norm))
    got = ck.fused_preprocess(tensor(img), out_hw[0], out_hw[1],
                              *norm).numpy()
    assert got.shape == (3,) + out_hw and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("shape,out_hw", [((96, 128, 3), (64, 64)),
                                          ((37, 53, 3), (50, 81)),
                                          ((9, 7, 3), (1, 1))])
def test_fused_preprocess_two_tap_form_matches_plain(shape, out_hw):
    """The CUDA kernel's arithmetic (two taps per pass, every op rounded
    on its own) against the dense products: the same sums up to their
    rounding, atol 2e-6 (a few ULP at |x| <= 2.7)."""
    img = tensor(_img(28, shape))
    plain = ck._fused_preprocess_plain(img, *out_hw, _MEAN, _STD)
    taps = ck._fused_preprocess_taps(img, *out_hw, _MEAN, _STD)
    np.testing.assert_allclose(taps.numpy(), plain.numpy(), rtol=0,
                               atol=2e-6)


@pytest.mark.parametrize("n_in,n_out", [(1080, 640), (97, 131), (53, 53),
                                        (7, 1), (2, 9)])
def test_resize_taps_rebuild_the_matrix(n_in, n_out):
    """The taps are the non-zero entries of the bilinear matrix rows, so
    border rows (clamped and merged taps) agree exactly."""
    from kornia_tpu_torch.ops.resize import _resize_matrix
    idx, wt = ck._resize_taps(n_in, n_out)
    m = np.zeros((n_out, n_in), np.float32)
    for i in range(n_out):
        m[i, idx[i, 0]] += wt[i, 0]
        m[i, idx[i, 1]] += wt[i, 1]
    np.testing.assert_array_equal(m, _resize_matrix(n_in, n_out))
    assert (idx[:, 0] <= idx[:, 1]).all()


# --------------------------------------------------------------------------
# K10: ORB's selection of every level
# --------------------------------------------------------------------------


def _kitti_shapes(n_levels=8, scale=1.2):
    """The pyramid shapes orb._pyramid makes of a 376 x 1241 frame."""
    return tuple((int(round(376 / scale ** i)), int(round(1241 / scale ** i)))
                 for i in range(n_levels))


def test_orb_select_plan_at_kitti_and_euroc():
    """The slots a level at OrbConfig() on KITTI's frame (level 0: 396
    cells of 3, 1,188 slots; level 7: 30 of 9) and at SlamConfig()'s ORB on
    EuRoC's (4 levels of 1000 features: at most 924 slots a level)."""
    cfg = torb.OrbConfig()
    plan = torb.orb_select_plan(_kitti_shapes(), tuple(torb._level_budgets(
        cfg)), cfg.cell_size)
    assert plan[0] == (396, 3) and plan[-1] == (30, 9)
    assert max(c * p for c, p in plan) == 1188
    euroc = tuple((int(round(480 / 1.2 ** i)), int(round(752 / 1.2 ** i)))
                  for i in range(4))
    budgets = tuple(torb._level_budgets(torb.OrbConfig(n_features=1000,
                                                       n_levels=4)))
    plan = torb.orb_select_plan(euroc, budgets, 35)
    assert max(c * p for c, p in plan) <= 924
    # every level of both sorts in shared memory
    assert all(2 * b <= c * p <= torb.ORB_SELECT_SHARED_SORT
               for (c, p), b in zip(plan, budgets))


@pytest.mark.parametrize("shapes,budgets,cell,fits", [
    (((35, 35),), (8192,), 35, True),        # 1 cell x 16,384 slots
    (((35, 35),), (8193,), 35, True),        # 16,386: a global-memory sort
    (((35, 35),), (1 << 23,), 35, True),     # 2^24 slots
    (((35, 35),), ((1 << 23) + 1,), 35, False),
    (((90, 90),), (50,), 45, True),          # 2025 pixels a cell
    (((92, 92),), (50,), 46, False),         # 2116 > 2048
    (_kitti_shapes(32, 1.05), (10,) * 32, 35, True),
    (_kitti_shapes(33, 1.05), (10,) * 33, 35, False),
    (((376, 1241), (0, 10)), (10, 10), 35, False),
    (((376, 1241),), (10, 10), 35, False),
])
def test_orb_select_plan_capacity(shapes, budgets, cell, fits):
    """K10 takes a frame only within its capacity: at most
    ORB_SELECT_MAX_LEVELS levels, cells of at most 2048 pixels, no empty
    level, at most ORB_SELECT_MAX_SLOTS slots a level."""
    plan = torb.orb_select_plan(shapes, budgets, cell)
    assert (plan is not None) == fits


@pytest.mark.parametrize("rescore", [True, False])
def test_orb_select_plan_counts_the_composition_slots(rescore):
    """cells x per_cell of each level is the length of the composition's
    candidate list (fast.cell_candidates), which the kernel sorts."""
    cfg = torb.OrbConfig(n_features=600, n_levels=4, harris_rescore=rescore)
    levels = torb._pyramid(tensor(_img(40, (120, 200))), cfg)
    budgets = torb._level_budgets(cfg)
    plan = torb.orb_select_plan(tuple(tuple(lv.shape) for lv in levels),
                                tuple(budgets), cfg.cell_size)
    maps = tfast.fast_harris_levels(levels, cfg.fast_threshold_low)
    for lv, (s, h), b, (cells, per_cell) in zip(levels, maps, budgets, plan):
        xy, score = tfast.cell_candidates(lv, s, h, b, cfg.cell_size,
                                          cfg.fast_threshold_high, rescore)
        assert xy.shape == (cells * per_cell, 2)
        assert score.shape == (cells * per_cell,)


@pytest.mark.parametrize("budget,keys", [(8192, 0), (8193, 32768)])
def test_orb_select_scratch_holds_the_global_sort(budget, keys):
    """K10's scratch on one 35 x 35 level: 8 bytes a cell and a slot, and
    for a level of more than ORB_SELECT_SHARED_SORT slots its sort keys
    (8 bytes each, the next power of two over its slots)."""
    *_, words = torb._select_table(((35, 35),), (budget,), 35)
    assert words == 2 * (1 + 2 * budget) + 2 * keys


@pytest.mark.parametrize("shapes,budgets,cell", [
    (((92, 92),), (50,), 46),
    (((35, 35),), ((1 << 23) + 1,), 35),
    (_kitti_shapes(33, 1.05), (10,) * 33, 35),
])
def test_orb_select_table_raises_over_capacity(shapes, budgets, cell):
    """Shapes K10 cannot take raise, as the other wrappers do; ORB takes
    no other route on the card."""
    with pytest.raises(ValueError, match="cannot take"):
        torb._select_table(shapes, budgets, cell)


def test_orb_select_plain_rejects_unmatched_lists():
    levels = [tensor(_img(41, (40, 60)))]
    maps = tfast.fast_harris_levels(levels, 7.0)
    with pytest.raises(ValueError, match="a level"):
        torb.orb_select(levels, maps, [10, 10], 35, 20.0)
    with pytest.raises(ValueError, match="a level"):
        torb.orb_select([], [], [], 35, 20.0)


def test_new_wrappers_count_no_cpu_launch():
    ck.reset_launch_counts()
    img, xy = _frame_and_keypoints(29, 40, 60, 5)
    ck.windows(tensor(img), tensor(xy))
    ck.lane_gather(torch.zeros(3, 128), torch.zeros(3, 128,
                                                    dtype=torch.int32))
    ck.lane_gather(torch.zeros(6, 128), torch.zeros(2, 128,
                                                    dtype=torch.int32))
    ck.fused_preprocess(tensor(_img(30, (20, 30, 3))), 8, 8)
    tfast._score_dispatch(tensor(_img(31, (20, 30))), 10.0, 9)
    levels = [tensor(_img(32, (40, 60))), tensor(_img(33, (33, 50)))]
    torb.orb_select(levels, tfast.fast_harris_levels(levels, 7.0), [20, 12],
                    35, 20.0)
    torb.orb_describe(levels, [torch.zeros((20, 2)), torch.zeros((12, 2))],
                      torch.zeros((256, 4), dtype=torch.int32))
    torb.orb_pyramid(levels[0], 4, 1.2)
    assert all(v == 0 for v in ck.LAUNCHES.values())
    assert len(ck.SOURCES) == 12
    assert set(ck.LAUNCHES) == set(ck.KERNELS) == set(ck.SOURCES) | {
        "fast_score", "brief_rotated", "shear_y"}


# --------------------------------------------------------------------------
# package boundary
# --------------------------------------------------------------------------


def test_port_imports_neither_jax_nor_reference():
    code = (
        "import sys, importlib, pkgutil\n"
        "import kornia_tpu_torch\n"
        "for m in pkgutil.walk_packages(kornia_tpu_torch.__path__,\n"
        "                                'kornia_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules\n"
        "       if m == 'jax' or m.startswith(('jax.', 'kornia_tpu.'))\n"
        "       or m == 'kornia_tpu']\n"
        "assert not bad, bad\n"
        "import torch\n"
        "assert not torch.backends.cuda.matmul.allow_tf32\n"
        "assert not torch.backends.cudnn.allow_tf32\n"
        "assert torch.get_float32_matmul_precision() == 'highest'\n"
        "print('ok')\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=root)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
    # chip_smoke.py, read without running it: no import of jax or of the
    # JAX package anywhere in it (top level or inside a function)
    import ast
    with open(os.path.join(root, "chip_smoke.py")) as f:
        tree = ast.parse(f.read())
    imported = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            imported.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            imported.add(node.module)
    assert "kornia_tpu_torch" in {m.split(".")[0] for m in imported}
    bad = {m for m in imported if m.split(".")[0] in ("jax", "kornia_tpu")}
    assert not bad, bad


def _imports(path, root):
    """(module, inside a function) of every import statement of the
    source file at ``path`` under ``root``: a relative import resolved
    against its package, ``from P import m`` counted as an import of P
    and of P.m."""
    import ast
    with open(path) as f:
        tree = ast.parse(f.read())
    package = os.path.relpath(os.path.dirname(path), root).split(os.sep)
    found = []

    def visit(node, in_fn):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.Import):
                found.extend((a.name, in_fn) for a in child.names)
            elif isinstance(child, ast.ImportFrom):
                base = child.module or ""
                if child.level:
                    up = package[:len(package) - child.level + 1]
                    base = ".".join(up + ([base] if base else []))
                found.append((base, in_fn))
                found.extend((f"{base}.{a.name}", in_fn) for a in child.names)
            visit(child, in_fn or isinstance(
                child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)))

    visit(tree, False)
    return found


def test_kernel_layer_imports_nothing_above_it():
    """The port's imports point one way, features/ -> ops/: no module
    under kornia_tpu_torch/ops/ imports kornia_tpu_torch.features, at its
    top or inside a function, and features/fast.py, responses.py and
    orb.py import ops.cuda_kernels at their top only."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    pkg = os.path.join(root, "kornia_tpu_torch")
    ops_files = [os.path.join(d, f)
                 for d, _, files in os.walk(os.path.join(pkg, "ops"))
                 for f in sorted(files) if f.endswith(".py")]
    assert os.path.join(pkg, "ops", "cuda_kernels.py") in ops_files
    up = [(os.path.relpath(p, root), m) for p in ops_files
          for m, _ in _imports(p, root)
          if m.split(".")[:2] == ["kornia_tpu_torch", "features"]]
    assert not up, up
    for name in ("fast.py", "responses.py", "orb.py"):
        path = os.path.join(pkg, "features", name)
        found = _imports(path, root)
        assert ("kornia_tpu_torch.ops.cuda_kernels", False) in found, name
        late = [m for m, in_fn in found
                if in_fn and m == "kornia_tpu_torch.ops.cuda_kernels"]
        assert not late, (name, late)


def test_cuda_entry_point_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CUDA entry point runs")
    from kornia_tpu_torch.features import orb
    with pytest.raises(RuntimeError, match="device='cpu'"):
        orb.orb_detect_and_describe(_img(14, (64, 64)))
