"""K11 (``cuda_kernels.orb_describe``): ORB's paired describe stage of every
level in one call.

On the CPU the wrapper runs its plain version, features/orb.py's paired
composition; these tests hold it to that composition as the parent ran it,
check the wrapper's arguments and shape table, and hold a model of the
kernel's own arithmetic (``_kernel_model``: the window mapping, segments,
tile and passes of ``csrc/orb_describe.cu`` in numpy, the int32 moments)
to the plain version. The kernel itself is held to the plain version on
the card by tests/test_torch_cuda.py.
"""

import functools

import numpy as np
import pytest
import torch

from kornia_tpu_torch import convert
from kornia_tpu_torch.features import fast as tfast
from kornia_tpu_torch.features import orb
from kornia_tpu_torch.ops import cuda_kernels as ck
from kornia_tpu_torch.ops.filters import gaussian_blur, gaussian_kernel1d

torch.set_num_threads(1)

tensor = functools.partial(convert.tensor, device="cpu")

# the kernel's constants (csrc/orb_describe.cu)
_WIN_H, _CY, _CX, _HALF_W, _PAD_X, _RAD = 40, 20, 32, 64, 64, 3
_TILE_W = _HALF_W + 2 * _RAD


def _textured(seed, shape):
    """Blocky noise (4-px cells) plus pixel noise: many FAST corners."""
    rng = np.random.default_rng(seed)
    h, w = shape
    blocks = rng.integers(0, 256, ((h + 3) // 4, (w + 3) // 4))
    img = np.kron(blocks, np.ones((4, 4)))[:h, :w]
    return np.clip(img + rng.normal(0, 12, (h, w)), 0, 255).astype(np.uint8)


def _composition(levels, xys, pattern):
    """The paired describe as features/orb.py::_describe ran it before
    K11: casts, blurs, rounding, both canvases, orientation, BRIEF."""
    grays_f = [img.to(torch.float32) for img in levels]
    blurs = [gaussian_blur(g, (7, 7), 2.0) for g in grays_f]
    xy_ints = [torch.round(xy).to(torch.int32) for xy in xys]
    ang = orb.orientation_from_windows_paired(
        orb._extract_windows_packed_paired(grays_f, xy_ints))
    canvas, starts = ck.prepare_window_canvas(blurs)
    xy = torch.cat([x + torch.tensor([0, s], dtype=torch.int32)[None]
                    for x, s in zip(xy_ints, starts)]).contiguous()
    windows = ck.windows_paired(canvas, xy,
                                max(int(b.shape[1]) for b in blurs))
    return ang, ck.brief_rotated(windows, torch.cos(ang), torch.sin(ang),
                                 pattern, "paired")


def _kernel_model(levels, xys, pattern):
    """csrc/orb_describe.cu's arithmetic in numpy, keypoint by keypoint:
    the row-to-level mapping and its segments, the reflected u8 tile, the
    vertical pass into (40, 70) f32, the int32 moments, the rotated taps
    and the horizontal pass at each tap (every product and sum rounded to
    f32). atan2, cos and sin are torch's, on the per-half (K/2,) moments
    as orientation_from_windows_paired calls them. Returns (angle, bits,
    m10, m01)."""
    imgs = [lv.numpy() for lv in levels]
    hs = [a.shape[0] for a in imgs]
    ws = [a.shape[1] for a in imgs]
    row0 = np.cumsum([0] + [h + _WIN_H for h in hs]).tolist()
    hsum, wimg = row0[-1], max(ws)
    kp0 = np.cumsum([0] + [int(x.shape[0]) for x in xys]).tolist()
    xy = torch.cat(list(xys)).numpy()
    taps = gaussian_kernel1d(7, 2.0)
    k = xy.shape[0]

    def reflect(i, n):
        if n == 1:
            return 0
        p = 2 * (n - 1)
        i %= p
        return p - i if i > n - 1 else i

    def level_of(bounds, v):
        return int(np.searchsorted(np.asarray(bounds[1:-1]), v, "right"))

    m10 = np.zeros(k, np.int64)
    m01 = np.zeros(k, np.int64)
    per_kp = []
    for kp in range(k):
        l0 = level_of(kp0, kp)
        cx = min(max(int(np.rint(xy[kp, 0])), 0), wimg - 1)
        cy = min(max(int(np.rint(xy[kp, 1])) + row0[l0], 0), hsum - 1)
        lvl, lr = [], []
        for r in range(_WIN_H):
            row = min(cy + r, hsum - 1)
            lv = level_of(row0, row)
            lvl.append(lv)
            lr.append(min(max(row - row0[lv] - _CY, 0), hs[lv] - 1))
        # segments: runs of one level; tile rows lo - 3 .. hi + 3 each
        segs, row_tile, row_seg, base = [], [], [], 0
        for r in range(_WIN_H):
            if not segs or lvl[r] != segs[-1][0]:
                if segs:
                    base += lr[r - 1] - segs[-1][1] + 7
                segs.append((lvl[r], lr[r], base,
                             min(max(cx, 0), ws[lvl[r]] - 1)))
            row_seg.append(len(segs) - 1)
            row_tile.append(base + lr[r] - segs[-1][1])
        assert len(segs) <= 2
        n_rows = base + lr[-1] - segs[-1][1] + 7
        assert n_rows <= _WIN_H + 12
        tile = np.zeros((n_rows, _TILE_W), np.float32)
        for tr in range(n_rows):
            s = 1 if len(segs) > 1 and tr >= segs[1][2] else 0
            lv, lo, b0, xa = segs[s]
            y = reflect(lo - _RAD + tr - b0, hs[lv])
            for b in range(_TILE_W):
                tile[tr, b] = imgs[lv][y, reflect(xa - _RAD - _CX + b,
                                                  ws[lv])]
        vert = np.zeros((_WIN_H, _TILE_W), np.float32)
        for r in range(_WIN_H):
            v = tile[row_tile[r]] * taps[0]
            for t in range(1, 7):
                v = v + tile[row_tile[r] + t] * taps[t]
            vert[r] = v

        def column(s, dx, segs=segs, cx=cx):
            lv, _, _, xa = segs[s]
            if cx + dx >= ws[lv] + _PAD_X:
                return None
            return min(max(cx + dx, 0), ws[lv] - 1) - xa

        for dy in range(-15, 16):
            for dx in range(-15, 16):
                if dx * dx + dy * dy > 225:
                    continue
                r = _CY + dy
                c = column(row_seg[r], dx)
                if c is None:
                    continue
                v = int(tile[row_tile[r] + _RAD, c + _RAD + _CX])
                m10[kp] += v * dx
                m01[kp] += v * dy
        per_kp.append((cx, vert, row_seg, column))
    assert np.abs(m10).max(initial=0) < 2 ** 24
    f10 = torch.from_numpy(m10.astype(np.float32))
    f01 = torch.from_numpy(m01.astype(np.float32))
    ang = torch.stack([torch.atan2(f01[h::2].contiguous(),
                                   f10[h::2].contiguous()) for h in (0, 1)],
                      dim=1).reshape(-1)
    cos, sin = torch.cos(ang).numpy(), torch.sin(ang).numpy()
    pat = pattern.numpy().astype(np.float32)
    bits = np.zeros((k, 256), np.uint8)
    for kp, (cx, vert, row_seg, column) in enumerate(per_kp):
        c, s = np.float32(cos[kp]), np.float32(sin[kp])
        vals = []
        for px, py in ((pat[:, 0], pat[:, 1]), (pat[:, 2], pat[:, 3])):
            ddx = np.rint(px * c - py * s).astype(np.int64)
            ddy = np.rint(px * s + py * c).astype(np.int64)
            dxs = np.clip(_CX + ddx, 0, _HALF_W - 1) - _CX
            rs = np.clip(_CY + ddy, 0, _WIN_H - 1)
            out = np.zeros(256, np.float32)
            for j in range(256):
                b = column(row_seg[rs[j]], int(dxs[j]))
                if b is None:
                    continue
                src = vert[rs[j], b + _CX: b + _CX + 7]
                v = src[0] * taps[0]
                for t in range(1, 7):
                    v = v + src[t] * taps[t]
                out[j] = v
            vals.append(out)
        bits[kp] = vals[0] < vals[1]
    return ang, torch.from_numpy(bits), m10, m01


def _frame_case(seed, shape, cfg):
    """A textured frame's pyramid and K10's selection (its plain version)
    with ``cfg``'s budgets."""
    levels = orb._pyramid(tensor(_textured(seed, shape)), cfg)
    maps = tfast.fast_harris_levels(levels, cfg.fast_threshold_low)
    sels = orb.orb_select(levels, maps, orb._level_budgets(cfg),
                          cfg.cell_size, cfg.fast_threshold_high,
                          cfg.harris_rescore)
    return levels, [xy for xy, _, _ in sels]


def _border_xys(levels, seed, per_level=6):
    """Keypoints of every level at its corners and edges, beyond them
    (negative, past the last row and column: the canvas clips these, and
    they reach the zero padding of a narrow level or the next level's
    rows) and inside, with fractional parts (half-way cases too)."""
    rng = np.random.default_rng(seed)
    out = []
    for lv in levels:
        h, w = lv.shape
        pts = [(0, 0), (w - 1, h - 1), (0, h - 1), (w - 1, 0),
               (-7, h + 25), (w + 70, -3), (w + 40, h + 10), (2.5, 3.5),
               (w - 1.5, h / 2)]
        pts += [(rng.uniform(-40, w + 80), rng.uniform(-30, h + 45))
                for _ in range(per_level)]
        out.append(torch.tensor(pts, dtype=torch.float32))
    return out


_PATTERN = {name: torch.from_numpy(orb._resolve_pattern(name, 1))
            for name in ("rublee2011", "seeded")}


@pytest.mark.parametrize("case", ["kitti_crop", "euroc_slam", "odd_budget"])
def test_orb_describe_plain_equals_the_composition(case):
    """The wrapper's plain version is the paired composition, bit for bit:
    KITTI's 8 levels on a crop, SlamConfig()'s 1000 x 4 at a reduced
    EuRoC size, and a budget whose level sums are odd (pairs that straddle
    two levels)."""
    cfg = {"kitti_crop": orb.OrbConfig(n_features=400),
           "euroc_slam": orb.OrbConfig(n_features=1000, n_levels=4),
           "odd_budget": orb.OrbConfig(n_features=302, n_levels=5)}[case]
    shape = {"kitti_crop": (188, 620), "euroc_slam": (240, 376),
             "odd_budget": (150, 200)}[case]
    levels, xys = _frame_case(50, shape, cfg)
    if case == "odd_budget":
        assert any(int(x.shape[0]) % 2 for x in xys)
    pattern = _PATTERN[cfg.pattern]
    got = orb.orb_describe(levels, xys, pattern)
    want = _composition(levels, xys, pattern)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_orb_describe_plain_at_borders_equals_the_composition():
    """Keypoints at level borders and beyond them, every level."""
    cfg = orb.OrbConfig(n_features=300, n_levels=6)
    levels = orb._pyramid(tensor(_textured(51, (90, 140))), cfg)
    xys = _border_xys(levels, 52)
    got = orb.orb_describe(levels, xys, _PATTERN["seeded"])
    want = _composition(levels, xys, _PATTERN["seeded"])
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("pattern", ["rublee2011", "seeded"])
def test_orb_describe_kernel_model_equals_the_plain_version(pattern):
    """The kernel's arithmetic (``_kernel_model``) gives the plain
    version's angles and bits on a frame's keypoints, on keypoints at and
    beyond every level's border and on levels of 1 and 2 rows or columns
    (reflect-101 at n = 1 and 2, levels narrower than the window); with
    the seeded pattern (seed 1: a tap at +20 rows, the row clamp at 40)."""
    cfg = orb.OrbConfig(n_features=40, n_levels=3)
    levels, xys = _frame_case(53, (70, 96), cfg)
    tiny = [tensor(_textured(54, s)) for s in ((1, 9), (5, 1), (2, 2))]
    border = _border_xys(levels + tiny, 55, per_level=1)
    levels, xys = levels + tiny, [torch.cat([a, b]) for a, b in zip(
        xys + [torch.zeros((0, 2))] * 3, border)]
    if sum(int(x.shape[0]) for x in xys) % 2:
        xys[-1] = xys[-1][:-1]
    pat = _PATTERN[pattern]
    if pattern == "seeded":
        assert int(np.abs(pat[:, [1, 3]].numpy()).max()) == 14
    ang, bits, _, _ = _kernel_model(levels, xys, pat)
    want = orb.orb_describe(levels, xys, pat)
    assert torch.equal(ang, want[0])
    assert torch.equal(bits, want[1])


@pytest.mark.parametrize("patch", ["all_255", "half_plane_x", "half_plane_y",
                                   "quadrant", "textured"])
def test_orb_describe_int_moments_equal_the_f32_sums(patch):
    """The kernel's int32 moments equal the composition's f32 torch.sum of
    the same terms (patches · mask · offsets) on extreme patches: every
    term is an integer of magnitude at most 255 · 15 and every partial sum
    stays under 2^24, so the f32 sums are exact in any order."""
    yy, xx = np.mgrid[-60:61, -60:61]
    img = {"all_255": np.full(xx.shape, 255),
           "half_plane_x": np.where(xx > 0, 255, 0),
           "half_plane_y": np.where(yy < 0, 255, 0),
           "quadrant": np.where((xx > 0) & (yy > 0), 255, 0),
           "textured": _textured(56, xx.shape)}[patch].astype(np.uint8)
    level = tensor(img)
    xy = torch.tensor([[60.0, 60.0], [61.0, 59.0]])
    _, _, m10, m01 = _kernel_model([level], [xy], _PATTERN["rublee2011"])
    patches = torch.stack([level[y - 15: y + 16, x - 15: x + 16]
                           for x, y in ((60, 60), (61, 59))]).float()
    mask = torch.from_numpy(orb._circular_mask())
    offs = torch.arange(-15, 16, dtype=torch.float32)
    f10 = torch.sum(patches * mask * offs[None, None, :], dim=(1, 2))
    f01 = torch.sum(patches * mask * offs[None, :, None], dim=(1, 2))
    assert f10.tolist() == m10.astype(np.float64).tolist()
    assert f01.tolist() == m01.astype(np.float64).tolist()
    if patch == "half_plane_x":
        yy15, xx15 = np.mgrid[-15:16, -15:16]
        inside = (xx15 * xx15 + yy15 * yy15 <= 225) & (xx15 > 0)
        assert m10[0] == 255 * int(xx15[inside].sum()) and m01[0] == 0


def test_orb_describe_table_at_kitti():
    """The shape table at KITTI's pyramid: hs, ws and budgets as the kernel
    reads them, one per pyramid shape (cached); more than
    ORB_SELECT_MAX_LEVELS levels or an empty level raise."""
    cfg = orb.OrbConfig()
    shapes = tuple((int(round(376 / 1.2 ** i)), int(round(1241 / 1.2 ** i)))
                   for i in range(8))
    budgets = tuple(orb._level_budgets(cfg))
    hs, ws, bs = orb._describe_table(shapes, budgets)
    assert list(hs) == [h for h, _ in shapes]
    assert list(ws) == [w for _, w in shapes]
    assert list(bs) == list(budgets) and sum(bs) == 2000
    assert orb._describe_table(shapes, budgets)[0] is hs
    many = ((20, 30),) * (orb.ORB_SELECT_MAX_LEVELS + 1)
    with pytest.raises(ValueError, match="levels"):
        orb._describe_table(many, (2,) * len(many))
    with pytest.raises(ValueError, match="empty level"):
        orb._describe_table(((20, 30), (0, 15)), (2, 2))


def test_orb_describe_rejects_bad_arguments():
    """Unmatched lists, an xy that is not (B, 2), a level that is not 2-D,
    an odd keypoint count and a pattern that is not (256, 4) raise on the
    CPU as on the card; a CPU call launches nothing."""
    levels = [tensor(_textured(57, (40, 60))), tensor(_textured(58, (33, 50)))]
    xys = [torch.zeros((4, 2)), torch.zeros((2, 2))]
    pat = _PATTERN["rublee2011"]
    ck.reset_launch_counts()
    ang, bits = orb.orb_describe(levels, xys, pat)
    assert ang.shape == (6,) and bits.shape == (6, 256)
    assert all(v == 0 for v in ck.LAUNCHES.values())
    with pytest.raises(ValueError, match="a level"):
        orb.orb_describe(levels, xys[:1], pat)
    with pytest.raises(ValueError, match="a level"):
        orb.orb_describe([], [], pat)
    with pytest.raises(ValueError, match=r"\(B, 2\)"):
        orb.orb_describe(levels, [torch.zeros((4, 3)), xys[1]], pat)
    with pytest.raises(ValueError, match=r"\(H, W\)"):
        orb.orb_describe([levels[0][None], levels[1]], xys, pat)
    with pytest.raises(ValueError, match="even"):
        orb.orb_describe(levels, [torch.zeros((3, 2)), xys[1]], pat)
    with pytest.raises(ValueError, match="256, 4"):
        orb.orb_describe(levels, xys, pat[:128])


def test_describe_span_names_its_route():
    """``features.orb.describe`` carries ``"composed"`` on the CPU, in
    every describe form (``"fused"`` is the card's paired route)."""
    from kornia_tpu_torch.utils import tracing
    gray = _textured(60, (64, 96))
    cfg = orb.OrbConfig(n_features=60, n_levels=3)
    for form in ("auto", "unpaired", "gather"):
        with tracing.recording() as rows:
            orb.orb_detect_and_describe(gray, cfg, device="cpu",
                                        describe=form)
        assert [r.attr for r in rows
                if r.name == "features.orb.describe"] == ["composed"]


def test_canvas_offsets_and_mask_are_cached_constants():
    """The canvas keypoints of every level take the offsets from one
    cached constant (no upload after the first call), equal to adding
    each level's first canvas row; the centroid mask is one tensor a
    device."""
    from kornia_tpu_torch.ops import filters
    xys = [torch.tensor([[1, 2], [3, 4]], dtype=torch.int32),
           torch.tensor([[5, 6]], dtype=torch.int32)]
    starts = [0, 100, 150]
    got = orb._canvas_xy(xys, starts)
    assert got.dtype == torch.int32
    assert got.tolist() == [[1, 2], [3, 4], [5, 106]]
    before = filters.const_on.cache_info().hits
    orb._canvas_xy(xys, starts)
    assert filters.const_on.cache_info().hits == before + 1
    dev = torch.device("cpu")
    assert orb._circular_mask_on(dev) is orb._circular_mask_on(dev)
    assert torch.equal(orb._circular_mask_on(dev),
                       torch.from_numpy(orb._circular_mask()))


def test_orb_route_unchanged_by_k11_on_the_cpu():
    """orb_detect_and_describe on the CPU (paired, K11's plain version)
    equals the same frame with _describe's paired branch run as the
    composition, every output."""
    gray = _textured(61, (120, 180))
    cfg = orb.OrbConfig(n_features=500, n_levels=5)
    got = orb.orb_detect_and_describe(gray, cfg, device="cpu")
    levels = orb._pyramid(tensor(gray), cfg)
    maps = tfast.fast_harris_levels(levels, cfg.fast_threshold_low)
    sels = orb.orb_select(levels, maps, orb._level_budgets(cfg),
                          cfg.cell_size, cfg.fast_threshold_high,
                          cfg.harris_rescore)
    ang, desc = _composition(levels, [xy for xy, _, _ in sels],
                             _PATTERN[cfg.pattern])
    assert torch.equal(got.angle, ang) and torch.equal(got.descriptors, desc)
