"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Every test is marked ``cuda`` and skips without one (the kernels have
no CPU mode). This file imports neither jax nor kornia_tpu, so on a GPU
machine without JAX it runs without the repo's conftest:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest
"""

import numpy as np
import pytest
import torch

from kornia_tpu_torch import convert
from kornia_tpu_torch.ops import cuda_kernels as ck

_SHAPES = [(60, 80), (50, 67), (42, 56)]


@pytest.fixture
def cuda_dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _img(seed, shape):
    return np.random.default_rng(seed).integers(0, 256, shape, np.uint8)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(480, 752), (134, 210), (37, 45),
                                   (5, 7), (1, 1), (2, 9)])
def test_cuda_fast_harris_bit_equal(cuda_dev, shape):
    """Score, NMS and Harris maps bit-equal to the plain version, borders
    included (the kernel keeps the reference padding and op order)."""
    img = convert.tensor(_img(10, shape), cuda_dev)
    ck.reset_launch_counts()
    s_k, h_k = ck.fast_harris(img, 7.0)
    s_p, h_p = ck._fast_harris_plain(img, 7.0)
    torch.cuda.synchronize()
    assert ck.LAUNCHES["fast_harris"] == 1
    assert torch.equal(s_k, s_p) and torch.equal(h_k, h_p)


# around the 32 x 16 tile and the 4-px halo: 16k ± 1 rows, 32k ± 1 columns
_EDGE_SHAPES = [(1, 1), (7, 7), (15, 31), (17, 33), (16, 32), (31, 63),
                (33, 65), (49, 95), (47, 97)]


@pytest.mark.cuda
@pytest.mark.parametrize("shapes", [
    [(33, 65)], [(1, 1)], [(49, 95), (7, 7), (17, 33)], _EDGE_SHAPES[1:],
    [(480, 752), (400, 627), (333, 522), (278, 435), (231, 363),
     (193, 302), (161, 252), (134, 210)]])
def test_cuda_fast_harris_levels_bit_equal(cuda_dev, shapes):
    """All levels in one launch: every level bit-equal to the plain version
    and to its one-level call, borders included; 1, 3 and 8 levels; one
    level a view that starts off a 16-byte boundary."""
    rng = np.random.default_rng(30)
    levels = [convert.tensor(rng.integers(0, 256, s).astype(np.uint8),
                             cuda_dev) for s in shapes]
    h, w = shapes[0]
    buf = convert.tensor(rng.integers(0, 256, h * w + 5).astype(np.uint8),
                         cuda_dev)
    levels[0] = buf[3:3 + h * w].view(h, w)
    ck.reset_launch_counts()
    got = ck.fast_harris_levels(levels, 7.0)
    torch.cuda.synchronize()
    assert ck.LAUNCHES["fast_harris"] == 1 and len(got) == len(levels)
    for (s_k, h_k), lv in zip(got, levels):
        s_p, h_p = ck._fast_harris_plain(lv, 7.0)
        s_1, h_1 = ck.fast_harris(lv, 7.0)
        torch.cuda.synchronize()
        assert s_k.shape == lv.shape and s_k.is_contiguous()
        assert torch.equal(s_k, s_p) and torch.equal(h_k, h_p), lv.shape
        assert torch.equal(s_k, s_1) and torch.equal(h_k, h_1), lv.shape


@pytest.mark.cuda
@pytest.mark.parametrize("n_levels,launches", [(8, 1), (16, 1), (17, 2),
                                                (33, 3)])
def test_cuda_fast_harris_levels_launch_per_16_levels(cuda_dev, n_levels,
                                                      launches):
    """Any number of levels, in one launch per 16: every level bit-equal
    to the plain version and to its one-level call."""
    rng = np.random.default_rng(31)
    shapes = [(max(8, 120 - 4 * i), max(9, 150 - 5 * i))
              for i in range(n_levels)]
    levels = [convert.tensor(rng.integers(0, 256, s).astype(np.uint8),
                             cuda_dev) for s in shapes]
    ck.reset_launch_counts()
    got = ck.fast_harris_levels(levels, 7.0)
    torch.cuda.synchronize()
    assert ck.LAUNCHES["fast_harris"] == launches and len(got) == n_levels
    for (s_k, h_k), lv in zip(got, levels):
        s_p, h_p = ck._fast_harris_plain(lv, 7.0)
        s_1, h_1 = ck.fast_harris(lv, 7.0)
        torch.cuda.synchronize()
        assert torch.equal(s_k, s_p) and torch.equal(h_k, h_p), lv.shape
        assert torch.equal(s_k, s_1) and torch.equal(h_k, h_1), lv.shape


@pytest.mark.cuda
@pytest.mark.parametrize("n_levels,launches", [(8, 1), (17, 2)])
def test_cuda_orb_levels_launch_k1_per_16(cuda_dev, n_levels, launches):
    """ORB on the card: 8 levels launch K1 once, 17 levels twice (16, then
    1); the features equal those of the route with one K1 launch per
    level (``_select_level(..., maps=None)``)."""
    from kornia_tpu_torch.features import orb
    rng = np.random.default_rng(32)
    small = rng.random((30, 40))
    gray = (np.kron(small, np.ones((8, 8))) * 255).astype(np.uint8)
    cfg = orb.OrbConfig(n_features=400, n_levels=n_levels, scale_factor=1.1)
    ck.reset_launch_counts()
    got = orb.orb_detect_and_describe(gray, cfg)
    torch.cuda.synchronize()
    assert ck.LAUNCHES["fast_harris"] == launches
    levels = orb._pyramid(convert.tensor(gray, cuda_dev), cfg)
    sels = [orb._select_level(lv, b, cfg) for lv, b in
            zip(levels, orb._level_budgets(cfg))]
    assert torch.equal(got.xy, torch.cat([s[0] * cfg.scale_factor ** i
                                          for i, s in enumerate(sels)]))
    assert torch.equal(got.score, torch.cat([s[1] for s in sels]))
    assert torch.equal(got.mask, torch.cat([s[2] for s in sels]))
    saved = ck.fast_harris_levels
    try:
        ck.fast_harris_levels = lambda lvs, thr: [saved([lv], thr)[0]
                                                  for lv in lvs]
        per_level = orb.orb_detect_and_describe(gray, cfg)
    finally:
        ck.fast_harris_levels = saved
    for name in got._fields:
        assert torch.equal(getattr(got, name), getattr(per_level, name)), \
            name


@pytest.mark.cuda
def test_cuda_fast_harris_levels_reject_bad_input(cuda_dev):
    lv = torch.zeros((20, 30), dtype=torch.uint8, device=cuda_dev)
    with pytest.raises(ValueError, match="one device"):
        ck.fast_harris_levels([lv, lv.cpu()], 7.0)
    with pytest.raises(ValueError):
        ck.fast_harris_levels([lv, lv.float()], 7.0)
    ck.reset_launch_counts()
    empty = ck.fast_harris_levels([lv[:0], lv[:, :0]], 7.0)
    assert ck.LAUNCHES["fast_harris"] == 0
    assert [tuple(s.shape) for s, _ in empty] == [(0, 30), (20, 0)]


@pytest.mark.cuda
@pytest.mark.parametrize("k", [16, 15])
def test_cuda_windows_and_taps_bit_equal(cuda_dev, k):
    """Paired windows (odd K, border keypoints, pairs across levels) and
    BRIEF taps bit-equal to the plain versions."""
    rng = np.random.default_rng(11)
    frames = [convert.tensor(_img(12 + i, s).astype(np.float32), cuda_dev)
              for i, s in enumerate(_SHAPES)]
    canvas, starts = ck.prepare_window_canvas(frames)
    xys = []
    for (h, w), s, n in zip(_SHAPES, starts, (k - 9, 5, 4)):
        xy = np.stack([rng.integers(0, w, n), rng.integers(0, h, n)], 1)
        xy[0] = (0, 0)
        xy[1] = (w - 1, h - 1)
        xys.append(xy + np.array([0, s]))
    xy = convert.tensor(np.concatenate(xys).astype(np.int32), cuda_dev)
    w_k = ck.windows_paired(canvas, xy, 80)
    assert torch.equal(w_k, ck._windows_paired_plain(canvas, xy, 80))
    rows = convert.tensor(rng.integers(0, 40, (w_k.shape[0], 1024))
                          .astype(np.int32), cuda_dev)
    cols = convert.tensor(rng.integers(0, 128, (w_k.shape[0], 1024))
                          .astype(np.int32), cuda_dev)
    assert torch.equal(ck.brief_sample(w_k, rows, cols),
                       ck._brief_sample_plain(w_k, rows, cols))


@pytest.mark.cuda
def test_cuda_wrappers_reject_bad_input(cuda_dev):
    img = convert.tensor(_img(13, (32, 32)), cuda_dev)
    with pytest.raises(ValueError):
        ck.fast_harris(img.to(torch.float32), 7.0)
    with pytest.raises(ValueError):
        ck.fast_harris(img.t(), 7.0)       # not contiguous
    win = torch.zeros((2, 40, 128), device=cuda_dev)
    idx = torch.zeros((2, 1024), dtype=torch.int64, device=cuda_dev)
    with pytest.raises(ValueError):
        ck.brief_sample(win, idx, idx)


def _smooth_maps(h, w, ho, wo, seed):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:ho, 0:wo].astype(np.float32)
    r2 = ((xx - wo / 2) / wo) ** 2 + ((yy - ho / 2) / ho) ** 2
    mx = xx * (w / wo) + 40.0 * r2 * (xx - wo / 2) / wo
    my = yy * (h / ho) + 40.0 * r2 * (yy - ho / 2) / ho
    # exact .5 and integer coordinates, and samples far outside
    mx[0, :8] = np.array([-3.0, -1.5, -0.5, 0.5, 2.5, w - 0.5, w + 0.7, 1e7])
    my[1, :4] = np.array([-1e7, h - 1.0, h - 0.5, 3.5])
    mx += rng.uniform(-0.25, 0.25, mx.shape).astype(np.float32) * (
        np.arange(ho)[:, None] % 3 == 2)
    return mx.astype(np.float32), my.astype(np.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["data", "affine", "persp"])
@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
@pytest.mark.parametrize("shape,out_hw", [((75, 170, 1), (61, 133)),
                                          ((37, 45, 3), (80, 96))])
def test_cuda_remap_bit_equal(cuda_dev, form, dtype, shape, out_hw):
    """K7 against its plain version: every map form, nearest and bilinear,
    zeros (with a fill) and border padding, u8 and f32, odd sizes,
    samples at exact .5, on the edge and far outside."""
    rng = np.random.default_rng(14)
    img = rng.integers(0, 256, shape).astype(dtype)
    if dtype == np.float32:
        img = img * np.float32(0.37) + rng.random(shape).astype(np.float32)
    x = convert.tensor(img, cuda_dev)
    ho, wo = out_hw
    mx = my = coefs = None
    if form == "data":
        mx, my = (convert.tensor(a, cuda_dev)
                  for a in _smooth_maps(shape[0], shape[1], ho, wo, 15))
    elif form == "affine":
        coefs = torch.tensor([0.94, -0.34, 20.5, 0.34, 0.94, -12.25, 0, 0, 1])
    else:
        hinv = np.array([[1.02, 0.05, -4.0], [0.02, 0.98, 3.0],
                         [1e-3, -8e-4, 1.0]])
        coefs = torch.tensor(hinv.reshape(9), dtype=torch.float32)
    for mode in ("bilinear", "nearest"):
        for pad, fill in (("zeros", 0.0), ("zeros", 17.25), ("border", 0.0)):
            kw = dict(coefs=coefs, map_x=mx, map_y=my,
                      nearest=mode == "nearest", border=pad == "border",
                      fill=fill)
            ck.reset_launch_counts()
            got = ck.remap(x, out_hw, form, **kw)
            want = ck._remap_plain(x, out_hw, form, **kw)
            torch.cuda.synchronize()
            assert ck.LAUNCHES["remap"] == 1
            assert got.dtype == x.dtype and got.shape == want.shape
            assert torch.equal(got, want), (mode, pad, fill)


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,out_w,kap,aligned", [
    (3, 203, 203 + 214 + 8, 0.57735, True),     # out_w % 4 == 1
    (3, 203, 203 + 214 + 8, -1.05, True),
    (1, 203, 203 + 214 + 8, 1.7, True),
    (3, 256, 548, 0.57735, True),               # cc and out_w % 4 == 0
    (1, 256, 548, -1.05, True),
    (3, 256, 100, 0.57735, True),               # out_w < cc
    (1, 200, 37, 0.3, True),                    # out_w < cc, % 4 == 1
    (3, 256, 548, 3.1, True),                   # shifts beyond out_w
    (1, 256, 548, -3.1, True),
    (3, 256, 548, 0.57735, False),              # base off 16 bytes
    (1, 203, 421, -1.05, False),
    (2, 64, 1500, 0.57735, True)])              # several steps a row
def test_cuda_lane_shift_bit_equal(cuda_dev, b, s, out_w, kap, aligned):
    """K8 against its plain version, one launch per call: both slope
    signs, batches of 1 and 3, output widths that are and are not a
    multiple of 4 and narrower than the source, shifts that push rows past
    either end of the output, and a source whose base is off a 16-byte
    boundary (a contiguous view into a larger buffer)."""
    rng = np.random.default_rng(16)
    flat = convert.tensor(rng.random(b * s * s + 1).astype(np.float32),
                          cuda_dev)
    off = 0 if aligned else 1
    src = flat[off:off + b * s * s].view(b, s, s)
    assert src.is_contiguous() and (src.data_ptr() % 16 == 0) == aligned
    sh = np.floor(np.float32(kap) * np.arange(s, dtype=np.float32))
    sh = convert.tensor((sh - sh.min() - 5).astype(np.int32), cuda_dev)
    if b == 1:
        src = src[0]
    ck.reset_launch_counts()
    got = ck.lane_shift(src, sh, out_w)
    want = ck._lane_shift_plain(src, sh, out_w)
    torch.cuda.synchronize()
    assert ck.LAUNCHES["lane_shift"] == 1
    assert got.shape == src.shape[:-1] + (out_w,)
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_cuda_shear_x_bit_equal(cuda_dev):
    """K9 against its plain version: a batch of three channels, fractional
    shifts of both signs, exact integers, and rows past ±slack (zero)."""
    rng = np.random.default_rng(17)
    c = 512
    img = convert.tensor(rng.standard_normal((3, c, c)).astype(np.float32),
                         cuda_dev)
    ys = np.arange(c, dtype=np.float32)
    for shifts in (0.3 * ys - 40.0, -0.414 * ys + 60.7,
                   np.full(c, 33.0, np.float32), 2.0 * ys - 400.0):
        sh = convert.tensor(shifts.astype(np.float32), cuda_dev)
        ck.reset_launch_counts()
        got = ck.shear_x(img, sh)
        want = ck._shear_x_plain(img, sh)
        torch.cuda.synchronize()
        assert ck.LAUNCHES["shear_x"] == 1
        assert torch.equal(got, want)


def _shear_shifts(c, rng):
    """Shift sets of the shear passes and beyond: slopes of both signs,
    exact integers, rows past ±slack (zero), a spread too wide to stage in
    the column mode, and random shifts of any size."""
    ys = np.arange(c, dtype=np.float32)
    slack = c // 4 + 192
    wild = rng.uniform(-1.5 * slack, 1.5 * slack, c)
    return [0.42 * ys - 60.3, -0.7071 * ys + 140.5,
            np.full(c, 33.0), np.where(ys % 7 == 3, slack + 5.5, -3.25),
            2.0 * ys - 400.0, wild, np.floor(wild)]


@pytest.mark.cuda
@pytest.mark.parametrize("c", [250, 256, 512])
@pytest.mark.parametrize("b", [1, 3])
def test_cuda_shear_row_and_column_modes_bit_equal(cuda_dev, c, b):
    """K9's row mode (shear_x) and column mode (shear_y) against their
    plain versions: widths that are and are not a multiple of 4, a batch,
    invalid rows and columns, wild shifts, a canvas off a 16-byte
    boundary (scalar loads and stores)."""
    rng = np.random.default_rng(31)
    img = convert.tensor(rng.standard_normal((b, c, c)).astype(np.float32),
                         cuda_dev)
    buf = torch.zeros(b * c * c + 1, device=cuda_dev)
    off = buf[1:].view(b, c, c)
    off.copy_(img)
    for shifts in _shear_shifts(c, rng):
        sh = convert.tensor(shifts.astype(np.float32), cuda_dev)
        for x in (img, off, img[0]):
            ck.reset_launch_counts()
            row = ck.shear_x(x, sh)
            col = ck.shear_y(x, sh)
            torch.cuda.synchronize()
            assert ck.LAUNCHES["shear_x"] == ck.LAUNCHES["shear_y"] == 1
            assert torch.equal(row, ck._shear_x_plain(x, sh))
            assert torch.equal(col, ck._shear_y_plain(x, sh))
            assert torch.equal(col, ck._shear_x_plain(
                x.transpose(-1, -2).contiguous(), sh).transpose(-1, -2))


@pytest.mark.cuda
def test_cuda_warp_entry_points_launch_kernels(cuda_dev):
    """The entry points reach the kernels: rectify/remap/warp_affine/
    warp_perspective/undistort_image one K7 launch each, the shear route
    four K9 row and two K9 column launches (three channels batched)."""
    from kornia_tpu_torch.geometry import camera, stereo
    from kornia_tpu_torch.ops import interpolation, warp
    img = _img(18, (60, 80, 3))
    k = np.array([[70.0, 0, 40.0], [0, 70.0, 30.0], [0, 0, 1]])
    dist = np.array([-0.28, 0.07, 0.0002, -0.0001, 0.001])
    rect = stereo.StereoRectifier.from_calib(
        k, dist, k, dist, (60, 80), np.eye(3), np.array([-0.11, 0.0, 0.0]))
    m = np.array([[0.9, -0.2, 5.0], [0.2, 0.9, -3.0]], np.float32)
    mx, my = camera.generate_correction_map_polynomial(k, dist, (60, 80))
    ck.reset_launch_counts()
    outs = [rect.rectify_left(img[..., 0]), rect.rectify_right(img[..., 1]),
            interpolation.remap(img, mx, my),
            warp.warp_affine(img, m, (50, 70)),
            warp.warp_perspective(img, np.eye(3), (50, 70)),
            camera.undistort_image(img, k, dist)]
    torch.cuda.synchronize()
    assert ck.LAUNCHES["remap"] == len(outs)
    assert all(o.dtype == torch.uint8 and o.is_cuda for o in outs)
    ck.reset_launch_counts()
    out = warp.warp_affine(img, m, (50, 70), method="shear")
    torch.cuda.synchronize()
    assert ck.LAUNCHES["shear_x"] == 4 and ck.LAUNCHES["shear_y"] == 2
    assert out.shape == (50, 70, 3)


def _border_keypoints(rng, h, w, k):
    """k int32 keypoints in an (h, w) frame, the first on all four borders
    and corners, two outside the frame."""
    xy = np.stack([rng.integers(0, w, k), rng.integers(0, h, k)], 1)
    fixed = [(0, 0), (w - 1, h - 1), (w - 1, 0), (0, h - 1), (w // 2, 0),
             (0, h // 2), (w - 1, h // 3), (w // 3, h - 1), (-7, 5),
             (w + 30, h + 9)]
    n = min(k, len(fixed))
    xy[:n] = np.asarray(fixed[:n], xy.dtype).reshape(n, 2)
    return xy.astype(np.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [0, 1, 7, 64])
@pytest.mark.parametrize("shape,layout", [((97, 131), (48, 24, 64)),
                                          ((60, 80), (24, 8, 64)),
                                          ((5, 9), (48, 24, 64))])
def test_cuda_windows_bit_equal(cuda_dev, k, shape, layout):
    """K4 on a single frame against its plain version: K = 0, 1, odd;
    keypoints on all four borders and outside; a frame smaller than the
    window; both window layouts."""
    rng = np.random.default_rng(19)
    img = convert.tensor(rng.standard_normal(shape).astype(np.float32),
                         cuda_dev)
    xy = convert.tensor(_border_keypoints(rng, *shape, k), cuda_dev)
    ck.reset_launch_counts()
    got = ck.windows(img, xy, *layout)
    want = ck._windows_plain(img, xy, *layout)
    torch.cuda.synchronize()
    assert ck.LAUNCHES["windows"] == (1 if k else 0)
    assert got.shape == (k, layout[0], 128) and torch.equal(got, want)


@pytest.mark.cuda
def test_cuda_windows_packed_canvas_bit_equal(cuda_dev):
    """K4 on the level-stacked canvas: each keypoint reads its own level."""
    rng = np.random.default_rng(20)
    frames = [convert.tensor(_img(21 + i, s).astype(np.float32), cuda_dev)
              for i, s in enumerate(_SHAPES)]
    canvas, starts = ck.prepare_window_canvas(frames, 48, 24)
    xys = [_border_keypoints(rng, h, w, 8)[:8] + np.array([0, s], np.int32)
           for (h, w), s in zip(_SHAPES, starts)]
    for i, (h, w) in enumerate(_SHAPES):      # keep them inside their level
        xys[i][:, 0] = np.clip(xys[i][:, 0], 0, w - 1)
        xys[i][:, 1] = np.clip(xys[i][:, 1], starts[i], starts[i] + h - 1)
    xy = convert.tensor(np.concatenate(xys).astype(np.int32), cuda_dev)
    got = ck.windows(canvas, xy, 48, prepared=(starts[-1], 80))
    assert torch.equal(got, ck._windows_plain(canvas, xy, 48,
                                              prepared=(starts[-1], 80)))
    for i, f in enumerate(frames):            # and equal to per-level calls
        lvl = xy[8 * i: 8 * i + 8] - torch.tensor(
            [0, starts[i]], dtype=torch.int32, device=cuda_dev)
        assert torch.equal(got[8 * i: 8 * i + 8],
                           ck.windows(f, lvl.contiguous()))


@pytest.mark.cuda
@pytest.mark.parametrize("src_off,idx_off", [(0, 0), (1, 0), (0, 3)])
@pytest.mark.parametrize("g", [1, 48])
@pytest.mark.parametrize("n", [0, 1, 5, 513, 4801])
def test_cuda_lane_gather_bit_equal(cuda_dev, n, g, src_off, idx_off):
    """K5 against its plain version and torch.gather on the clipped,
    expanded indices: n index rows, each serving g source rows (g = 1 the
    general mode, g = 48 the broadcast mode the describe uses), n not a
    multiple of anything, indices outside [0, 127], and a source or index
    whose base is off a 16-byte boundary (a contiguous view at a flat
    offset into a larger buffer). The broadcast call equals the general
    call on the expanded index."""
    rng = np.random.default_rng(22)
    src = convert.tensor(rng.standard_normal(n * g * 128 + src_off).astype(
        np.float32), cuda_dev)[src_off:].view(n * g, 128)
    idx = convert.tensor(rng.integers(-4, 132, n * 128 + idx_off).astype(
        np.int32), cuda_dev)[idx_off:].view(n, 128)
    if n:
        assert src.is_contiguous() and idx.is_contiguous()
        assert (src.data_ptr() % 16 == 0) == (src_off == 0)
        assert (idx.data_ptr() % 16 == 0) == (idx_off == 0)
    full = idx.repeat_interleave(g, 0)
    ck.reset_launch_counts()
    got = ck.lane_gather(src, idx)
    torch.cuda.synchronize()
    assert ck.LAUNCHES["lane_gather"] == (1 if n else 0)
    assert torch.equal(got, ck._lane_gather_plain(src, idx))
    assert torch.equal(got, ck._lane_gather_plain(src, full))
    assert torch.equal(got, torch.gather(src, 1, full.long().clamp(0, 127)))
    assert torch.equal(got, ck.lane_gather(src, full))


@pytest.mark.cuda
@pytest.mark.parametrize("shape,out_hw", [
    ((96, 128, 3), (64, 64)), ((37, 53, 3), (50, 81)), ((9, 7, 3), (1, 1)),
    ((1, 1, 3), (4, 5)), ((1080, 1920, 3), (360, 640))])
def test_cuda_fused_preprocess(cuda_dev, shape, out_hw):
    """K6: bit-equal to its own arithmetic written in PyTorch ops (two
    taps per pass, every op rounded on its own), and within 2e-6 of the
    plain version's dense float32 products (their summation rounding);
    outputs larger than the input and 1×1 sizes included."""
    mean, std = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)
    img = convert.tensor(_img(23, shape), cuda_dev)
    ck.reset_launch_counts()
    got = ck.fused_preprocess(img, *out_hw, mean, std)
    torch.cuda.synchronize()
    assert ck.LAUNCHES["preprocess"] == 1
    assert got.shape == (3,) + out_hw and got.dtype == torch.float32
    assert torch.equal(got, ck._fused_preprocess_taps(img, *out_hw, mean,
                                                      std))
    plain = ck._fused_preprocess_plain(img, *out_hw, mean, std)
    assert float((got - plain).abs().max()) <= 2e-6


@pytest.mark.cuda
def test_cuda_new_wrappers_reject_bad_input(cuda_dev):
    img = torch.zeros((20, 30), device=cuda_dev)
    xy = torch.zeros((3, 2), dtype=torch.int32, device=cuda_dev)
    with pytest.raises(ValueError):
        ck.windows(img, xy.long())
    with pytest.raises(ValueError):
        ck.windows(img.double(), xy)
    with pytest.raises(ValueError):
        ck.windows(img, xy.cpu())
    with pytest.raises(ValueError, match="128 lanes"):
        ck.lane_gather(torch.zeros((4, 64), device=cuda_dev),
                       torch.zeros((4, 64), dtype=torch.int32,
                                   device=cuda_dev))
    with pytest.raises(ValueError):
        ck.lane_gather(torch.zeros((4, 128), device=cuda_dev),
                       torch.zeros((4, 128), dtype=torch.int64,
                                   device=cuda_dev))
    with pytest.raises(ValueError, match="do not divide"):
        ck.lane_gather(torch.zeros((96, 128), device=cuda_dev),
                       torch.zeros((5, 128), dtype=torch.int32,
                                   device=cuda_dev))
    with pytest.raises(ValueError):
        ck.fused_preprocess(torch.zeros((8, 8, 3), device=cuda_dev), 4, 4)
    with pytest.raises(ValueError):
        ck.fused_preprocess(torch.zeros((8, 8, 4), dtype=torch.uint8,
                                        device=cuda_dev), 4, 4)


@pytest.mark.cuda
def test_cuda_slice3_entry_points_launch_kernels(cuda_dev):
    """The entry points of the third slice reach the kernels with the
    counts the describe forms and LK methods imply."""
    import dataclasses
    from kornia_tpu_torch.features import orb, responses
    from kornia_tpu_torch.ops import optical_flow as flow
    from kornia_tpu_torch.ops import preprocess as pp
    rng = np.random.default_rng(24)
    small = rng.random((22, 28))
    gray = (np.kron(small, np.ones((8, 8))) * 255).astype(np.uint8)
    cfg = orb.OrbConfig(n_features=200, n_levels=3)

    def run(fn):
        ck.reset_launch_counts()
        out = fn()
        torch.cuda.synchronize()
        return out, {k: v for k, v in ck.LAUNCHES.items() if v}

    paired, n = run(lambda: orb.orb_detect_and_describe(gray, cfg))
    assert n == {"fast_harris": 1, "windows_paired": 2, "brief_rotated": 1}
    unp, n = run(lambda: orb.orb_detect_and_describe(gray, cfg,
                                                     describe="unpaired"))
    assert n == {"fast_harris": 1, "windows": 2, "brief_rotated": 1}
    assert torch.equal(unp.descriptors, paired.descriptors)
    assert torch.equal(unp.angle, paired.angle)
    lg, n = run(lambda: orb.orb_detect_and_describe(gray, cfg,
                                                    brief="lane_gather"))
    assert n == {"fast_harris": 1, "windows": 2, "lane_gather": 4}
    assert torch.equal(lg.descriptors, paired.descriptors)
    odd, n = run(lambda: orb.orb_detect_and_describe(
        gray, dataclasses.replace(cfg, n_features=201)))
    assert n == {"fast_harris": 1, "windows": 2, "brief_rotated": 1}
    assert odd.descriptors.shape == (201, 256)
    _, n = run(lambda: orb.orb_detect_and_describe_quadtree(gray, cfg))
    # the quadtree's per-level detection runs K1's score-only entry
    assert n == {"fast_score": 3, "windows": 6, "brief_rotated": 3}
    xy = torch.round(paired.xy[paired.octave == 0]).to(torch.int32)
    _, n = run(lambda: responses.harris_at_windows(
        torch.as_tensor(gray, device=cuda_dev).float(), xy))
    assert n == {"windows": 1}

    nxt = np.roll(gray, 2, axis=1)
    pts = paired.xy[paired.mask & (paired.octave == 0)][:50]
    params = flow.PyrLKParams(window=15, max_level=1)
    for method in ("auto", "taps", "windows", "gather"):
        stats = {}
        res, n = run(lambda: flow.calc_optical_flow_pyr_lk(
            gray, nxt, pts, params, method=method, stats=stats))
        want = {"taps": 4 * 2 + sum(stats["iterations"]), "windows": 4 * 2,
                "gather": 0}[stats["method"]]
        assert n.get("windows", 0) == want and res.points.is_cuda
        cpu = flow.calc_optical_flow_pyr_lk(gray, nxt, pts.cpu(), params,
                                            method=stats["method"],
                                            device="cpu")
        ok = res.status.cpu() & cpu.status
        assert ok.sum() >= 10
        assert float((res.points.cpu() - cpu.points)[ok].abs().max()) < 0.05
    assert stats["method"] == "gather"

    img = _img(25, (90, 120, 3))
    out, n = run(lambda: pp.resize_normalize_to_tensor(
        img, pp.PreprocessorConfig(out_size=(64, 64),
                                   resize_mode=pp.ResizeMode.LETTERBOX)))
    assert n == {"preprocess": 1} and out.shape == (1, 3, 64, 64)


# --------------------------------------------------------------------------
# K7 with four pixels per thread, word-wise row stores, device coefs
# --------------------------------------------------------------------------


def _remap_inputs(form, h, w, ho, wo, dev, seed=15):
    mx = my = coefs = None
    if form == "data":
        mx, my = (convert.tensor(a, dev)
                  for a in _smooth_maps(h, w, ho, wo, seed))
    elif form == "affine":
        coefs = torch.tensor([0.94, -0.34, 20.5, 0.34, 0.94, -12.25, 0, 0, 1])
    else:
        coefs = torch.tensor([1.02, 0.05, -4.0, 0.02, 0.98, 3.0, 1e-3, -8e-4,
                              1.0])
    return dict(coefs=coefs, map_x=mx, map_y=my)


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["data", "affine", "persp"])
@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
@pytest.mark.parametrize("c", [1, 3, 4])
@pytest.mark.parametrize("wo", [31, 128, 132, 133, 135, 260])
def test_cuda_remap_row_copy_bit_equal(cuda_dev, form, dtype, c, wo):
    """K7 against its plain version: C = 1 and 3 (rows copied out of the
    shared tile word by word) and 4 (direct stores); output widths under
    one tile, of exactly one, 4n, 4n+1 and 4n+3 wide (rows of u8 outputs
    that do not start on a 4-byte boundary, a ragged right edge) and over
    two tiles; every form, mode and padding."""
    rng = np.random.default_rng(26)
    shape = (75, 170, c)
    img = rng.integers(0, 256, shape).astype(dtype)
    if dtype == np.float32:
        img = img * np.float32(0.37) + rng.random(shape).astype(np.float32)
    x = convert.tensor(img, cuda_dev)
    out_hw = (61, wo)
    maps = _remap_inputs(form, 75, 170, *out_hw, cuda_dev)
    for nearest in (False, True):
        for border, fill in ((False, 0.0), (False, 17.25), (True, 0.0)):
            kw = dict(nearest=nearest, border=border, fill=fill, **maps)
            ck.reset_launch_counts()
            got = ck.remap(x, out_hw, form, **kw)
            want = ck._remap_plain(x, out_hw, form, **kw)
            torch.cuda.synchronize()
            assert ck.LAUNCHES["remap"] == 1
            assert got.dtype == x.dtype and got.shape == want.shape
            assert torch.equal(got, want), (nearest, border, fill)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
@pytest.mark.parametrize("c", [1, 3])
def test_cuda_remap_views_and_wild_maps_bit_equal(cuda_dev, dtype, c):
    """A data map that leaves the image on every side; a wild map (random
    source positions, so neighbouring pixels share no taps); an image and
    maps that start off a 16-byte boundary (slices of larger buffers)."""
    rng = np.random.default_rng(27)
    h, w, ho, wo = 90, 121, 70, 200
    big = rng.integers(0, 256, h * w * c + 7).astype(dtype)
    x = convert.tensor(big, cuda_dev)[3:3 + h * w * c].reshape(h, w, c)
    yy, xx = np.mgrid[0:ho, 0:wo].astype(np.float32)
    leave_x = xx * (w + 40.0) / wo - 20.0 + 0.01 * yy
    leave_y = yy * (h + 40.0) / ho - 20.0 - 0.02 * xx
    wild_x = rng.uniform(-5, w + 5, (ho, wo)).astype(np.float32)
    wild_y = rng.uniform(-5, h + 5, (ho, wo)).astype(np.float32)
    for mx, my in ((leave_x, leave_y), (wild_x, wild_y)):
        flat = np.concatenate([np.zeros(1, np.float32), mx.ravel(),
                               my.ravel()]).astype(np.float32)
        t = convert.tensor(flat, cuda_dev)          # maps 4 bytes off 16
        tx = t[1:1 + ho * wo].reshape(ho, wo)
        ty = t[1 + ho * wo:].reshape(ho, wo)
        for nearest in (False, True):
            for border in (False, True):
                kw = dict(map_x=tx, map_y=ty, nearest=nearest, border=border,
                          fill=3.5)
                got = ck.remap(x, (ho, wo), "data", **kw)
                want = ck._remap_plain(x, (ho, wo), "data", **kw)
                torch.cuda.synchronize()
                assert torch.equal(got, want), (nearest, border)


@pytest.mark.cuda
def test_cuda_remap_device_coefficients(cuda_dev):
    """Coefficients as a CUDA tensor: the kernel reads them from device
    memory, the call does not wait for the device, and a warp_affine whose
    matrix was made on the card equals the one with the same matrix on the
    host bit for bit (coefficients too). warp_perspective inverts on the
    card; its coefficients may differ from the host inverse in the last
    bits, and kernel and plain version agree on the same coefficients."""
    from kornia_tpu_torch.ops import warp, warp_exact
    img = convert.tensor(_img(28, (120, 160, 3)), cuda_dev)
    worst = 0
    for ang, sc in ((10.0, 1.0), (30.0, 1.0), (-73.0, 0.6), (179.0, 1.3)):
        m_dev = warp.get_rotation_matrix2d((85.0, 37.5), ang, sc,
                                           device=cuda_dev)
        m_host = m_dev.cpu()
        c_dev = warp_exact.affine_coefs(m_dev)
        assert c_dev.is_cuda
        assert torch.equal(c_dev.cpu(), warp_exact.affine_coefs(m_host))
        ck.reset_launch_counts()
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            on_card = warp.warp_affine(img, m_dev, (100, 150))
        finally:
            torch.cuda.set_sync_debug_mode("default")
        from_host = warp.warp_affine(img, m_host, (100, 150))
        torch.cuda.synchronize()
        assert ck.LAUNCHES["remap"] == 2
        assert torch.equal(on_card, from_host)

        hom = torch.eye(3, device=cuda_dev)
        hom[:2] = m_dev
        hom[2, :2] = torch.tensor([2e-4, -1.5e-4], device=cuda_dev)
        c_host = torch.linalg.inv(hom.cpu()).reshape(9)
        c_card = torch.linalg.inv_ex(hom).inverse.reshape(9)
        ulp = (c_card.cpu().view(torch.int32)
               - c_host.view(torch.int32)).abs().max()
        worst = max(worst, int(ulp))
        got = warp.warp_perspective(img, hom, (100, 150))
        kw = dict(coefs=c_card)
        assert torch.equal(got, ck.remap(img, (100, 150), "persp", **kw))
        assert torch.equal(got, ck._remap_plain(img, (100, 150), "persp",
                                                **kw))
    print(f"perspective coefficients, card inverse vs host inverse: at most "
          f"{worst} ULP apart")
    assert worst <= 64


# --------------------------------------------------------------------------
# K3 with the rotation, the clamps and the compare fused in
# --------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("pattern,seed", [("rublee2011", 7), ("seeded", 7),
                                          ("seeded", 1)])
@pytest.mark.parametrize("layout,k", [("paired", 0), ("paired", 2),
                                      ("paired", 64), ("unpaired", 0),
                                      ("unpaired", 7), ("unpaired", 64)])
def test_cuda_brief_rotated_bit_equal(cuda_dev, pattern, seed, layout, k):
    """brief_rotated against its plain version, bits and samples, and its
    samples against the index form (_brief_tap_coords + brief_sample):
    both layouts, the learned and two seeded patterns (seed 1 has the
    (14, 14) tap that reaches the paired layout's row clip), an odd K on
    the unpaired layout, K = 0."""
    from kornia_tpu_torch.features import orb
    rng = np.random.default_rng(29)
    paired = layout == "paired"
    wh = 40 if paired else 48
    win = convert.tensor(rng.standard_normal(
        (k // 2 if paired else k, wh, 128)).astype(np.float32), cuda_dev)
    ang = convert.tensor(rng.uniform(-np.pi, np.pi, k).astype(np.float32),
                         cuda_dev)
    if k:
        ang[:2] = torch.tensor([0.0, np.pi / 4], device=cuda_dev)
    pat = orb._pattern_on(pattern, seed, cuda_dev)
    args = (win, torch.cos(ang), torch.sin(ang), pat, layout)
    ck.reset_launch_counts()
    bits = ck.brief_rotated(*args)
    samples = ck.brief_rotated(*args, out="samples")
    torch.cuda.synchronize()
    assert ck.LAUNCHES["brief_rotated"] == (2 if k else 0)
    assert ck.LAUNCHES["brief_sample"] == 0
    assert bits.shape == (k, 256) and bits.dtype == torch.uint8
    assert torch.equal(bits, ck._brief_rotated_plain(*args))
    assert torch.equal(samples, ck._brief_rotated_plain(*args,
                                                        out="samples"))
    rows, cols = orb._brief_tap_coords(ang, seed, pattern,
                                       half_w=32 if paired else None)
    if paired:
        lane = torch.tensor([0, 64], dtype=torch.int32, device=cuda_dev)
        rows = rows.reshape(k // 2, 1024)
        cols = (cols.reshape(k // 2, 2, 512)
                + lane[None, :, None]).reshape(k // 2, 1024)
    index_form = ck.brief_sample(win, rows.contiguous(), cols.contiguous())
    assert torch.equal(samples, index_form.reshape(k, 512))


@pytest.mark.cuda
def test_cuda_brief_rotated_rejects_bad_input(cuda_dev):
    from kornia_tpu_torch.features import orb
    pat = orb._pattern_on("rublee2011", 7, cuda_dev)
    win = torch.zeros((2, 40, 128), device=cuda_dev)
    c = torch.ones(4, device=cuda_dev)
    with pytest.raises(ValueError, match="do not fill"):
        ck.brief_rotated(win, c[:3], c[:3], pat, "paired")
    with pytest.raises(ValueError, match="must be"):
        ck.brief_rotated(win, c, c, pat, "unpaired")
    with pytest.raises(ValueError):
        ck.brief_rotated(win, c.double(), c.double(), pat, "paired")
    with pytest.raises(ValueError):
        ck.brief_rotated(win, c, c, pat.cpu(), "paired")
    with pytest.raises(ValueError, match="unknown layout"):
        ck.brief_rotated(win, c, c, pat, "both")
    # contiguous slices that start 4 bytes off a 16-byte boundary: refused
    # before the launch (the kernel copies 16-byte pieces), and the device
    # is still usable afterwards
    buf = torch.zeros(2 * 40 * 128 + 4, device=cuda_dev)
    off = buf[1:1 + 2 * 40 * 128].reshape(2, 40, 128)
    assert off.is_contiguous() and off.data_ptr() % 16 == 4
    with pytest.raises(ValueError, match="16-byte"):
        ck.brief_rotated(off, c, c, pat, "paired")
    pbuf = torch.zeros(256 * 4 + 4, dtype=torch.int32, device=cuda_dev)
    pbuf[1:1 + 1024] = pat.reshape(-1)
    with pytest.raises(ValueError, match="16-byte"):
        ck.brief_rotated(win, c, c, pbuf[1:1 + 1024].reshape(256, 4),
                         "paired")
    torch.cuda.synchronize()
    assert torch.equal(ck.brief_rotated(win, c, c, pat, "paired"),
                       ck._brief_rotated_plain(win, c, c, pat, "paired"))


def _track_inputs(seed=40, n_map=2000, n_frame=1024, n_seen=700):
    """A map of n_map points with random packed descriptors, padded to a
    bucket of 2048; a frame of n_frame rows: n_seen map points seen under
    a known pose (0.5 px noise, a few descriptor bits flipped), the rest
    random descriptors at random pixels; K of 480×752 EuRoC size."""
    rng = np.random.default_rng(seed)
    k = np.array([[458.654, 0.0, 367.215], [0.0, 457.296, 248.375],
                  [0.0, 0.0, 1.0]], np.float32)
    xyz = rng.uniform([-3, -2, 4], [3, 2, 8], (n_map, 3))
    desc = rng.integers(0, 256, (n_map, 32)).astype(np.uint8)
    ang = np.deg2rad([-1.5, 1.5, -0.5])
    c, s = np.cos(ang), np.sin(ang)
    r = (np.array([[c[2], -s[2], 0], [s[2], c[2], 0], [0, 0, 1]])
         @ np.array([[c[1], 0, s[1]], [0, 1, 0], [-s[1], 0, c[1]]])
         @ np.array([[1, 0, 0], [0, c[0], -s[0]], [0, s[0], c[0]]]))
    t = -r @ np.array([-0.2, 0.1, 0.1])
    seen = rng.choice(n_map, n_seen, replace=False)
    cam = xyz[seen] @ r.T + t
    px = cam[:, :2] / cam[:, 2:] * [k[0, 0], k[1, 1]] + [k[0, 2], k[1, 2]]
    fxy = rng.uniform([0, 0], [752, 480], (n_frame, 2))
    fxy[:n_seen] = px + rng.normal(0, 0.5, px.shape)
    fdesc = rng.integers(0, 256, (n_frame, 32)).astype(np.uint8)
    flips = (rng.random((n_seen, 32)) < 0.05).astype(np.uint8) << \
        rng.integers(0, 8, (n_seen, 32)).astype(np.uint8)
    fdesc[:n_seen] = desc[seen] ^ flips
    nm = 2048
    pad = nm - n_map
    return dict(
        frame_desc=fdesc, frame_mask=np.arange(n_frame) < n_frame - 24,
        frame_xy=fxy.astype(np.float32),
        map_desc=np.concatenate([desc, np.zeros((pad, 32), np.uint8)]),
        map_mask=np.arange(nm) < n_map,
        map_xyz=np.concatenate([xyz, np.zeros((pad, 3))]).astype(
            np.float32), k=k), r, t


@pytest.mark.cuda
def test_cuda_track_step_waits_for_nothing(cuda_dev):
    """track_step on card tensors under sync debug mode "error": no host
    synchronisation from the match to the last LM step (after one warm-up
    call, which may set up cuBLAS and the generator); the known pose
    within 0.1° and 0.02 units of centre."""
    from kornia_tpu_torch.slam import system as tsys
    x, r, t = _track_inputs()
    xs = {key: convert.tensor(v, cuda_dev) for key, v in x.items()}
    gen = torch.Generator(device=cuda_dev).manual_seed(0)
    tsys.track_step(**xs, generator=gen, device=cuda_dev)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = tsys.track_step(**xs, generator=gen, device=cuda_dev)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    rr = got.pose.rotation.double().cpu().numpy()
    tt = got.pose.translation.double().cpu().numpy()
    ang = np.degrees(2 * np.arcsin(min(np.linalg.norm(rr - r)
                                       / (2 * np.sqrt(2)), 1.0)))
    assert ang <= 0.1
    assert np.linalg.norm(rr.T @ tt - r.T @ t) <= 0.02
    assert int(got.n_inliers) >= 0.5 * int(got.match_mask.sum())


@pytest.mark.cuda
def test_cuda_track_step_equals_cpu_route(cuda_dev):
    """The card and the CPU route on the same inputs and the same draw
    (sample_idx from the card's generator over the card's match mask):
    match idx and mask equal (integer Hamming distances from an exact
    float32 product), R within 1e-4 rad and t within 1e-3 of the CPU's
    (reductions and cuBLAS products round differently; the LM takes both
    to the minimum of the same inlier set), n_inliers within ±2."""
    from kornia_tpu_torch.features import matching as tmatch
    from kornia_tpu_torch.geometry import ransac as transac
    from kornia_tpu_torch.slam import system as tsys
    x, _, _ = _track_inputs(41)
    m = tmatch.match_descriptors_packed(
        x["frame_desc"], x["map_desc"], x["frame_mask"], x["map_mask"],
        max_distance=64, ratio=0.8, device=cuda_dev)
    gen = torch.Generator(device=cuda_dev).manual_seed(1)
    draw = transac.sample_minimal_sets(gen, len(x["frame_mask"]), m.mask,
                                       256, 6)
    card = tsys.track_step(**x, sample_idx=draw, device=cuda_dev)
    cpu = tsys.track_step(**x, sample_idx=draw.cpu(), device="cpu")
    assert torch.equal(card.match_idx.cpu(), cpu.match_idx)
    assert torch.equal(card.match_mask.cpu(), cpu.match_mask)
    d = np.linalg.norm(card.pose.rotation.double().cpu().numpy()
                       - cpu.pose.rotation.double().numpy())
    assert 2 * np.arcsin(min(d / (2 * np.sqrt(2)), 1.0)) <= 1e-4
    np.testing.assert_allclose(card.pose.translation.cpu().numpy(),
                               cpu.pose.translation.numpy(), atol=1e-3)
    assert abs(int(card.n_inliers) - int(cpu.n_inliers)) <= 2


# ---------------------------------------------------------------------------
# the SLAM back end: BA, PGO, the vocabulary descent (plain PyTorch on the
# card; the scenes are chip_smoke.py's, at smaller sizes)
# ---------------------------------------------------------------------------


_HUBER = dict(loss="huber", loss_scale=2.0)


@pytest.mark.cuda
def test_cuda_local_ba_equals_cpu_route(cuda_dev):
    """Local BA as the SLAM loop runs it (5 keyframes, its buckets, 10
    iterations, Huber 2) on the card and on the CPU: initial cost within
    1e-4, final cost within 0.05 relative, poses within 1e-3 (the
    reference's own bound for two summation orders; the card's
    index_add_ sums with atomics in any order); every pose within 0.5°
    of the truth."""
    import chip_smoke as cs
    from kornia_tpu_torch.optim import ba
    prob, gt = cs.local_ba_problem(cuda_dev, n_pts=400)
    params = ba.BAParams(max_iterations=10, **_HUBER)
    card = ba.bundle_adjust_schur(prob, params)
    cpu = ba.bundle_adjust_schur(cs._problem_to(prob, "cpu"), params)
    assert float(card.initial_cost) == pytest.approx(
        float(cpu.initial_cost), rel=1e-4)
    assert float(card.final_cost) == pytest.approx(float(cpu.final_cost),
                                                   rel=0.05)
    assert float(card.final_cost) < float(card.initial_cost)
    np.testing.assert_allclose(card.poses.cpu().numpy(), cpu.poses.numpy(),
                               atol=1e-3)
    assert cs._max_rot_err_deg(card.poses, gt) < 0.5


@pytest.mark.cuda
@pytest.mark.parametrize("solver", ["dense", "pcg"])
def test_cuda_bundle_adjust_waits_for_nothing(cuda_dev, solver):
    """bundle_adjust_schur on a problem on the card under sync debug mode
    "error" (after one warm-up solve, which may set up cuBLAS and
    cuSOLVER): nothing in the LM loop, the Schur reduction, the
    Cholesky solve or the CG loop waits for the device."""
    import chip_smoke as cs
    from kornia_tpu_torch.optim import ba
    prob, _ = cs.synth_ba_problem(40, 600, 1, 0.2, cuda_dev)
    params = ba.BAParams(max_iterations=4, solver=solver, cg_iters=20,
                         **_HUBER)
    ba.bundle_adjust_schur(prob, params)
    res = cs._no_wait(lambda: ba.bundle_adjust_schur(prob, params))
    assert float(res.final_cost) < 0.5 * float(res.initial_cost)


@pytest.mark.cuda
def test_cuda_pgo_padded_equals_cpu_route(cuda_dev):
    """PGO on a 60-keyframe ring bucketed as the SLAM loop buckets it (64
    poses with identity padding, 128 edges with identity-measurement,
    weight-0 padding), card and CPU route: initial cost within 1e-4,
    final cost within 0.05 relative, poses within 1e-3; the padding
    stays identity and finite; under sync debug mode "error" on the
    card."""
    import chip_smoke as cs
    from kornia_tpu_torch.optim import pgo
    ring, gt = cs.pgo_ring(cuda_dev, n=60, radius=3.0)
    assert ring["poses"].shape[0] == 64 and ring["edge_i"].shape[0] == 128
    params = pgo.PGOParams(max_iterations=15)
    pgo.pose_graph_optimize(**ring, params=params)
    card = cs._no_wait(lambda: pgo.pose_graph_optimize(**ring,
                                                       params=params))
    cpu = pgo.pose_graph_optimize(**{k: v.cpu() for k, v in ring.items()},
                                  params=params)
    assert torch.isfinite(card.poses).all()
    assert float(card.initial_cost) == pytest.approx(
        float(cpu.initial_cost), rel=1e-4)
    assert float(card.final_cost) == pytest.approx(float(cpu.final_cost),
                                                   rel=0.05)
    assert float(card.final_cost) < 0.5 * float(card.initial_cost)
    np.testing.assert_allclose(card.poses.cpu().numpy(), cpu.poses.numpy(),
                               atol=1e-3)
    assert torch.equal(card.poses[len(gt):], ring["poses"][len(gt):])


@pytest.mark.cuda
def test_cuda_vocabulary_words_equal_cpu_route(cuda_dev):
    """A vocabulary built with its idf transform on the card equals the
    one built on the CPU array for array, and the descent's word ids and
    weights on the card equal the CPU route's exactly (integer XOR,
    popcount table, first argmin)."""
    from kornia_tpu_torch import bow
    rng = np.random.default_rng(50)
    desc = rng.integers(0, 256, (3000, 32), np.uint8)
    card = bow.Vocabulary.build(desc, k=6, depth=3, seed=1, device=cuda_dev)
    cpu = bow.Vocabulary.build(desc, k=6, depth=3, seed=1, device="cpu")
    for name in ("children", "node_desc", "word_id", "word_weight"):
        np.testing.assert_array_equal(getattr(card, name), getattr(cpu, name))
    q = rng.integers(0, 256, (5000, 32), np.uint8)
    for a, b in zip(card.transform_words(q), cpu.transform_words(q)):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# the SLAM frame loop (MonocularSlam.process_frame on the card; the scene is
# chip_smoke.py's out-and-back sequence, its first frames)
# ---------------------------------------------------------------------------


@pytest.mark.cuda
def test_cuda_slam_frame_loop(cuda_dev):
    """Eight 480×752 frames of chip_smoke.slam_sequence through
    MonocularSlam with SlamConfig() widths on the card: frame 0 is held,
    frame 1 bootstraps (two keyframes), every later frame is tracked;
    each frame launches K1 once, K2 twice and K3 once and no other hand
    kernel; the keyframe poses' camera centres within 0.05 of the truth
    after a sim3 alignment."""
    import chip_smoke as cs
    from kornia_tpu_torch import slam
    frames, _, centres = cs.slam_sequence(n=cs.SLAM_FRAMES)
    frames = frames[:8]
    system = slam.MonocularSlam(cs.K_EUROC, slam.SlamConfig(**cs.SLAM_LOOP_CFG),
                                device=cuda_dev)
    states = []
    for f in frames:
        torch.cuda.synchronize()
        ck.reset_launch_counts()
        states.append(system.process_frame(f).state)
        torch.cuda.synchronize()
        want = {name: 0 for name in ck.LAUNCHES}
        want.update(fast_harris=1, windows_paired=2, brief_rotated=1)
        assert dict(ck.LAUNCHES) == want
    assert states[0] == slam.TrackingState.INITIALIZING
    assert all(s == slam.TrackingState.TRACKING for s in states[1:])
    assert system.results[1].is_keyframe
    assert [kf.frame_idx for kf in system.map.keyframes][:2] == [0, 1]
    assert len(system.map.keyframes) >= 3
    assert cs.slam_ate(system, centres, cuda_dev) < 0.05


def _textured_u8(seed, shape):
    """Blocky noise (4-px cells) plus pixel noise: many FAST corners."""
    rng = np.random.default_rng(seed)
    h, w = shape
    base = rng.integers(0, 256, (h // 4 + 1, w // 4 + 1)).astype(np.float32)
    up = np.kron(base, np.ones((4, 4)))[:h, :w]
    return np.clip(up + rng.normal(0, 6, up.shape), 0, 255).astype(np.uint8)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(480, 752), (1080, 1920)])
@pytest.mark.parametrize("nms", [True, False], ids=["nms", "no-nms"])
@pytest.mark.parametrize("mask", [None, "random", "ones-on-border",
                                  "gaussian"])
def test_cuda_fast_score_bit_equal(cuda_dev, shape, nms, mask):
    """K1's score-only forms (no Harris; NMS on or off; an ROI mask under
    the XLA contract: border kill kept, mask before the NMS) bit-equal to
    the plain version, one launch each on the fast_score counter. The
    Gaussian mask has negative values, which pool against the −inf of
    the out-of-image cells as ``max_pool2d``'s padding does."""
    img = convert.tensor(_textured_u8(40, shape), cuda_dev)
    m = None
    if mask == "random":
        m = convert.tensor(np.random.default_rng(41).integers(
            0, 2, shape).astype(np.float32), cuda_dev)
    elif mask == "ones-on-border":
        m = torch.ones(shape, device=cuda_dev)
    elif mask == "gaussian":
        m = convert.tensor(np.random.default_rng(45).normal(
            size=shape).astype(np.float32), cuda_dev)
    ck.reset_launch_counts()
    got = ck.fast_score(img, 20.0, nms=nms, mask=m)
    torch.cuda.synchronize()
    assert ck.LAUNCHES["fast_score"] == 1 and ck.LAUNCHES["fast_harris"] == 0
    assert torch.equal(got, ck._fast_score_plain(img, 20.0, nms, m))
    assert int((got > 0).sum()) > 100


@pytest.mark.cuda
def test_cuda_fast_score_rejects_bad_input(cuda_dev):
    img = convert.tensor(_img(42, (40, 50)), cuda_dev)
    with pytest.raises(ValueError, match="uint8"):
        ck.fast_score(img.float(), 10.0)
    with pytest.raises(ValueError, match="mask"):
        ck.fast_score(img, 10.0, mask=torch.ones((40, 49), device=cuda_dev))
    with pytest.raises(ValueError, match="float32"):
        ck.fast_score(img, 10.0, mask=torch.ones((40, 50), device=cuda_dev,
                                                 dtype=torch.float64))


@pytest.mark.cuda
@pytest.mark.parametrize("n_levels,launches", [(8, 1), (16, 1), (17, 2)])
def test_cuda_fast_harris_levels_unchanged_by_the_score_modes(
        cuda_dev, n_levels, launches):
    """ORB's K1 still launches once per 16 levels with outputs equal to the
    plain version, and the score-only counter stays at 0."""
    rng = np.random.default_rng(43)
    levels = [convert.tensor(rng.integers(0, 256, (60 - 2 * i, 80 - 3 * i))
                             .astype(np.uint8), cuda_dev)
              for i in range(n_levels)]
    ck.reset_launch_counts()
    got = ck.fast_harris_levels(levels, 7.0)
    torch.cuda.synchronize()
    assert ck.LAUNCHES["fast_harris"] == launches
    assert ck.LAUNCHES["fast_score"] == 0
    for (s_k, h_k), lv in zip(got, levels):
        s_p, h_p = ck._fast_harris_plain(lv, 7.0)
        assert torch.equal(s_k, s_p) and torch.equal(h_k, h_p)


@pytest.mark.cuda
def test_cuda_fast_detect_waits_for_nothing_and_equals_cpu_route(cuda_dev):
    """fast_detect with and without the NMS and with an ROI mask: one K1
    score-only launch each, no host synchronisation, keypoints equal to the
    CPU route's."""
    from kornia_tpu_torch.features import fast

    gray = _textured_u8(44, (480, 752))
    mask = np.zeros(gray.shape, np.float32)
    mask[:, : int(0.6 * gray.shape[1])] = 1.0
    g = convert.tensor(gray, cuda_dev)
    m = convert.tensor(mask, cuda_dev)
    for kw in (dict(), dict(border_mask=m), dict(nms=False)):
        fast.fast_detect(g, 20.0, 2048, device="cuda", **kw)     # warm-up
        torch.cuda.synchronize()
        ck.reset_launch_counts()
        torch.cuda.set_sync_debug_mode("error")
        try:
            got = fast.fast_detect(g, 20.0, 2048, device="cuda", **kw)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        assert ck.LAUNCHES["fast_score"] == 1
        kw_cpu = {k: (v.cpu() if isinstance(v, torch.Tensor) else v)
                  for k, v in kw.items()}
        want = fast.fast_detect(gray, 20.0, 2048, device="cpu", **kw_cpu)
        for a, b in zip(got, want):
            assert torch.equal(a.cpu(), b)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(480, 752), (1080, 1920)])
@pytest.mark.parametrize("nms", [True, False], ids=["nms", "no-nms"])
@pytest.mark.parametrize("mask", [None, "gaussian"])
@pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 8, 10, 11, 12, 13, 16])
def test_cuda_fast_score_arc_lengths_bit_equal(cuda_dev, shape, nms, mask,
                                               n):
    """K1's score-only forms at arc lengths other than 9 (the FAST-n
    compiled forms of fast_score_pallas): bit-equal to the plain version at
    the same n, one launch each on the fast_score counter."""
    img = convert.tensor(_textured_u8(46, shape), cuda_dev)
    m = None
    if mask == "gaussian":
        m = convert.tensor(np.random.default_rng(47).normal(
            size=shape).astype(np.float32), cuda_dev)
    ck.reset_launch_counts()
    got = ck.fast_score(img, 20.0, nms=nms, mask=m, arc_length=n)
    torch.cuda.synchronize()
    assert ck.LAUNCHES["fast_score"] == 1 and ck.LAUNCHES["fast_harris"] == 0
    assert torch.equal(got, ck._fast_score_plain(img, 20.0, nms, m, n))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [-2, 0, 17, 40])
def test_cuda_fast_score_arc_lengths_outside_the_ring(cuda_dev, n):
    """n <= 1 computes the arc of 1 and n >= 16 the whole ring, as the
    reference's doubling reduces them: bit-equal to the plain version at
    the same n."""
    img = convert.tensor(_textured_u8(48, (120, 160)), cuda_dev)
    got = ck.fast_score(img, 5.0, nms=True, arc_length=n)
    assert torch.equal(got, ck._fast_score_plain(img, 5.0, True, None, n))
    with pytest.raises(TypeError):
        ck.fast_score(img, 5.0, arc_length=9.5)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [9, 10, 11, 12])
def test_cuda_fast_detectors_at_arc_lengths_equal_cpu_route(cuda_dev, n):
    """fast_detect, fast_detect_cells and fast_harris_cells with
    ``arc_length=n`` on the card: one K1 score-only launch each (nothing
    falls back to the CPU or raises), results equal to the CPU route (cell
    41: the in-cell row p / 41 is a true division on the card too)."""
    from kornia_tpu_torch.features import fast, responses

    gray = _textured_u8(49, (240, 320))
    g = convert.tensor(gray, cuda_dev)
    hmap = responses.harris_response(torch.as_tensor(gray).float())
    cases = (
        lambda x, d: fast.fast_detect(x, 20.0, 1024, arc_length=n, device=d),
        lambda x, d: fast.fast_detect(x, 20.0, 1024, nms=False,
                                      arc_length=n, device=d),
        lambda x, d: fast.fast_detect_cells(x, arc_length=n),
        lambda x, d: fast.fast_detect_cells(x, cell_size=41, arc_length=n),
        lambda x, d: fast.fast_harris_cells(
            x, hmap.to(x.device), arc_length=n))
    for fn in cases:
        ck.reset_launch_counts()
        got = fn(g, "cuda")
        torch.cuda.synchronize()
        assert ck.LAUNCHES["fast_score"] == 1
        want = fn(torch.as_tensor(gray), "cpu")
        for a, b in zip(got, want):
            assert torch.equal(a.cpu(), b)


# --------------------------------------------------------------------------
# AprilTag: the threshold and the dense CCL on the card, the decode
# --------------------------------------------------------------------------


def _tag_scene(shape=(480, 640)):
    """Three tag36h11 tags on blocky texture, with their quiet zones."""
    from kornia_tpu_torch import apriltag

    fam = apriltag.get_family("tag36h11")
    img = _textured_u8(71, shape)
    for i, tag_id in enumerate((3, 17, 99)):
        tag = apriltag.render_tag(fam, tag_id, scale=12)
        y, x = 60 + 110 * i, 60 + 180 * i
        img[y:y + tag.shape[0], x:x + tag.shape[1]] = tag
    return img


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(480, 640), (1080, 1920), (61, 83)])
@pytest.mark.parametrize("tile,split", [(4, 0.6), (8, 0.33)])
def test_cuda_adaptive_threshold_equals_cpu_route(cuda_dev, shape, tile,
                                                  split):
    """The threshold on the card equals its CPU route bit for bit, and
    launches no hand kernel."""
    from kornia_tpu_torch.apriltag import adaptive_threshold

    g = _textured_u8(72, shape)
    ck.reset_launch_counts()
    got = adaptive_threshold(convert.tensor(g, cuda_dev), tile, 5, split,
                             device="cuda")
    torch.cuda.synchronize()
    assert got.is_cuda and all(v == 0 for v in ck.LAUNCHES.values())
    want = adaptive_threshold(g, tile, 5, split, device="cpu")
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("connectivity", [4, 8])
@pytest.mark.parametrize("max_sweeps", [1, 64])
def test_cuda_connected_components_equals_cpu_route(cuda_dev, connectivity,
                                                    max_sweeps):
    """The dense CCL on the card: labels and sweep count equal the CPU
    route's; once converged, its partition is the host union-find's."""
    from kornia_tpu_torch.apriltag import adaptive_threshold
    from kornia_tpu_torch.ops import connected_components as ccl

    t = adaptive_threshold(_tag_scene(), device="cpu")
    mask = (t == 0).to(torch.uint8)
    got, n_got = ccl._labels_sweeps(mask.to(cuda_dev), connectivity,
                                    max_sweeps)
    want, n_want = ccl._labels_sweeps(mask, connectivity, max_sweeps)
    assert n_got == n_want and torch.equal(got.cpu(), want)
    assert torch.equal(ccl.connected_components(
        mask, connectivity, max_sweeps, device="cuda").cpu(), want)
    if n_got <= max_sweeps:
        np.testing.assert_array_equal(
            ccl.relabel_sequential(got),
            ccl.connected_components_host(mask.numpy(), connectivity))


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["native", "numpy"])
def test_cuda_decode_equals_cpu_route(cuda_dev, route, monkeypatch):
    """One 480×640 decode on the card equals the CPU route's detections,
    from a numpy array and from a device tensor (one read-back)."""
    from kornia_tpu_torch import apriltag

    monkeypatch.setenv("KORNIA_TPU_APRILTAG_MID", route)
    img = _tag_scene()
    want = apriltag.AprilTagDecoder(device="cpu").decode(img)
    assert sorted(d.tag_id for d in want) == [3, 17, 99]
    dec = apriltag.AprilTagDecoder(device="cuda")
    for inp in (img, convert.tensor(img, cuda_dev)):
        got = dec.decode(inp)
        assert [(d.tag_id, d.hamming) for d in got] == \
            [(d.tag_id, d.hamming) for d in want]
        for a, b in zip(got, want):
            assert np.array_equal(a.corners, b.corners)
            assert np.array_equal(a.homography, b.homography)


# --------------------------------------------------------------------------
# the VLM serving path (no hand kernel): the card against the CPU route
# --------------------------------------------------------------------------

# |Δ logit| between the card and the CPU route on the same weights (the
# logits are O(1); float32 sums in two orders)
VLM_CARD_TOL = 1e-4


def _tiny_vlm_models():
    from kornia_tpu_torch import models

    smol = models.VLMConfig(
        vision=models.ViTConfig(image_size=64, patch_size=16, hidden_size=64,
                                intermediate_size=128, num_layers=2,
                                num_heads=4),
        text=models.LLMConfig(vocab_size=512, hidden_size=64,
                              intermediate_size=128, num_layers=3,
                              num_heads=4, num_kv_heads=2, max_seq_len=128),
        pixel_shuffle_factor=2, image_token_id=500)
    pali = models.PaliGemmaConfig(
        vision=models.ViTConfig(image_size=28, patch_size=14, hidden_size=32,
                                intermediate_size=64, num_layers=2,
                                num_heads=2),
        text=models.GemmaConfig(vocab_size=256, hidden_size=64,
                                intermediate_size=128, num_layers=2,
                                num_heads=4, num_kv_heads=1, head_dim=32,
                                max_seq_len=64),
        image_token_id=250)
    return ((models.build_vlm, smol), (models.build_paligemma, pali))


@pytest.mark.cuda
@pytest.mark.parametrize("which", [0, 1], ids=["smolvlm", "paligemma"])
def test_cuda_vlm_generate_equals_cpu_route(cuda_dev, which):
    """A tiny SmolVLM and a tiny PaliGemma built on the card and copied to
    the CPU: prefill logits within VLM_CARD_TOL, greedy tokens and
    n_generated equal; no hand kernel launches."""
    from kornia_tpu_torch import models

    build, cfg = _tiny_vlm_models()[which]
    card = build(cfg, seed=3, device=cuda_dev)
    cpu = build(cfg, device="meta")
    cpu.to_empty(device="cpu")
    cpu.load_state_dict(card.state_dict())
    rng = np.random.default_rng(4)
    s = cfg.vision.image_size
    imgs = rng.standard_normal((2, s, s, 3)).astype(np.float32)
    toks = np.asarray([[1] + [cfg.image_token_id] * cfg.tokens_per_image
                       + rng.integers(3, 200, 4).tolist() for _ in range(2)])
    ck.reset_launch_counts()
    with torch.inference_mode():
        lg, _ = card(torch.as_tensor(toks, device=cuda_dev),
                     torch.as_tensor(imgs, device=cuda_dev),
                     models.KVCache.zeros(cfg.text, 2, device=cuda_dev))
        lc, _ = cpu(torch.as_tensor(toks), torch.as_tensor(imgs),
                    models.KVCache.zeros(cfg.text, 2, device="cpu"))
    assert float((lg.cpu() - lc).abs().max()) <= VLM_CARD_TOL
    rg = models.generate(card, toks, imgs, max_new_tokens=12, device=cuda_dev)
    rc = models.generate(cpu, toks, imgs, max_new_tokens=12, device="cpu")
    assert torch.equal(rg.tokens.cpu(), rc.tokens)
    assert torch.equal(rg.n_generated.cpu(), rc.n_generated)
    assert not any(ck.LAUNCHES.values())


# the warning of sync debug mode "warn" at a host sync (its first use
# also warns that the mode is a prototype: that is not a sync)
_SYNC = "called a synchronizing"


@pytest.mark.cuda
def test_cuda_generate_syncs_once_with_the_stream(cuda_dev):
    """A greedy request on the card with numpy inputs: no host sync in
    ``generate`` but the stream callback's one read."""
    import warnings

    from kornia_tpu_torch import models

    build, cfg = _tiny_vlm_models()[0]
    model = build(cfg, seed=3, device=cuda_dev)
    s = cfg.vision.image_size
    imgs = np.zeros((1, s, s, 3), np.float32)
    toks = np.asarray([[1] + [cfg.image_token_id] * cfg.tokens_per_image
                       + [5, 6]])
    models.generate(model, toks, imgs, max_new_tokens=4, device=cuda_dev)
    torch.cuda.synchronize()
    seen = []
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            models.generate(model, toks, imgs, max_new_tokens=8,
                            device=cuda_dev)
            n_plain = sum(_SYNC in str(w.message) for w in caught)
            models.generate(model, toks, imgs, max_new_tokens=8,
                            stream_callback=seen.append, device=cuda_dev)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    sites = [f"{w.filename}:{w.lineno}" for w in caught
             if _SYNC in str(w.message)]
    assert n_plain == 0 and len(sites) == 1, sites
    assert 1 <= len(seen) <= 8


@pytest.mark.cuda
@pytest.mark.parametrize("shape,size", [((1080, 1920, 3), 512),
                                        ((480, 752, 3), 384),
                                        ((61, 47, 3), 224)])
def test_cuda_preprocess_image_within_one_lsb(cuda_dev, shape, size):
    """``preprocess_image`` on the card within one u8 LSB of the resize of
    the CPU route (1/127.5 after the SigLIP normalisation)."""
    from kornia_tpu_torch import models

    img = _img(size, shape)
    got = models.preprocess_image(img, size, device=cuda_dev)
    want = models.preprocess_image(img, size, device="cpu")
    assert got.shape == want.shape == (1, size, size, 3)
    assert float((got.cpu() - want).abs().max()) <= 1.0 / 127.5 + 1e-6


def _parallel_world_1(mesh):
    """Every entry point of the distributed layer on one rank over NCCL:
    the sharded front end and batched matching (bit-equal to the single
    process), the exchange (rows equal to the plan's), both BA layouts
    (the keyframe one led through ``controller.lead``) and PGO, each
    within the reference's bounds for a distributed against a single-host
    solve (tests/test_ba_dist.py: cost rtol 1e-3, poses atol 5e-4, points
    atol 5e-3; tests/test_parallel2.py: PGO poses 5e-3). Raises on a
    mismatch."""
    import torch.distributed as dist

    from kornia_tpu_torch.features import matching, orb
    from kornia_tpu_torch.geometry import liegroup as lg
    from kornia_tpu_torch.optim import ba, pgo
    from kornia_tpu_torch.parallel import (ba_dist, controller, exchange,
                                           frontend_dist, pgo_dist)

    assert dist.get_backend() == "nccl" and mesh.device.type == "cuda"
    rng = np.random.default_rng(0)
    frames = rng.integers(0, 256, (2, 96, 128), np.uint8)
    cfg = orb.OrbConfig(n_features=64, n_levels=2)
    feats = frontend_dist.detect_and_describe_batch(frames, cfg, mesh)
    m = frontend_dist.match_batch(feats.descriptors, feats.descriptors[[1, 0]],
                                  feats.mask, feats.mask[[1, 0]], mesh)
    for i, f in enumerate(frames):
        one = orb.orb_detect_and_describe(f, cfg, device=mesh.device)
        assert all(torch.equal(a[i], b) for a, b in zip(feats, one))
        two = orb.orb_detect_and_describe(frames[1 - i], cfg,
                                          device=mesh.device)
        mm = matching.match_descriptors(
            one.descriptors, two.descriptors, a_mask=one.mask,
            b_mask=two.mask, max_distance=64, ratio=0.8, device=mesh.device)
        assert all(torch.equal(a[i], b) for a, b in zip(m, mm))

    cam = rng.integers(0, 5, 200).astype(np.int32)
    plan = exchange.build_exchange_plan(
        np.zeros(200, np.int64), cam, rng.integers(0, 40, 200),
        rng.random((200, 2)).astype(np.float32), 1, 40)
    rows = torch.as_tensor(exchange.host_receive_order(plan, 0, 1))
    got = exchange.exchange_observations(plan, mesh)
    assert torch.equal(got[0][0].cpu(), rows[:, 0].int())
    assert torch.equal(got[2][0].cpu(), rows[:, 2:4])

    # the dry run's scene: 6 cameras on a line, 48 points, 0.5 px noise
    k = np.array([[100.0, 0, 32], [0, 100.0, 24], [0, 0, 1]], np.float32)
    pts = rng.uniform([-1, -1, 3], [1, 1, 6], (48, 3)).astype(np.float32)
    poses = np.zeros((6, 7), np.float32)
    poses[:, 0] = 1.0
    poses[:, 4] = 0.1 * np.arange(6)
    uv = [lg.se3_apply(torch.as_tensor(p)[None], torch.as_tensor(pts))
          .numpy() for p in poses]
    uv = np.concatenate([u[:, :2] / u[:, 2:] * 100.0 + [32, 24]
                         for u in uv]) + rng.normal(0, 0.5, (288, 2))
    fixed = np.array([True, True, False, False, False, False])
    problem = ba.build_problem(
        poses, pts + rng.normal(0, 0.02, pts.shape).astype(np.float32), k,
        np.repeat(np.arange(6), 48).astype(np.int32),
        np.tile(np.arange(48), 6).astype(np.int32), uv.astype(np.float32),
        fixed_poses=fixed, device="cpu")
    params = ba.BAParams(max_iterations=10, loss="huber", loss_scale=2.0)
    single = ba.bundle_adjust_schur(
        ba.BAProblem(*(None if v is None else v.to(mesh.device)
                       for v in problem)), params)
    for res in (controller.lead(mesh, "ba_dist_kf",
                                ba_dist.shard_problem_by_keyframe(problem, 1),
                                params),
                ba_dist.bundle_adjust_schur_dist(
                    ba_dist.shard_problem(problem, 1), mesh, params)):
        assert abs(float(res.final_cost) - float(single.final_cost)) <= \
            1e-3 * float(single.final_cost)
        assert float((res.poses - single.poses).abs().max()) <= 5e-4
        assert float((res.points - single.points).abs().max()) <= 5e-3

    noisy = poses.copy()
    noisy[1:, 4:] += rng.normal(0, 0.05, (5, 3)).astype(np.float32)
    pt = torch.as_tensor(poses)
    ei = np.arange(5)
    meas = lg.se3_compose(pt[ei + 1], lg.se3_inverse(pt[ei])).numpy()
    pp = pgo.PGOParams(max_iterations=5)
    res = pgo_dist.pose_graph_optimize_dist(
        pgo_dist.shard_pgo(noisy, ei, ei + 1, meas, n_devices=1), mesh, pp)
    want = pgo.pose_graph_optimize(torch.as_tensor(noisy, device=mesh.device),
                                   ei, ei + 1, meas, params=pp)
    assert float((res.poses - want.poses).abs().max()) <= 5e-3
    return mesh.counts["collectives"]


@pytest.mark.cuda
def test_cuda_parallel_world_size_1_nccl(cuda_dev):
    """The distributed layer at world size 1 over NCCL (the one-card
    deployment), in a spawned rank: every entry point against the single
    process (``_parallel_world_1``); its collectives went through NCCL."""
    from kornia_tpu_torch.parallel import mesh as tmesh

    (n,) = tmesh.spawn(_parallel_world_1, 1, devices=[str(cuda_dev) + ":0"],
                       timeout=300)
    assert n > 0
