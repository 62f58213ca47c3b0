"""K12 (``features/orb.orb_pyramid``): ORB's image pyramid, every level of
a frame in one launch.

On the CPU the wrapper runs its plain version, ``ops/pyramid.scale_pyramid``
(the chain of bilinear resizes ORB ran before); these tests hold the CPU
route to that chain, hold the kernel's tap table to the resize matrices
it is read from, check the buffer layout and the launch plan, and hold a
model of the kernel's arithmetic (``_kernel_model``: the plan's taps, the
two-tap sums of ``csrc/orb_pyramid.cu`` in numpy) to the dense products
summed as one FMA chain (``_dense_chain``) and, with the sum order read
from this machine's own products (``orb.pyramid_sum_order``), to the plain
chain itself. The kernel itself is held to the plain chain on the card by
tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

from kornia_tpu_torch.features import orb
from kornia_tpu_torch.ops import cuda_kernels as ck
from kornia_tpu_torch.ops.pyramid import scale_pyramid
from kornia_tpu_torch.ops.resize import _resize_matrix, resize
from kornia_tpu_torch.utils import tracing

torch.set_num_threads(1)

# (frame shape, levels, scale): KITTI's and the SLAM loop's pyramids, odd
# and narrow shapes, levels a few pixels high or wide, a scale of 2 (taps
# of 0.5: ties at x.5), and more levels than one launch takes
_CASES = {
    "kitti": ((376, 1241), 8, 1.2),
    "slam": ((480, 752), 4, 1.2),
    "odd": ((37, 45), 6, 1.2),
    "few_rows": ((9, 1241), 8, 1.2),
    "narrow": ((600, 7), 8, 1.2),
    "scale_1.35": ((123, 457), 5, 1.35),
    "halves": ((64, 64), 3, 2.0),
    "beyond_table": ((376, 1241), 40, 1.05),
}


def _scene(seed, shape):
    """Seeded noise upsampled 8x bilinearly: a smooth textured frame."""
    rng = np.random.default_rng(seed)
    h, w = shape
    small = rng.random((h // 8 + 2, w // 8 + 2)) * 255.0
    fy = (np.arange(h) + 0.5) / 8 - 0.5
    fx = (np.arange(w) + 0.5) / 8 - 0.5
    y0 = np.clip(np.floor(fy).astype(int), 0, small.shape[0] - 2)
    x0 = np.clip(np.floor(fx).astype(int), 0, small.shape[1] - 2)
    ay = np.clip(fy - y0, 0, 1)[:, None]
    ax = np.clip(fx - x0, 0, 1)[None]
    rows = small[y0] * (1 - ay) + small[y0 + 1] * ay
    img = rows[:, x0] * (1 - ax) + rows[:, x0 + 1] * ax
    return np.clip(np.rint(img), 0, 255).astype(np.uint8)


def _frame(kind, seed, shape):
    rng = np.random.default_rng(seed)
    if kind == "scene":
        return _scene(seed, shape)
    if kind == "noise":
        return rng.integers(0, 256, shape, np.uint8)
    return (rng.integers(0, 2, shape) * 255).astype(np.uint8)   # saturated


def _old_chain(gray, n_levels, scale):
    """features/orb.py::_pyramid as it ran before K12."""
    h, w = gray.shape
    levels = [gray]
    for i in range(1, n_levels):
        s = scale ** i
        levels.append(resize(levels[-1], (int(round(h / s)),
                                          int(round(w / s)))))
    return levels


def _fma(a, b, c) -> np.ndarray:
    """orb._fma_f32 (exact f32 fma) on numpy values."""
    return orb._fma_f32(*(torch.as_tensor(np.asarray(v, np.float32))
                          for v in (a, b, c))).numpy()


def _dense_chain(gray, n_levels, scale):
    """The plain chain's products summed as a product that does not split
    its sum over k does: one FMA chain over k ascending from 0, every term
    of the dense matrices (Wy @ img, then @ Wx^T), then round and
    clamp."""
    out = [gray]
    for lh, lw in orb.pyramid_plan(*gray.shape, n_levels, scale).shapes[1:]:
        src = out[-1].astype(np.float32)
        wy = _resize_matrix(src.shape[0], lh, "bilinear", False)
        wx = _resize_matrix(src.shape[1], lw, "bilinear", False)
        r = np.zeros((lh, src.shape[1]), np.float32)
        for k in range(src.shape[0]):
            r = _fma(wy[:, k, None], src[None, k], r)
        o = np.zeros((lh, lw), np.float32)
        for k in range(src.shape[1]):
            o = _fma(r[:, k, None], wx[None, :, k], o)
        out.append(np.clip(np.rint(o), 0, 255).astype(np.uint8))
    return out


def _two_taps(x0, x1, w0, w1, split):
    """One pass of the kernel in numpy: w0 * x0, then fma(w1, x1, .) or,
    where ``split``, + w1 * x1 (each product and sum rounded to f32)."""
    first = (w0.astype(np.float64) * x0).astype(np.float32)
    second = (w1.astype(np.float64) * x1).astype(np.float32)
    return np.where(split, _fma(1.0, second, first), _fma(w1, x1, first))


def _kernel_model(gray, n_levels, scale, taps=None):
    """csrc/orb_pyramid.cu's arithmetic in numpy over :func:`orb.
    pyramid_plan` and ``taps`` (the plan's, or :func:`orb.pyramid_taps`
    with the order bits): each level written into one padded buffer at
    its offset and read back from it as the next level's source; the row
    pass at every source column, then the column pass on those f32
    values, rint, clamp."""
    h, w = gray.shape
    plan = orb.pyramid_plan(h, w, n_levels, scale)
    taps = plan.taps if taps is None else taps
    buf = np.full(plan.nbytes, 77, np.uint8)
    src, out = gray, [gray]
    for i, ((lh, lw), off) in enumerate(zip(plan.shapes[1:], plan.offsets)):
        yt = taps[plan.ytabs[i]: plan.ytabs[i] + lh]
        xt = taps[plan.xtabs[i]: plan.xtabs[i] + lw]
        y1, x1 = yt[:, 1] & 0x7FFFFFFF, xt[:, 1] & 0x7FFFFFFF
        r = _two_taps(src[yt[:, 0]].astype(np.float32),
                      src[y1].astype(np.float32),
                      yt[:, 2:3].view(np.float32), yt[:, 3:4].view(np.float32),
                      (yt[:, 1] < 0)[:, None])
        o = _two_taps(r[:, xt[:, 0]], r[:, x1],
                      xt[None, :, 2].view(np.float32),
                      xt[None, :, 3].view(np.float32), (xt[:, 1] < 0)[None])
        buf[off: off + lh * lw] = np.clip(np.rint(o), 0, 255).astype(
            np.uint8).ravel()
        src = buf[off: off + lh * lw].reshape(lh, lw)
        out.append(src)
    return out


@pytest.mark.parametrize("case", list(_CASES))
def test_pyramid_taps_rebuild_the_resize_matrices(case):
    """Every level's row and column tables rebuild ops/resize's f32
    bilinear matrices exactly: one or two non-zero weights a row, the
    first index below the second (a row of one repeats it with weight
    0), the same f32 values."""
    (h, w), n, s = _CASES[case]
    plan = orb.pyramid_plan(h, w, n, s)
    assert plan.taps.dtype == np.int32 and plan.taps.shape[1] == 4
    for i, ((ph, pw), (lh, lw)) in enumerate(zip(plan.shapes,
                                                 plan.shapes[1:])):
        for n_in, n_out, first in ((ph, lh, plan.ytabs[i]),
                                   (pw, lw, plan.xtabs[i])):
            t = plan.taps[first: first + n_out]
            wt = t[:, 2:].copy().view(np.float32)
            dense = np.zeros((n_out, n_in), np.float32)
            rows = np.arange(n_out)
            dense[rows, t[:, 0]] = wt[:, 0]
            dense[rows, t[:, 1]] += wt[:, 1]
            want = _resize_matrix(n_in, n_out, "bilinear", False)
            assert np.array_equal(dense, want), (case, i, n_in, n_out)
            assert np.all((t[:, 0] < t[:, 1])
                          | ((t[:, 0] == t[:, 1]) & (wt[:, 1] == 0)))
            assert np.all(wt[:, 0] > 0)
            assert np.all((want != 0).sum(axis=1) <= 2)


@pytest.mark.parametrize("case", list(_CASES))
def test_pyramid_plan_layout(case):
    """Level shapes as scale_pyramid makes them; each level >= 1 on a
    16-byte boundary of the buffer, padded to it, one after the other;
    the tables one after the other, rows then columns a level."""
    (h, w), n, s = _CASES[case]
    plan = orb.pyramid_plan(h, w, n, s)
    gray = torch.zeros((h, w), dtype=torch.uint8)
    assert list(plan.shapes) == [tuple(lv.shape) for lv in
                                 scale_pyramid(gray, n, s, device="cpu")]
    ends = [off + -(-lh * lw // 16) * 16
            for off, (lh, lw) in zip(plan.offsets, plan.shapes[1:])]
    assert plan.offsets[0] == 0 and all(o % 16 == 0 for o in plan.offsets)
    assert list(plan.offsets[1:]) == ends[:-1] and plan.nbytes == ends[-1]
    rows = 0
    for (lh, lw), y, x in zip(plan.shapes[1:], plan.ytabs, plan.xtabs):
        assert (y, x) == (rows, rows + lh)
        rows += lh + lw
    assert plan.taps.shape[0] == rows
    assert orb.pyramid_plan(h, w, n, s) is plan


@pytest.mark.parametrize("n_levels,groups", [
    (2, [(0, 2)]), (8, [(0, 8)]), (32, [(0, 32)]), (33, [(0, 32), (31, 2)]),
    (40, [(0, 32), (31, 9)]), (63, [(0, 32), (31, 32)]),
    (64, [(0, 32), (31, 32), (62, 2)])])
def test_pyramid_launches_chain_past_the_table(n_levels, groups):
    """Up to 32 levels a launch, its source included; each further launch
    starts from the last level of the one before, and its arguments are
    the plan's entries of its levels."""
    plan = orb.pyramid_plan(400, 300, n_levels, 1.01)
    launches = orb.pyramid_launches(plan)
    assert [(first, args[0]) for first, args in launches] == groups
    for first, (m, hs, ws, offs, ytabs, xtabs) in launches:
        lv = plan.shapes[first: first + m]
        assert list(hs) == [a for a, _ in lv] and list(ws) == [b for _, b in lv]
        assert list(offs) == list(plan.offsets[first: first + m - 1])
        assert list(ytabs) == list(plan.ytabs[first: first + m - 1])
        assert list(xtabs) == list(plan.xtabs[first: first + m - 1])
    assert orb.ORB_SELECT_MAX_LEVELS == 32


@pytest.mark.parametrize("case,kind,seed", [
    (case, kind, seed) for case in ("odd", "few_rows", "narrow", "scale_1.35",
                                    "halves")
    for kind, seed in (("scene", 70), ("noise", 71), ("saturated", 72))]
    + [("kitti_rows", "scene", 70)])
def test_kernel_model_equals_the_dense_fma_chain(case, kind, seed):
    """The kernel's arithmetic over the plan (two-tap FMA chains, rows
    first, each level read back from its place in the buffer) gives the
    bytes of the dense products summed as one FMA chain over k on every
    level of scene, noise and saturated frames: the zero terms of the
    dense rows leave the chain exact."""
    shape, n, s = ({**_CASES, "kitti_rows": ((40, 1241), 8, 1.2)})[case]
    gray = _frame(kind, seed, shape)
    got = _kernel_model(gray, n, s)
    want = _dense_chain(gray, n, s)
    for i, (a, b) in enumerate(zip(got, want)):
        assert np.array_equal(a, b), (case, kind, i, int((a != b).sum()))


@pytest.mark.parametrize("case", ["kitti", "slam", "odd", "few_rows",
                                  "narrow", "beyond_table"])
def test_kernel_model_with_the_read_order_equals_the_plain_chain(case):
    """The sum order read from this machine's own products (the CPU's
    BLAS splits some sums, as the card's library does) makes the kernel's
    arithmetic give the plain chain's bytes on every level, where the
    FMA chain alone does not everywhere: the order bits are what
    K12 reads on the card."""
    shape, n, s = _CASES[case]
    gray = _frame("scene", 75, shape)
    want = scale_pyramid(torch.from_numpy(gray), n, s, device="cpu")
    taps = orb.pyramid_taps(*shape, n, s, torch.device("cpu"))
    got = _kernel_model(gray, n, s, taps)
    for i, (a, b) in enumerate(zip(got, want)):
        assert np.array_equal(a, b.numpy()), (case, i,
                                              int((a != b.numpy()).sum()))
    plan = orb.pyramid_plan(*shape, n, s)
    assert np.array_equal(taps[:, [0, 2, 3]], plan.taps[:, [0, 2, 3]])
    assert np.array_equal(taps[:, 1] & 0x7FFFFFFF, plan.taps[:, 1])


def test_sum_order_is_read_per_output():
    """pyramid_sum_order: one flag a taps row, cached per frame shape and
    device; outputs of one tap (whose order cannot matter) are never
    split; on the CPU's products some outputs of KITTI's pyramid are split
    and most are one FMA chain."""
    dev = torch.device("cpu")
    split = orb.pyramid_sum_order(376, 1241, 8, 1.2, dev)
    plan = orb.pyramid_plan(376, 1241, 8, 1.2)
    assert split.dtype == bool and split.shape == (len(plan.taps),)
    assert orb.pyramid_sum_order(376, 1241, 8, 1.2, dev) is split
    single = plan.taps[:, 0] == plan.taps[:, 1]
    assert not split[single].any()
    assert 0 < split.sum() < len(split) // 10


def test_fma_f32_rounds_once():
    """The emulated fma rounds the exact sum: above a midpoint of the f32
    grid by less than a float64 ulp it rounds away from it (up, or down
    below a negative one), where a float64 sum then a cast would round to
    even."""
    one = np.float32(1.0)
    tiny = np.float32(2.0 ** -60)
    # a * b = 2^-24 + 2^-60 exactly (24-bit mantissas 2^23 + 2^11 and
    # 2^24 - 4095), c = 1: the exact sum lies just above the midpoint
    # 1 + 2^-24, which a float64 sum rounds to
    a = np.float32(1.0 + 2.0 ** -12)
    b = np.float32((2 ** 24 - 4095) * 2.0 ** -48)
    assert np.float64(a) * np.float64(b) == 2.0 ** -24 + 2.0 ** -60
    assert (np.float64(a) * np.float64(b) + 1.0).astype(np.float32) == one
    assert _fma(a, b, one) == np.nextafter(one, np.float32(2))
    assert _fma(tiny, one, one) == one
    assert _fma(-a, b, -one) == -np.nextafter(one, np.float32(2))


@pytest.mark.parametrize("case", ["slam", "odd", "beyond_table"])
def test_cpu_route_is_the_old_chain(case):
    """On the CPU ``_pyramid`` is scale_pyramid's chain: the same bytes as
    the chain ORB ran before K12, no launch; one level returns the frame."""
    (h, w), n, s = _CASES[case]
    gray = torch.from_numpy(_frame("scene", 73, (h, w)))
    ck.reset_launch_counts()
    got = orb._pyramid(gray, orb.OrbConfig(n_levels=n, scale_factor=s))
    want = _old_chain(gray, n, s)
    assert len(got) == n and got[0] is gray
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert all(v == 0 for v in ck.LAUNCHES.values())
    one = orb.orb_pyramid(gray, 1, s)
    assert len(one) == 1 and one[0] is gray


def test_pyramid_span_is_composed_on_the_cpu():
    """``features.orb.pyramid`` carries ``"composed"`` on the CPU
    (``"fused"`` is the card's route, K12)."""
    gray = _frame("scene", 74, (96, 128))
    with tracing.recording() as rows:
        orb.orb_detect_and_describe(gray, orb.OrbConfig(n_features=60,
                                                        n_levels=3),
                                    device="cpu")
    assert [r.attr for r in rows
            if r.name == "features.orb.pyramid"] == ["composed"]


def test_pyramid_plan_rejects_an_empty_level():
    """A level that rounds to no row or column raises, as the plain chain
    cannot make it either."""
    with pytest.raises(ValueError, match="empty level"):
        orb.pyramid_plan(3, 40, 8, 1.5)
    with pytest.raises(ZeroDivisionError):
        scale_pyramid(torch.zeros((3, 40), dtype=torch.uint8), 8, 1.5,
                      device="cpu")
