"""The port's CUDA kernels (kornia_tpu_torch/ops/cuda_kernels.py) against
the JAX package.

On the CPU every wrapper runs its plain PyTorch version; those are held
here to the JAX reference: the XLA composition the CPU reference runs, and
the Pallas kernel itself in interpret mode. The CUDA kernels themselves
are held to their plain versions on the card by tests/test_torch_cuda.py.
"""

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
from kornia_tpu.ops import pallas_kernels as pk

from kornia_tpu_torch import convert
from kornia_tpu_torch.ops import cuda_kernels as ck


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


@pytest.mark.parametrize("shape", [(64, 96), (53, 97), (17, 23)])
def test_fast_harris_plain_matches_reference(shape):
    """Score and NMS maps are exact (the V measure is integer on u8), and
    so is the Harris map: the port keeps the reference's padding and its
    separately rounded multiply/add order, and XLA on the CPU contracts
    nothing into FMAs here (measured: 0 differing pixels)."""
    img = _img(1, shape)
    s_ref = np.asarray(jfast.nms_maxpool(jfast.fast_score(
        jnp.asarray(img), 7.0)))
    h_ref = np.asarray(jresp.harris_response(
        jnp.asarray(img).astype(jnp.float32), k=0.04, block_size=5,
        sigma=1.0, grad="central"))
    score, hmap = ck.fast_harris(convert.tensor(img), 7.0)
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
    score, hmap = ck.fast_harris(convert.tensor(img), 7.0)
    np.testing.assert_array_equal(score.numpy(), np.asarray(s_pl))
    hp = np.asarray(h_pl)[3:-3, 3:-3]
    ht = hmap.numpy()[3:-3, 3:-3]
    assert np.abs(ht - hp).max() <= 3e-6 * np.abs(hp).max()


def test_fast_harris_counts_no_cpu_launch():
    ck.reset_launch_counts()
    ck.fast_harris(convert.tensor(_img(3, (32, 32))), 7.0)
    assert ck.LAUNCHES["fast_harris"] == 0


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
        [convert.tensor(f) for f in frames])
    xy = torch.cat([convert.tensor(x) + torch.tensor([0, s],
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
        [convert.tensor(f) for f in frames])
    xy = torch.cat([convert.tensor(x) + torch.tensor([0, s],
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
    got = ck.brief_sample(convert.tensor(win), convert.tensor(rows),
                          convert.tensor(cols))
    np.testing.assert_array_equal(got.numpy(), ref)


def test_brief_sample_plain_matches_pallas_interpret():
    win, rows, cols = _taps(9, 11)
    ref = np.asarray(pk.brief_sample_pallas(
        jnp.asarray(win), jnp.asarray(rows), jnp.asarray(cols)))
    got = ck.brief_sample(convert.tensor(win), convert.tensor(rows),
                          convert.tensor(cols))
    np.testing.assert_array_equal(got.numpy(), ref)


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
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         cwd=os.path.dirname(os.path.dirname(
                             os.path.abspath(__file__))))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_cuda_entry_point_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CUDA entry point runs")
    from kornia_tpu_torch.features import orb
    with pytest.raises(RuntimeError, match="device='cpu'"):
        orb.orb_detect_and_describe(_img(14, (64, 64)))
