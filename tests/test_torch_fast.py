"""The port's FAST detector path (kornia_tpu_torch/features/fast.py:
``topk_keypoints``, ``_score_dispatch``, ``_score_nms_dispatch``,
``fast_detect``, ``_two_tier_select(border_mask=)``) and K1's score-only
plain versions (``cuda_kernels.fast_score`` on CPU tensors) against the JAX
package's XLA path, run as its own tests run it on the CPU.

Every comparison is exact: the FAST score of u8 input is an integer, the
mask multiply and the max-pool NMS are exact, and the reference's
``approx_max_k`` is ``top_k`` off the TPU (lower index first on ties), which
``stable_topk`` reproduces. The ROI mask follows the XLA path (fast.py:
158-162): the 3-px border kill stays and the mask multiplies the score
before the NMS; the reference's side is ``StaticMask``, as its tests pass
it (tests/test_features.py:148-164)."""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from kornia_tpu.features import fast as jfast
from kornia_tpu.ops.pallas_kernels import StaticMask

from kornia_tpu_torch import convert
from kornia_tpu_torch.features import fast as tfast
from kornia_tpu_torch.ops import cuda_kernels as ck

# One intra-op thread: these tests run many small ops, and torch's pool
# of a thread per core spins against the other test processes.
torch.set_num_threads(1)

tensor = functools.partial(convert.tensor, device="cpu")


def _textured(seed, shape=(120, 160)):
    """Blocky noise (4-px cells) plus pixel noise: many corners, and many
    tied integer scores."""
    rng = np.random.default_rng(seed)
    h, w = shape
    base = rng.integers(0, 256, (h // 4 + 1, w // 4 + 1)).astype(np.float32)
    up = np.kron(base, np.ones((4, 4)))[:h, :w]
    return np.clip(up + rng.normal(0, 6, up.shape), 0, 255).astype(np.uint8)


def _masks(h, w, seed=5):
    """The reference test's masks (the interior, its left half) and the
    ones this port adds: 1 everywhere (the border included) and a random
    0/1 mask."""
    full = np.zeros((h, w), np.float32)
    full[3: h - 3, 3: w - 3] = 1.0
    left = full.copy()
    left[:, w // 2:] = 0.0
    rand = np.random.default_rng(seed).integers(0, 2, (h, w)).astype(
        np.float32)
    return {"interior": full, "interior-left": left,
            "ones-on-border": np.ones((h, w), np.float32), "random": rand}


def _keypoints_equal(ref, got):
    np.testing.assert_array_equal(got.xy.numpy(), np.asarray(ref.xy))
    np.testing.assert_array_equal(got.score.numpy(), np.asarray(ref.score))
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(ref.mask))


@pytest.mark.parametrize("nms", [True, False], ids=["nms", "no-nms"])
@pytest.mark.parametrize("threshold", [10.0, 20.0])
def test_fast_detect_equals_reference(nms, threshold):
    img = _textured(1)
    ref = jfast.fast_detect(jnp.asarray(img), threshold, 300, nms)
    got = tfast.fast_detect(img, threshold, 300, nms, device="cpu")
    _keypoints_equal(ref, got)
    assert int(got.mask.sum()) > 50


def test_fast_detect_other_arc_length_and_few_corners():
    """Arc length 12 (the plain version only), and a budget larger than
    the corners found: the masked slots hold the lowest-index zeros."""
    img = _textured(2)
    ref = jfast.fast_detect(jnp.asarray(img), 10.0, 300, True, 12)
    _keypoints_equal(ref, tfast.fast_detect(img, 10.0, 300, True, 12,
                                            device="cpu"))
    flat = np.full((40, 50), 90, np.uint8)
    flat[20, 25] = 250
    ref = jfast.fast_detect(jnp.asarray(flat), 10.0, 64)
    got = tfast.fast_detect(flat, 10.0, 64, device="cpu")
    _keypoints_equal(ref, got)
    assert int(got.mask.sum()) == 1


def test_topk_keypoints_ties_take_the_lower_index():
    rng = np.random.default_rng(3)
    score = rng.integers(0, 4, (60, 80)).astype(np.float32)
    ref = jfast.topk_keypoints(jnp.asarray(score), 500)
    _keypoints_equal(ref, tfast.topk_keypoints(tensor(score), 500))


@pytest.mark.parametrize("mask", ["interior", "interior-left",
                                  "ones-on-border", "random"])
def test_score_nms_dispatch_with_mask_equals_reference(mask):
    img = _textured(4)
    m = _masks(*img.shape)[mask]
    ref = np.asarray(jfast._score_nms_dispatch(
        jnp.asarray(img), 10.0, 9, border_mask=StaticMask(m)))
    got = tfast._score_nms_dispatch(tensor(img), 10.0, 9, border_mask=m)
    np.testing.assert_array_equal(got.numpy(), ref)
    # the XLA contract: the 3-px border stays killed under any mask
    assert not got.numpy()[:3].any() and not got.numpy()[:, -3:].any()


def test_score_nms_dispatch_reference_cases():
    """tests/test_features.py:148-164 on the port: a mask of the interior
    equals no mask, and a mask of the left half drops the right corner."""
    img = np.zeros((96, 160), np.uint8)
    img[20, 20] = 200
    img[40, 100] = 200
    m = _masks(96, 160)
    s_full = tfast._score_nms_dispatch(tensor(img), 10.0, 9,
                                       border_mask=m["interior"])
    left = m["interior"].copy()
    left[:, 80:] = 0.0
    s_left = tfast._score_nms_dispatch(tensor(img), 10.0, 9,
                                       border_mask=left)
    s_none = tfast._score_nms_dispatch(tensor(img), 10.0, 9)
    assert torch.equal(s_full, s_none)
    assert s_left[20, 20] > 0 and s_left[40, 100] == 0.0
    ref = np.asarray(jfast._score_nms_dispatch(
        jnp.asarray(img), 10.0, 9, border_mask=StaticMask(left)))
    np.testing.assert_array_equal(s_left.numpy(), ref)


@pytest.mark.parametrize("mask", [None, "ones-on-border", "random"])
def test_score_dispatch_equals_reference(mask):
    """No NMS: the reference's ``_score_dispatch`` (which takes no mask)
    times the mask, as its ``_score_nms_dispatch`` applies one."""
    img = _textured(6)
    m = None if mask is None else _masks(*img.shape)[mask]
    ref = np.asarray(jfast._score_dispatch(jnp.asarray(img), 10.0, 9))
    if m is not None:
        ref = ref * m
    got = tfast._score_dispatch(tensor(img), 10.0, 9, border_mask=m)
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("mask", [None, "interior-left", "ones-on-border"])
def test_two_tier_select_border_mask_equals_reference(mask):
    img = _textured(7)
    m = None if mask is None else _masks(*img.shape)[mask]
    ref = np.asarray(jfast._two_tier_select(
        jnp.asarray(img), 20.0, 7.0, 9, 35,
        border_mask=None if m is None else StaticMask(m)))
    got = tfast._two_tier_select(tensor(img), 20.0, 7.0, 9, 35,
                                 border_mask=m)
    np.testing.assert_array_equal(got.numpy(), ref)


def test_fast_detect_cells_after_the_gate_change_equals_reference():
    """``fast_detect_cells`` now reaches the score through
    ``_score_nms_dispatch`` and its gate repeats cells by an expand."""
    img = _textured(8)
    ref = jfast.fast_detect_cells(jnp.asarray(img), per_cell=4)
    _keypoints_equal(ref, tfast.fast_detect_cells(tensor(img), per_cell=4))


@pytest.mark.parametrize("nms", [True, False], ids=["nms", "no-nms"])
@pytest.mark.parametrize("mask", [None, "random", "ones-on-border"])
def test_fast_score_plain_version_equals_reference_composition(nms, mask):
    """K1's score-only plain version, which the card test holds the kernel
    to bit for bit: ``fast_score``, the mask, then ``nms_maxpool``, each
    the reference's XLA function."""
    img = _textured(9, (72, 96))
    m = None if mask is None else _masks(*img.shape)[mask]
    ref = jfast.fast_score(jnp.asarray(img), 20.0)
    if m is not None:
        ref = ref * m
    if nms:
        ref = jfast.nms_maxpool(ref)
    ck.reset_launch_counts()
    got = ck.fast_score(tensor(img), 20.0, nms=nms,
                        mask=None if m is None else tensor(m))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert ck.LAUNCHES["fast_score"] == 0      # a CPU tensor: no launch


def test_fast_detect_default_device_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CUDA entry point runs")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tfast.fast_detect(_textured(10, (40, 40)))
