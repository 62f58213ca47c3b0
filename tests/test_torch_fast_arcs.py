"""K1's FAST-n forms and the package's exports.

FAST at arc lengths other than 9: the port's CPU route (``fast_score``,
``fast_detect``, ``fast_detect_cells``, ``fast_harris_cells``, and K1's
score-only plain version ``cuda_kernels._fast_score_plain``) against the
JAX package's XLA path, exactly (the FAST score of u8 input is an integer,
the max-pool NMS and the per-cell selection are exact). Besides 9-12, the
two edge values the reference's log-step doubling reduces
(pallas_kernels.py:262-272, fast.py:56-66): an arc length <= 1 is the arc
of 1, one >= 16 the whole ring; ``cuda_kernels.fast_arc`` maps n the same
way for the kernel, which is compiled for 1..16. The card's forms are held
to these plain versions by tests/test_torch_cuda.py.

The exports: a bare ``import kornia_tpu_torch`` exposes every subpackage
and module of the reference's ``__all__`` lists that the port has,
checked in a fresh interpreter so that no other test's imports hide a
missing one.
"""

import ast
import functools
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from kornia_tpu.features import fast as jfast

from kornia_tpu_torch import convert
from kornia_tpu_torch.features import fast as tfast
from kornia_tpu_torch.ops import cuda_kernels as ck

torch.set_num_threads(1)

tensor = functools.partial(convert.tensor, device="cpu")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# 9-12, then an arc length the doubling takes as 1 and one it takes as 16
ARCS = [9, 10, 11, 12, 0, 17]


def _textured(seed, shape=(96, 128)):
    """Blocky noise (4-px cells) plus pixel noise: many corners."""
    rng = np.random.default_rng(seed)
    h, w = shape
    base = rng.integers(0, 256, (h // 4 + 1, w // 4 + 1)).astype(np.float32)
    up = np.kron(base, np.ones((4, 4)))[:h, :w]
    return np.clip(up + rng.normal(0, 6, up.shape), 0, 255).astype(np.uint8)


def _equal(ref, got):
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


@pytest.mark.parametrize("n", ARCS)
def test_fast_score_arc_lengths_equal_reference(n):
    img = _textured(60)
    ref = np.asarray(jfast.fast_score(jnp.asarray(img), 10.0, n))
    got = tfast.fast_score(tensor(img), 10.0, n)
    np.testing.assert_array_equal(got.numpy(), ref)
    assert (ref > 0).sum() > 20


@pytest.mark.parametrize("n", ARCS)
@pytest.mark.parametrize("nms", [True, False], ids=["nms", "no-nms"])
def test_fast_detect_arc_lengths_equal_reference(n, nms):
    img = _textured(61)
    ref = jfast.fast_detect(jnp.asarray(img), 12.0, 256, nms, n)
    got = tfast.fast_detect(img, 12.0, 256, nms, n, device="cpu")
    _equal(ref, got)


@pytest.mark.parametrize("n", ARCS)
def test_fast_cell_detectors_arc_lengths_equal_reference(n):
    """The two-tier cell detectors at arc length n, with the cell grid
    not dividing the frame (cell 35 on 96×128)."""
    img = _textured(62)
    ref = jfast.fast_detect_cells(jnp.asarray(img), 35, 20.0, 7.0, 4, n)
    got = tfast.fast_detect_cells(tensor(img), 35, 20.0, 7.0, 4, n)
    _equal(ref, got)
    hmap = np.random.default_rng(63).normal(size=img.shape).astype(
        np.float32)
    ref = jfast.fast_harris_cells(jnp.asarray(img), jnp.asarray(hmap), 35,
                                  20.0, 7.0, 4, n)
    got = tfast.fast_harris_cells(tensor(img), tensor(hmap), 35, 20.0, 7.0,
                                  4, n)
    _equal(ref, got)


@pytest.mark.parametrize("n", ARCS)
@pytest.mark.parametrize("nms", [True, False], ids=["nms", "no-nms"])
@pytest.mark.parametrize("masked", [False, True], ids=["", "mask"])
def test_fast_score_plain_version_at_arc_lengths(n, nms, masked):
    """K1's score-only plain version at arc length n is the port's own
    composition, ``nms_maxpool(fast_score(img, thr, n) * mask)``."""
    img = tensor(_textured(64))
    mask = (tensor(np.random.default_rng(65).integers(0, 2, img.shape)
                   .astype(np.float32)) if masked else None)
    want = tfast.fast_score(img, 15.0, n)
    if mask is not None:
        want = want * mask
    if nms:
        want = tfast.nms_maxpool(want)
    got = ck._fast_score_plain(img, 15.0, nms, mask, arc_length=n)
    assert torch.equal(got, want)
    assert torch.equal(ck.fast_score(img, 15.0, nms, mask, arc_length=n),
                       want)


def test_fast_arc_maps_like_the_reference_doubling():
    """n <= 1 is the arc of 1 and n >= 16 the whole ring in the reference;
    ``fast_arc`` gives the kernel's arc length for every n the same way,
    and refuses a value that is not an integer."""
    img = jnp.asarray(_textured(66))
    by_n = {n: np.asarray(jfast.fast_score(img, 10.0, n))
            for n in (-3, 0, 1, 2, 15, 16, 17, 40)}
    for n, arr in by_n.items():
        np.testing.assert_array_equal(arr, by_n[ck.fast_arc(n)])
    assert not np.array_equal(by_n[1], by_n[2])
    assert not np.array_equal(by_n[15], by_n[16])
    assert [ck.fast_arc(n) for n in (-3, 0, 1, 9, 12, 16, 17, 40)] == [
        1, 1, 1, 9, 12, 16, 16, 16]
    with pytest.raises(TypeError):
        ck.fast_arc(9.5)


def test_fast_detect_any_arc_length_counts_no_cpu_launch():
    ck.reset_launch_counts()
    for n in (1, 10, 16):
        tfast.fast_detect(_textured(67), 10.0, 64, arc_length=n,
                          device="cpu")
    assert all(v == 0 for v in ck.LAUNCHES.values())


# --------------------------------------------------------------------------
# the package's exports
# --------------------------------------------------------------------------


def _reference_all(rel_path):
    """The ``__all__`` list of a reference ``__init__.py``, read with ast
    (nothing is imported)."""
    with open(os.path.join(ROOT, "kornia_tpu", rel_path)) as f:
        tree = ast.parse(f.read())
    for node in tree.body:
        if (isinstance(node, ast.Assign)
                and node.targets[0].id == "__all__"):
            return ast.literal_eval(node.value)
    raise AssertionError(f"no __all__ in {rel_path}")


def _ported(package, name):
    """Whether the port has module or subpackage ``name`` of
    ``package`` (a path under kornia_tpu_torch/)."""
    base = os.path.join(ROOT, "kornia_tpu_torch", *package)
    return (os.path.exists(os.path.join(base, name + ".py"))
            or os.path.isdir(os.path.join(base, name)))


def test_bare_import_exposes_every_ported_name():
    """After ``import kornia_tpu_torch`` alone, in a fresh interpreter:
    every subpackage of the reference's top-level ``__all__`` that the
    port has, every module of ``ops``' and ``geometry``'s (``cuda_kernels``
    for ``pallas_kernels``), every name of ``optim``'s, ``slam``'s,
    ``bow``'s, ``utils``', ``apriltag``'s, ``io``'s, ``models``',
    ``parallel``'s and ``native``'s ``__all__`` is an attribute, and every
    subpackage of the reference's is among them; none of jax, flax,
    kornia_tpu, PIL, cv2, pyarrow or transformers is imported, and no
    process group is started."""
    rename = {"pallas_kernels": "cuda_kernels"}
    want = [n for n in _reference_all("__init__.py")
            if n == "__version__" or _ported((), n)]
    assert want == _reference_all("__init__.py")
    attrs = list(want)
    for sub in ("ops", "geometry"):
        names = [rename.get(n, n) for n in _reference_all(f"{sub}/__init__.py")]
        assert [n for n in names if not _ported((sub,), n)] == []
        attrs += [f"{sub}.{n}" for n in names]
    for sub in ("optim", "slam", "bow", "utils", "apriltag", "io", "models",
                "parallel", "native"):
        attrs += [f"{sub}.{n}" for n in _reference_all(f"{sub}/__init__.py")]
    attrs += ["ops.color.rgb_to_gray", "features.fast.fast_detect",
              "features.orb.orb_detect_and_describe",
              "geometry.essential5pt.essential_5pt", "image.Image",
              "apriltag.AprilTagDecoder",
              "ops.connected_components.connected_components",
              "ops.contours.find_contours", "io.rvl_compress",
              "models.generate", "models.build_vlm", "models.build_paligemma",
              "models.smolvlm_256m", "models.preprocess_image",
              "io.read_image_any_rgb8", "io.VideoReader", "io.MjpegReader",
              "io.TumRgbdDataset", "parallel.mesh.make_mesh",
              "parallel.ba_dist.bundle_adjust_schur_dist_kf",
              "parallel.pgo_dist.pose_graph_optimize_dist",
              "parallel.exchange.exchange_observations",
              "parallel.frontend_dist.detect_and_describe_batch",
              "parallel.resilience.run_with_recovery", "parallel.follow"]
    code = (
        "import sys, functools\n"
        "import kornia_tpu_torch\n"
        f"attrs = {attrs!r}\n"
        "missing = []\n"
        "for a in attrs:\n"
        "    try:\n"
        "        functools.reduce(getattr, a.split('.'), kornia_tpu_torch)\n"
        "    except AttributeError:\n"
        "        missing.append(a)\n"
        "assert not missing, missing\n"
        "absent = ('jax', 'flax', 'kornia_tpu', 'PIL', 'cv2', 'pyarrow',\n"
        "          'transformers')\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in absent]\n"
        "assert not bad, bad\n"
        "import torch.distributed as dist\n"
        "assert not dist.is_initialized()\n"
        "print('ok', len(attrs))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["ok", str(len(attrs))]
