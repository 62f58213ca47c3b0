"""The port's codec-free I/O (kornia_tpu_torch/io/: RVL on the port's
native build, PLY, PCD, COLMAP, FpsCounter) against the JAX package's.

Every case of tests/test_io.py for these formats, on the port, and held
against the reference both ways: bytes or files written by one package
are read by the other and give equal arrays, and the RVL bytes of both
are equal. Writes go under ``tmp_path`` only.
"""

import struct
import time

import numpy as np
import pytest
import torch

from kornia_tpu import io as jio

from kornia_tpu_torch import io as tio
from kornia_tpu_torch.io import colmap as tcolmap
from kornia_tpu_torch.io import pcd as tpcd
from kornia_tpu_torch.io import ply as tply
from kornia_tpu_torch.io import rvl as trvl

torch.set_num_threads(1)

PACKAGES = {"port": tio, "reference": jio}
BOTH_WAYS = [("port", "reference"), ("reference", "port"), ("port", "port")]


@pytest.fixture
def rng():
    return np.random.default_rng(42)


def _depth(rng, h=64, w=80):
    depth = rng.integers(500, 5000, (h, w)).astype(np.uint16)
    depth[rng.random((h, w)) < 0.4] = 0          # typical depth holes
    return depth


# ------------------------------------------------------------------ RVL


@pytest.mark.parametrize("writer,reader", BOTH_WAYS)
def test_rvl_roundtrip_both_ways(rng, writer, reader):
    depth = _depth(rng)
    blob = PACKAGES[writer].rvl_compress(depth)
    assert blob[:4] == b"RVL1"
    np.testing.assert_array_equal(PACKAGES[reader].rvl_decompress(blob),
                                  depth)


def test_rvl_bytes_equal_the_reference(rng):
    for depth in (_depth(rng), _depth(rng, 7, 13)[:, :, None],
                  np.zeros((16, 16), np.uint16),
                  rng.integers(1, 65535, (16, 16)).astype(np.uint16),
                  np.full((3, 5), 65535, np.uint16)):
        assert tio.rvl_compress(depth) == jio.rvl_compress(depth)


def test_rvl_compresses_sparse():
    depth = np.zeros((100, 100), np.uint16)
    depth[40:50, 40:50] = 1234
    assert len(tio.rvl_compress(depth)) < depth.nbytes / 10


def test_rvl_all_zero_and_all_dense(rng):
    """The dense case has deltas of up to 6 nibbles: the port's native
    buffer holds them (the reference's 2n + 16 bytes overflow there and it
    falls back to Python)."""
    for depth in (np.zeros((16, 16), np.uint16),
                  rng.integers(1, 65535, (16, 16)).astype(np.uint16)):
        np.testing.assert_array_equal(
            tio.rvl_decompress(tio.rvl_compress(depth)), depth)


def test_rvl_python_route_matches_native(rng):
    depth = _depth(rng, 32, 32)
    flat = depth.reshape(-1)
    py_blob = trvl._compress_py(flat)
    assert py_blob == jio.rvl._compress_py(flat)
    np.testing.assert_array_equal(trvl._decompress_py(py_blob, flat.size),
                                  flat)
    assert tio.rvl_compress(depth)[12:] == py_blob


def test_rvl_header_hardening():
    with pytest.raises(trvl.RvlError):
        tio.rvl_decompress(b"JUNK" + b"\x00" * 20)
    huge = b"RVL1" + struct.pack("<II", 100000, 100000)
    with pytest.raises(trvl.RvlError):
        tio.rvl_decompress(huge)
    with pytest.raises(trvl.RvlError):
        tio.rvl_decompress(b"RVL1" + struct.pack("<II", 0, 4))
    with pytest.raises(trvl.RvlError):
        tio.rvl_compress(np.zeros((4, 4), np.float32))
    with pytest.raises(trvl.RvlError):
        tio.rvl_compress(np.zeros((8193, 2), np.uint16))


def test_rvl_truncated_stream(rng):
    blob = tio.rvl_compress(_depth(rng))
    with pytest.raises(trvl.RvlError):
        tio.rvl_decompress(blob[: len(blob) // 2])
    with pytest.raises(trvl.RvlError):
        trvl._decompress_py(blob[12: len(blob) // 2], 64 * 80)


# ------------------------------------------------------------------ PLY


@pytest.mark.parametrize("writer,reader", BOTH_WAYS)
def test_ply_binary_both_ways(tmp_path, rng, writer, reader):
    pts = rng.standard_normal((100, 3))
    cols = rng.integers(0, 256, (100, 3), np.uint8)
    nrm = rng.standard_normal((100, 3))
    p = str(tmp_path / "a.ply")
    PACKAGES[writer].write_ply(p, pts, colors=cols, normals=nrm, binary=True)
    out = PACKAGES[reader].read_ply(p)
    np.testing.assert_array_equal(out["points"], pts)
    np.testing.assert_array_equal(out["colors"], cols)
    np.testing.assert_array_equal(out["normals"], nrm)


@pytest.mark.parametrize("writer,reader", BOTH_WAYS)
def test_ply_ascii_both_ways(tmp_path, rng, writer, reader):
    pts = rng.standard_normal((10, 3))
    p = str(tmp_path / "a.ply")
    PACKAGES[writer].write_ply(p, pts, binary=False)
    out = PACKAGES[reader].read_ply(p)
    np.testing.assert_allclose(out["points"], pts, rtol=1e-12)
    assert set(out) == {"points"}


def test_ply_files_equal_and_errors(tmp_path, rng):
    pts = rng.standard_normal((20, 3))
    cols = rng.integers(0, 256, (20, 3), np.uint8)
    for binary in (True, False):
        a, b = tmp_path / f"a{binary}.ply", tmp_path / f"b{binary}.ply"
        tio.write_ply(str(a), pts, colors=cols, binary=binary)
        jio.write_ply(str(b), pts, colors=cols, binary=binary)
        assert a.read_bytes() == b.read_bytes()
    (tmp_path / "bad.ply").write_bytes(b"nope\n")
    with pytest.raises(tply.PlyError):
        tio.read_ply(str(tmp_path / "bad.ply"))
    with pytest.raises(tply.PlyError):
        tio.write_ply(str(tmp_path / "c.ply"), np.zeros((3, 2)))


# ------------------------------------------------------------------ PCD


@pytest.mark.parametrize("writer,reader", BOTH_WAYS)
def test_pcd_binary_both_ways(tmp_path, rng, writer, reader):
    pts = rng.standard_normal((50, 3)).astype(np.float32)
    cols = rng.integers(0, 256, (50, 3), np.uint8)
    p = str(tmp_path / "a.pcd")
    PACKAGES[writer].write_pcd(p, pts, colors=cols, binary=True)
    out = PACKAGES[reader].read_pcd(p)
    np.testing.assert_array_equal(out["points"], pts)
    np.testing.assert_array_equal(out["colors"], cols)


@pytest.mark.parametrize("writer,reader", BOTH_WAYS)
def test_pcd_ascii_both_ways(tmp_path, rng, writer, reader):
    pts = rng.standard_normal((8, 3)).astype(np.float32)
    p = str(tmp_path / "a.pcd")
    PACKAGES[writer].write_pcd(p, pts, binary=False)
    out = PACKAGES[reader].read_pcd(p)
    np.testing.assert_allclose(out["points"], pts, rtol=1e-6)


def test_pcd_files_equal_and_errors(tmp_path, rng):
    pts = rng.standard_normal((12, 3)).astype(np.float32)
    cols = rng.integers(0, 256, (12, 3), np.uint8)
    for binary in (True, False):
        a, b = tmp_path / f"a{binary}.pcd", tmp_path / f"b{binary}.pcd"
        tio.write_pcd(str(a), pts, colors=cols, binary=binary)
        jio.write_pcd(str(b), pts, colors=cols, binary=binary)
        assert a.read_bytes() == b.read_bytes()
    (tmp_path / "bad.pcd").write_text("VERSION 0.7\nDATA binary\n")
    with pytest.raises(tpcd.PcdError):
        tio.read_pcd(str(tmp_path / "bad.pcd"))
    with pytest.raises(tpcd.PcdError):
        tio.write_pcd(str(tmp_path / "c.pcd"), np.zeros((3, 4)))


# --------------------------------------------------------------- COLMAP

COLMAP_CAMERAS = """\
# Camera list with one line of data per camera:
#   CAMERA_ID, MODEL, WIDTH, HEIGHT, PARAMS[]
1 PINHOLE 640 480 500.0 505.0 320.0 240.0
2 SIMPLE_RADIAL 640 480 500.0 320.0 240.0 0.01
"""

COLMAP_IMAGES = """\
# Image list with two lines of data per image
1 0.9999 0.01 0.0 0.0 0.1 0.2 0.3 1 frame001.png
10.0 20.0 5 30.0 40.0 -1
2 1.0 0.0 0.0 0.0 0.0 0.0 0.0 1 frame002.png
15.0 25.0 5
"""

COLMAP_POINTS = """\
# 3D point list
5 1.0 2.0 3.0 255 128 0 0.5 1 0 2 0
"""


@pytest.fixture
def model_dir(tmp_path):
    (tmp_path / "cameras.txt").write_text(COLMAP_CAMERAS)
    (tmp_path / "images.txt").write_text(COLMAP_IMAGES)
    (tmp_path / "points3D.txt").write_text(COLMAP_POINTS)
    return str(tmp_path)


def test_colmap_full_model(model_dir):
    cams, imgs, pts = tio.read_colmap_model(model_dir)
    assert set(cams) == {1, 2}
    assert cams[1].model == "PINHOLE"
    k = cams[1].k_matrix()
    assert k[0, 0] == 500.0 and k[1, 2] == 240.0
    k2 = cams[2].k_matrix()
    assert k2[0, 0] == k2[1, 1] == 500.0
    assert set(imgs) == {1, 2}
    im = imgs[1]
    assert im.name == "frame001.png"
    assert im.xys.shape == (2, 2)
    assert list(im.point3d_ids) == [5, -1]
    r = im.rotation_matrix()
    np.testing.assert_allclose(r @ r.T, np.eye(3), atol=1e-12)
    assert set(pts) == {5}
    assert pts[5].track == [(1, 0), (2, 0)]
    np.testing.assert_array_equal(pts[5].rgb, [255, 128, 0])
    np.testing.assert_allclose(imgs[2].camera_center(), [0, 0, 0])


def test_colmap_equals_reference(model_dir):
    got, ref = tio.read_colmap_model(model_dir), jio.read_colmap_model(
        model_dir)
    for g, r in zip(got, ref):
        assert set(g) == set(r)
        for key in r:
            for name, val in vars(r[key]).items():
                if isinstance(val, np.ndarray):
                    np.testing.assert_array_equal(getattr(g[key], name), val)
                else:
                    assert getattr(g[key], name) == val
    for key in ref[0]:
        np.testing.assert_array_equal(got[0][key].k_matrix(),
                                      ref[0][key].k_matrix())
    for key in ref[1]:
        np.testing.assert_array_equal(got[1][key].rotation_matrix(),
                                      ref[1][key].rotation_matrix())
        np.testing.assert_array_equal(got[1][key].camera_center(),
                                      ref[1][key].camera_center())


def test_colmap_errors(tmp_path):
    with pytest.raises(tcolmap.ColmapError):
        tio.read_cameras_txt(str(tmp_path / "missing.txt"))
    (tmp_path / "images.txt").write_text("1 1 0 0 0 0 0 0 1 a.png\n")
    with pytest.raises(tcolmap.ColmapError):
        tio.read_images_txt(str(tmp_path / "images.txt"))
    (tmp_path / "cameras.txt").write_text("1 FOO 640 480 1.0\n")
    with pytest.raises(tcolmap.ColmapError):
        tio.read_cameras_txt(str(tmp_path / "cameras.txt"))[1].k_matrix()


# ------------------------------------------------------------ FpsCounter


def test_fps_counter_basic():
    fps = tio.FpsCounter(window=10)
    assert fps.fps() == 0.0
    for _ in range(5):
        fps.tick()
        time.sleep(0.002)
    assert fps.fps() > 0
    fps.reset()
    assert fps.fps() == 0.0
    with pytest.raises(ValueError):
        tio.FpsCounter(window=1)


def test_io_exports_the_ported_names():
    """With the codecs, video and datasets, the port's ``io`` exports the
    reference's whole ``__all__``, in its order."""
    assert tio.__all__ == jio.__all__
    assert all(hasattr(tio, n) for n in tio.__all__)
