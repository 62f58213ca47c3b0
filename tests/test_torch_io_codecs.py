"""The rest of the port's I/O (kornia_tpu_torch/io/: image codecs, the
MJPEG AVI container, video and capture, the dataset readers; Arrow on
``Image``) and its C++ surface (kornia_tpu_torch/native/: the C API, the
header-only wrapper, the CMake package) against the JAX package's.

Every case of tests/test_io.py for these formats and of
tests/test_native_cpp.py, on the port, and held against the reference
both ways: a file written by one package is read by the other and gives
equal arrays, and the MJPEG AVI files of both are equal byte for byte.
Writes go under ``tmp_path`` only.
"""

import ctypes
import os
import shutil
import subprocess
import textwrap

import numpy as np
import pytest
import torch

from kornia_tpu import io as jio
from kornia_tpu.io import mjpeg_avi as jmjpeg

from kornia_tpu_torch import io as tio
from kornia_tpu_torch.io import datasets as tdatasets
from kornia_tpu_torch.io import mjpeg_avi as tmjpeg
from kornia_tpu_torch.io import video as tvideo
from kornia_tpu_torch.io.image_io import IoError
from kornia_tpu_torch.native import build as tbuild
from kornia_tpu_torch.native import load_native_library

torch.set_num_threads(1)

PACKAGES = {"port": tio, "reference": jio}
BOTH_WAYS = [("port", "reference"), ("reference", "port"), ("port", "port")]
NATIVE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "kornia_tpu_torch", "native")


@pytest.fixture
def rng():
    return np.random.default_rng(42)


@pytest.fixture
def rgb(rng):
    return rng.integers(0, 256, (48, 64, 3), np.uint8)


# ------------------------------------------------------------ image codecs


@pytest.mark.parametrize("writer,reader", BOTH_WAYS)
def test_png_roundtrip_exact(tmp_path, rgb, rng, writer, reader):
    w, r = PACKAGES[writer], PACKAGES[reader]
    p = str(tmp_path / "a.png")
    w.write_image_png(p, rgb)
    np.testing.assert_array_equal(r.read_image_png_rgb8(p), rgb)
    rgba = rng.integers(0, 256, (20, 30, 4), np.uint8)
    w.write_image_png(p, rgba)
    np.testing.assert_array_equal(r.read_image_png_rgba8(p), rgba)
    gray = rng.integers(0, 256, (20, 30), np.uint8)
    w.write_image_png(p, gray)
    np.testing.assert_array_equal(r.read_image_png_gray8(p)[:, :, 0], gray)


@pytest.mark.parametrize("writer,reader", BOTH_WAYS)
def test_png_gray16_roundtrip(tmp_path, rng, writer, reader):
    depth = rng.integers(0, 65536, (32, 40), np.uint16)
    p = str(tmp_path / "d.png")
    PACKAGES[writer].write_image_png(p, depth)
    out = PACKAGES[reader].read_image_png_gray16(p)
    assert out.dtype == np.uint16 and out.shape == (32, 40, 1)
    np.testing.assert_array_equal(out[:, :, 0], depth)


def test_jpeg_lossy_corridor_and_bytes(tmp_path):
    """The smooth image of tests/test_io.py: mean error < 4 at q95; both
    packages write the same bytes and decode them to the same array."""
    y, x = np.mgrid[0:48, 0:64]
    img = np.stack([x * 2, y * 3, (x + y)], -1).astype(np.uint8)
    pt, pr = str(tmp_path / "t.jpg"), str(tmp_path / "r.jpg")
    tio.write_image_jpeg(pt, img, quality=95)
    jio.write_image_jpeg(pr, img, quality=95)
    with open(pt, "rb") as a, open(pr, "rb") as b:
        assert a.read() == b.read()
    out = tio.read_image_jpeg_rgb8(pt)
    assert out.shape == img.shape
    assert np.mean(np.abs(out.astype(int) - img.astype(int))) < 4.0
    np.testing.assert_array_equal(out, jio.read_image_jpeg_rgb8(pt))
    np.testing.assert_array_equal(tio.read_image_jpeg_gray8(pt),
                                  jio.read_image_jpeg_gray8(pt))


@pytest.mark.parametrize("writer,reader", BOTH_WAYS)
def test_tiff_roundtrip_keeps_dtype(tmp_path, rng, writer, reader):
    p = str(tmp_path / "a.tif")
    for img in (rng.standard_normal((20, 30)).astype(np.float32),
                rng.integers(0, 65536, (20, 30), np.uint16),
                rng.integers(0, 256, (20, 30, 3), np.uint8)):
        PACKAGES[writer].write_image_tiff(p, img)
        out = PACKAGES[reader].read_image_tiff(p)
        assert out.dtype == img.dtype
        np.testing.assert_array_equal(out.reshape(img.shape), img)


@pytest.mark.parametrize("writer,reader", BOTH_WAYS)
def test_webp_lossless_roundtrip(tmp_path, rgb, writer, reader):
    p = str(tmp_path / "a.webp")
    PACKAGES[writer].write_image_webp(p, rgb, lossless=True)
    np.testing.assert_array_equal(PACKAGES[reader].read_image_webp_rgb8(p),
                                  rgb)


def test_read_any_formats(tmp_path, rgb):
    for name in ("x.png", "x.webp", "x.tif"):
        p = str(tmp_path / name)
        {"png": tio.write_image_png, "tif": tio.write_image_tiff,
         "webp": lambda q, a: tio.write_image_webp(q, a, lossless=True)}[
            name[2:]](p, rgb)
        np.testing.assert_array_equal(tio.read_image_any_rgb8(p), rgb)
        gray = tio.read_image_any_gray8(p)
        assert gray.shape == (48, 64, 1)
        np.testing.assert_array_equal(gray, jio.read_image_any_gray8(p))


def test_exif_orientation_both_packages(tmp_path, rgb):
    """A JPEG tagged with EXIF orientation 6 (rotate 90° CW): both packages
    read the tag and auto-orient to the same array, or keep the stored
    one with ``apply_exif=False``."""
    from PIL import Image as PILImage

    p = str(tmp_path / "o.jpg")
    im = PILImage.fromarray(rgb)
    exif = im.getexif()
    exif[0x0112] = 6
    im.save(p, quality=95, exif=exif.tobytes())
    assert tio.read_exif_orientation(p) == jio.read_exif_orientation(p) == 6
    up = tio.read_image_any_rgb8(p)
    assert up.shape == (64, 48, 3)
    np.testing.assert_array_equal(up, jio.read_image_any_rgb8(p))
    raw = tio.read_image_any_rgb8(p, apply_exif=False)
    assert raw.shape == (48, 64, 3)
    np.testing.assert_array_equal(
        raw, jio.read_image_any_rgb8(p, apply_exif=False))
    tio.write_image_png(str(tmp_path / "n.png"), rgb)
    assert tio.read_exif_orientation(str(tmp_path / "n.png")) == 1


def test_bad_extension_and_dtype_rejected(tmp_path, rgb):
    with pytest.raises(IoError):
        tio.read_image_jpeg_rgb8(str(tmp_path / "a.png"))
    with pytest.raises(IoError):
        tio.write_image_png(str(tmp_path / "a.jpg"), rgb)
    with pytest.raises(IoError, match="u8"):
        tio.write_image_jpeg(str(tmp_path / "a.jpg"), rgb.astype(np.float32))
    with pytest.raises(IoError, match="u8/u16"):
        tio.write_image_png(str(tmp_path / "a.png"), rgb.astype(np.int32))


def test_missing_or_undecodable_file(tmp_path):
    with pytest.raises(IoError, match="does not exist"):
        tio.read_image_any_rgb8(str(tmp_path / "nonexistent.png"))
    bad = tmp_path / "bad.png"
    bad.write_bytes(b"not a png")
    with pytest.raises(IoError, match="cannot decode"):
        tio.read_image_any_rgb8(str(bad))


# ---------------------------------------------------------------- datasets


def _tum(root, rng, writer):
    (root / "rgb").mkdir(parents=True)
    (root / "depth").mkdir()
    rgb_lines, dep_lines, gt_lines = ["# rgb"], ["# depth"], ["# gt"]
    for i in range(3):
        t = 1000.0 + i * 0.05
        writer.write_image_png(str(root / "rgb" / f"{t:.4f}.png"),
                               rng.integers(0, 256, (24, 32, 3), np.uint8))
        writer.write_image_png(str(root / "depth" / f"{t:.4f}.png"),
                               rng.integers(0, 10000, (24, 32)).astype(
                                   np.uint16))
        rgb_lines.append(f"{t:.4f} rgb/{t:.4f}.png")
        dep_lines.append(f"{t + 0.001:.4f} depth/{t:.4f}.png")
        gt_lines.append(f"{t:.4f} {i} 0 0 0 0 0.6 0.8")
    (root / "rgb.txt").write_text("\n".join(rgb_lines) + "\n")
    (root / "depth.txt").write_text("\n".join(dep_lines) + "\n")
    (root / "groundtruth.txt").write_text("\n".join(gt_lines) + "\n")


def _same_frames(a, b):
    assert len(a) == len(b)
    for i in range(len(a)):
        fa, fb = a[i], b[i]
        assert fa.timestamp == fb.timestamp
        for name in ("rgb", "gray", "depth"):
            va, vb = getattr(fa, name), getattr(fb, name)
            assert (va is None) == (vb is None)
            if va is not None:
                assert va.dtype == vb.dtype
                np.testing.assert_array_equal(va, vb)


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_tum_layout(tmp_path, rng, writer):
    root = tmp_path / "tum"
    _tum(root, rng, PACKAGES[writer])
    ds = tio.TumRgbdDataset(str(root))
    assert len(ds) == 3
    fr = ds[1]
    assert fr.rgb.shape == (24, 32, 3)
    assert fr.depth.shape == (24, 32) and fr.depth.dtype == np.float32
    assert ds.groundtruth["poses"].shape == (3, 7)
    # TUM gt is tx ty tz qx qy qz qw → qw first
    np.testing.assert_array_equal(ds.groundtruth["poses"][1],
                                  [0.8, 0, 0, 0.6, 1, 0, 0])
    ref = jio.TumRgbdDataset(str(root))
    _same_frames(ds, ref)
    np.testing.assert_array_equal(ds.groundtruth["poses"],
                                  ref.groundtruth["poses"])


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_kitti_layout(tmp_path, rng, writer):
    root = tmp_path / "kitti"
    img_dir = root / "sequences" / "00" / "image_0"
    img_dir.mkdir(parents=True)
    (root / "poses").mkdir()
    for i in range(2):
        PACKAGES[writer].write_image_png(
            str(img_dir / f"{i:06d}.png"),
            rng.integers(0, 256, (20, 30), np.uint8))
    (root / "sequences" / "00" / "times.txt").write_text("0.0\n0.1\n")
    pose = "1 0 0 0 0 1 0 0 0 0 1 0"
    (root / "poses" / "00.txt").write_text(pose + "\n" + pose + "\n")
    (root / "sequences" / "00" / "calib.txt").write_text(
        "P0: 700 0 600 0 0 700 180 0 0 0 1 0\n")
    ds = tio.KittiOdometryDataset(str(root), "00")
    assert len(ds) == 2
    assert ds[0].gray.shape == (20, 30)
    assert ds.poses.shape == (2, 4, 4)
    assert ds.calib["K"][0, 0] == 700
    ref = jio.KittiOdometryDataset(str(root), "00")
    _same_frames(ds, ref)
    np.testing.assert_array_equal(ds.poses, ref.poses)


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_euroc_layout(tmp_path, rng, writer):
    root = tmp_path / "euroc"
    data_dir = root / "mav0" / "cam0" / "data"
    data_dir.mkdir(parents=True)
    lines = ["#timestamp [ns],filename"]
    for i in range(2):
        ts = 1403636579763555584 + i * 50000000
        PACKAGES[writer].write_image_png(
            str(data_dir / f"{ts}.png"),
            rng.integers(0, 256, (16, 24), np.uint8))
        lines.append(f"{ts},{ts}.png")
    (root / "mav0" / "cam0" / "data.csv").write_text("\n".join(lines) + "\n")
    ds = tio.EurocDataset(str(root))
    assert len(ds) == 2
    assert ds[0].gray.shape == (16, 24)
    assert abs(ds.timestamps[1] - ds.timestamps[0] - 0.05) < 1e-6
    _same_frames(ds, jio.EurocDataset(str(root)))


def test_missing_layouts_raise(tmp_path):
    with pytest.raises(tdatasets.DatasetError):
        tio.TumRgbdDataset(str(tmp_path))
    with pytest.raises(tdatasets.DatasetError):
        tio.EurocDataset(str(tmp_path))
    with pytest.raises(tdatasets.DatasetError):
        tio.KittiOdometryDataset(str(tmp_path))


def test_associate_timestamps():
    from kornia_tpu.io.datasets import associate_timestamps as jassoc

    a = np.array([0.0, 0.1, 0.2])
    b = np.array([0.005, 0.11, 0.35])
    pairs = tdatasets.associate_timestamps(a, b, max_dt=0.02)
    assert pairs.tolist() == [[0, 0], [1, 1]]
    rng = np.random.default_rng(3)
    a, b = np.sort(rng.random(50)), np.sort(rng.random(40))
    np.testing.assert_array_equal(tdatasets.associate_timestamps(a, b, 0.01),
                                  jassoc(a, b, 0.01))


# ---------------------------------------------------------- native capture


def _write_pnm(lib, path, img):
    fn = lib.kornia_image_write_pnm
    fn.restype = ctypes.c_int64
    fn.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint8),
                   ctypes.c_int64, ctypes.c_int64, ctypes.c_int64]
    c = np.ascontiguousarray(img)
    ch = 1 if c.ndim == 2 else c.shape[2]
    assert fn(path.encode(), c.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
              c.shape[0], c.shape[1], ch) == 0


def test_dir_capture_roundtrip(tmp_path):
    """The port's library writes PPM frames; NativeCapture over the
    directory returns them in order and loops past the end."""
    lib = load_native_library()
    rng = np.random.default_rng(0)
    frames = [rng.integers(0, 256, (48, 64, 3), np.uint8) for _ in range(3)]
    for i, f in enumerate(frames):
        _write_pnm(lib, str(tmp_path / f"f{i}.ppm"), f)
    with tio.NativeCapture("dir:" + str(tmp_path)) as cap:
        for i in range(5):
            np.testing.assert_array_equal(cap.grab_frame(), frames[i % 3])


def test_dir_capture_gray_promotes_to_rgb(tmp_path):
    lib = load_native_library()
    g = np.random.default_rng(1).integers(0, 256, (32, 40), np.uint8)
    _write_pnm(lib, str(tmp_path / "g.pgm"), g)
    with tio.NativeCapture(str(tmp_path)) as cap:    # bare dir uri
        rgb = cap.grab_frame()
    assert rgb.shape == (32, 40, 3)
    for c in range(3):
        np.testing.assert_array_equal(rgb[:, :, c], g)


def test_capture_reads_the_reference_frames(tmp_path):
    """Frames written by the reference's native library read back
    through the port's capture equal."""
    from kornia_tpu.native import load_native_library as jload

    jlib = jload()
    if jlib is None:
        pytest.skip("the reference's native library did not build")
    f = np.random.default_rng(2).integers(0, 256, (24, 36, 3), np.uint8)
    _write_pnm(jlib, str(tmp_path / "r.ppm"), f)
    with tio.NativeCapture("dir:" + str(tmp_path)) as cap:
        np.testing.assert_array_equal(cap.grab_frame(), f)


def test_missing_device_errors_cleanly():
    with pytest.raises(tio.VideoError, match="video99"):
        tio.NativeCapture("v4l2:/dev/video99")
    with pytest.raises(tio.VideoError):
        tio.NativeCapture("dir:/nonexistent_dir_xyz")


def test_capture_without_the_library_raises(tmp_path, monkeypatch):
    """A library that does not build raises VideoError (no other route)."""
    monkeypatch.setattr(tbuild, "CXX", "definitely-not-a-compiler")
    monkeypatch.setattr(tbuild, "BUILD_DIR", str(tmp_path / "fresh"))
    monkeypatch.setattr(tbuild, "_lib", None)
    with pytest.raises(tio.VideoError, match="unavailable"):
        tio.NativeCapture("dir:" + str(tmp_path))


# ------------------------------------------------------------ MJPEG / AVI


def _frames(n=6, h=48, w=64):
    """Smooth gradients + a moving square: JPEG-friendly content."""
    yy, xx = np.mgrid[0:h, 0:w]
    out = []
    for i in range(n):
        f = np.stack([(xx * 255 / (w - 1)), (yy * 255 / (h - 1)),
                      np.full((h, w), 40.0 + 20 * i)], axis=-1).astype(
            np.uint8)
        x0 = 4 + 6 * i
        f[10:30, x0:x0 + 12] = (220, 40, 40)
        out.append(f)
    return out


MJPEG = {"port": tmjpeg, "reference": jmjpeg}


def _write_avi(pkg, path, frames, fps=12.5, quality=95, fmt="rgb8"):
    h, w = frames[0].shape[:2]
    with MJPEG[pkg].MjpegWriter(path, fps=fps, size_hw=(h, w),
                                pixel_format=fmt, quality=quality) as wtr:
        for f in frames:
            wtr.write(f)


@pytest.mark.parametrize("fmt", ["rgb8", "mono8"])
def test_mjpeg_files_byte_equal(tmp_path, fmt):
    frames = _frames()
    if fmt == "mono8":
        frames = [f[..., 0] for f in frames]
    pt, pr = str(tmp_path / "t.avi"), str(tmp_path / "r.avi")
    _write_avi("port", pt, frames, fmt=fmt)
    _write_avi("reference", pr, frames, fmt=fmt)
    with open(pt, "rb") as a, open(pr, "rb") as b:
        assert a.read() == b.read()


@pytest.mark.parametrize("writer,reader", BOTH_WAYS)
def test_mjpeg_roundtrip_both_ways(tmp_path, writer, reader):
    frames = _frames()
    path = str(tmp_path / "own.avi")
    _write_avi(writer, path, frames)
    r = MJPEG[reader].MjpegReader(path)
    ref = jmjpeg.MjpegReader(path)
    assert r.n_frames == len(frames)
    assert abs(r.fps - 12.5) < 1e-3
    assert r.size == (48, 64)
    for f in frames:
        got = r.read()
        assert got.shape == f.shape
        assert np.abs(got.astype(int) - f.astype(int)).mean() < 12
        np.testing.assert_array_equal(got, ref.read())
    assert r.read() is None
    r.release()
    ref.release()


def test_cv2_reads_our_file(tmp_path):
    cv2 = pytest.importorskip("cv2")
    frames = _frames()
    path = str(tmp_path / "ours_for_cv2.avi")
    _write_avi("port", path, frames, fps=30.0)
    cap = cv2.VideoCapture(path)
    assert cap.isOpened(), "cv2 cannot open the port's AVI"
    assert int(cap.get(cv2.CAP_PROP_FRAME_COUNT)) == len(frames)
    assert abs(cap.get(cv2.CAP_PROP_FPS) - 30.0) < 0.1
    n = 0
    while True:
        ok, bgr = cap.read()
        if not ok:
            break
        rgb = cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB)
        assert np.abs(rgb.astype(int) - frames[n].astype(int)).mean() < 12
        n += 1
    assert n == len(frames)
    cap.release()


def test_we_read_cv2_file(tmp_path):
    cv2 = pytest.importorskip("cv2")
    frames = _frames()
    path = str(tmp_path / "cv2_for_us.avi")
    vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), 25.0,
                         (64, 48))
    assert vw.isOpened()
    for f in frames:
        vw.write(cv2.cvtColor(f, cv2.COLOR_RGB2BGR))
    vw.release()
    r = tmjpeg.MjpegReader(path)
    ref = jmjpeg.MjpegReader(path)
    assert r.n_frames == ref.n_frames == len(frames)
    assert abs(r.fps - 25.0) < 0.1
    for f in frames:
        got = r.read()
        assert np.abs(got.astype(int) - f.astype(int)).mean() < 15
        np.testing.assert_array_equal(got, ref.read())


def test_gray_and_seek(tmp_path):
    frames = [f[..., 0] for f in _frames()]
    path = str(tmp_path / "gray.avi")
    _write_avi("reference", path, frames, fps=10, quality=92, fmt="mono8")
    r = tmjpeg.MjpegReader(path, pixel_format="mono8")
    r.seek_frame(3)
    got = r.read()
    assert got.ndim == 2
    assert np.abs(got.astype(int) - frames[3].astype(int)).mean() < 12
    r.seek_frame(100)
    assert r.read() is None
    r.seek_frame(-5)
    np.testing.assert_array_equal(r.read(), list(tmjpeg.MjpegReader(
        path, pixel_format="mono8"))[0])


def test_videowriter_mjpg_codec_routes_to_the_container(tmp_path):
    frames = _frames(3)
    path = str(tmp_path / "via_api.avi")
    with tio.VideoWriter(path, fps=15, size_hw=(48, 64), codec="mjpg") as w:
        for f in frames:
            w.write(f)
        with pytest.raises(tio.VideoError, match="size"):
            w.write(np.zeros((8, 8, 3), np.uint8))
    assert tmjpeg.is_mjpeg_avi(path)
    pr = str(tmp_path / "ref.avi")
    with jio.VideoWriter(pr, fps=15, size_hw=(48, 64), codec="mjpg") as w:
        for f in frames:
            w.write(f)
    with open(path, "rb") as a, open(pr, "rb") as b:
        assert a.read() == b.read()
    with tio.VideoReader(path) as r:
        assert r.read() is not None


def test_video_without_cv2_takes_the_container(tmp_path, monkeypatch):
    """Where cv2 cannot be imported, VideoReader/VideoWriter use the
    MJPEG AVI container (the reference's contract), other files raise,
    and cameras need cv2."""
    monkeypatch.setattr(tvideo, "_cv2_or_none", lambda: None)
    frames = _frames(4)
    path = str(tmp_path / "no_cv2.avi")
    with tio.VideoWriter(path, fps=10, size_hw=(48, 64)) as w:  # mp4v asked
        for f in frames:
            w.write(f)
    assert tmjpeg.is_mjpeg_avi(path)
    with tio.VideoReader(path) as r:
        assert (r.n_frames, r.size, r.fps) == (4, (48, 64), 10.0)
        r.seek_frame(2)
        np.testing.assert_array_equal(
            r.read(), list(jmjpeg.MjpegReader(path))[2])
        assert len(list(r)) == 1
    other = tmp_path / "clip.mp4"
    other.write_bytes(b"\x00\x00\x00\x18ftypmp42")
    with pytest.raises(tio.VideoError, match="without cv2"):
        tio.VideoReader(str(other))
    with pytest.raises(tio.VideoError, match="OpenCV"):
        tio.CameraCapture(0)


def test_video_reader_writer_cv2_roundtrip(tmp_path):
    """cv2's mp4v writer and reader through the port (as
    tests/test_native_cpp.py holds the reference's)."""
    pytest.importorskip("cv2")
    frames = [np.full((48, 64, 3), i * 30, np.uint8) for i in range(5)]
    path = str(tmp_path / "clip.mp4")
    with tio.VideoWriter(path, fps=10, size_hw=(48, 64)) as w:
        for f in frames:
            w.write(f)
    with tio.VideoReader(path) as r:
        assert r.size == (48, 64)
        assert r.n_frames == 5
        got = list(r)
    assert len(got) == 5
    ref = list(jio.VideoReader(path))
    for orig, dec, rdec in zip(frames, got, ref):
        assert abs(int(orig[0, 0, 0]) - int(dec[0, 0, 0])) < 12  # lossy
        np.testing.assert_array_equal(dec, rdec)


def test_mjpeg_bad_inputs(tmp_path):
    path = str(tmp_path / "bad.avi")
    with open(path, "wb") as f:
        f.write(b"not an avi at all")
    with pytest.raises(ValueError, match="RIFF"):
        tmjpeg.MjpegReader(path)
    assert not tmjpeg.is_mjpeg_avi(path)
    assert not tmjpeg.is_mjpeg_avi(str(tmp_path / "missing.avi"))
    w = tmjpeg.MjpegWriter(str(tmp_path / "w.avi"), 10, (8, 8))
    with pytest.raises(ValueError, match="shape"):
        w.write(np.zeros((9, 8, 3), np.uint8))
    w.release()
    w.release()  # idempotent
    with pytest.raises(ValueError, match="closed"):
        w.write(np.zeros((8, 8, 3), np.uint8))
    with pytest.raises(ValueError, match="pixel_format"):
        tmjpeg.MjpegWriter(str(tmp_path / "x.avi"), 10, (8, 8), "yuv")
    with pytest.raises(ValueError, match="fps"):
        tmjpeg.MjpegWriter(str(tmp_path / "x.avi"), 0, (8, 8))


def test_mjpeg_truncated_header_rejected(tmp_path):
    path = str(tmp_path / "full.avi")
    _write_avi("port", path, [np.zeros((8, 8, 3), np.uint8)])
    with open(path, "rb") as f:
        data = f.read()
    cut = str(tmp_path / "cut.avi")
    with open(cut, "wb") as f:
        f.write(data[:40])  # cut inside the avih chunk
    with pytest.raises(ValueError, match="truncated|corrupted"):
        tmjpeg.MjpegReader(cut)


# ------------------------------------------------------------------- Arrow


@pytest.mark.parametrize("exporter", ["port", "reference"])
def test_arrow_roundtrip_across_packages(exporter):
    """The reference's wire schema both ways: an image exported by either
    package imports into the other, pixels and shape equal."""
    pa = pytest.importorskip("pyarrow")
    from kornia_tpu.image import Image as JImage

    from kornia_tpu_torch.image import ColorSpace, Image

    host = np.random.default_rng(0).integers(0, 256, (33, 47, 3), np.uint8)
    if exporter == "port":
        arr = Image.from_numpy(host, device="cpu").to_arrow()
        back = JImage.from_arrow(arr).numpy()
    else:
        arr = JImage.from_numpy(host).to_arrow()
        img = Image.from_arrow(arr, color_space=ColorSpace.RGB, device="cpu")
        assert img.color_space is ColorSpace.RGB
        back = img.numpy()
    assert isinstance(arr, pa.StructArray)
    assert [arr.type.field(i).name for i in range(4)] == [
        "width", "height", "channels", "data"]
    np.testing.assert_array_equal(back, host)
    np.testing.assert_array_equal(
        Image.from_arrow(pa.chunked_array([arr]), device="cpu").numpy(),
        host)


def test_arrow_export_wraps_the_pixels_and_checks_inputs():
    pa = pytest.importorskip("pyarrow")
    from kornia_tpu_torch.image import Image, ImageLayout

    arr = Image.from_numpy(np.zeros((8, 8, 3), np.uint8),
                           device="cpu").to_arrow()
    assert arr.field("data").buffers()[2].size == 8 * 8 * 3
    with pytest.raises(ValueError, match="u8"):
        Image(torch.zeros(4, 4, 3)).to_arrow()
    with pytest.raises(ValueError, match="HWC"):
        Image(torch.zeros(3, 4, 4, dtype=torch.uint8),
              layout=ImageLayout.CHW).to_arrow()
    with pytest.raises(ValueError, match="Struct"):
        Image.from_arrow(pa.array([1, 2, 3]), device="cpu")


# ------------------------------------------------------------- C++ surface


def _run(cmd, **kw):
    out = subprocess.run(cmd, capture_output=True, text=True, **kw)
    assert out.returncode == 0, f"{cmd}: {out.stdout}{out.stderr}"
    return out


@pytest.mark.skipif(shutil.which("g++") is None, reason="no g++")
def test_cpp_consumer(tmp_path):
    """tests/test_native.cpp against the port's C API: RVL, CCL and the
    AprilTag quads."""
    exe = str(tmp_path / "test_native")
    srcs = [os.path.join(NATIVE, "tests", "test_native.cpp")] + [
        os.path.join(NATIVE, s) for s in ("rvl.cpp", "ccl.cpp",
                                          "apriltag_mid.cpp")]
    _run(["g++", "-O2", "-std=c++17", "-o", exe, *srcs])
    assert "NATIVE CPP TESTS PASSED" in _run([exe]).stdout


@pytest.mark.skipif(shutil.which("g++") is None, reason="no g++")
def test_cpp_library_surface(tmp_path):
    """A C++ consumer of the header-only wrapper, linked against the
    library the port builds: image type, PNM io, gray, RVL, CCL."""
    src = tmp_path / "consumer.cpp"
    src.write_text(textwrap.dedent("""
        #include <kornia_tpu.hpp>
        #include <cstdio>
        int main() {
          kornia::ImageU8 img;
          img.rows = 4; img.cols = 6; img.channels = 3;
          img.data.resize(72);
          for (int i = 0; i < 72; ++i) img.data[i] = (uint8_t)(i * 3);
          kornia::write_image_pnm("IMG.ppm", img);
          auto back = kornia::read_image_pnm("IMG.ppm");
          if (back.data != img.data) return 1;
          auto gray = kornia::gray_from_rgb(back);
          if (gray.channels != 1) return 2;
          std::vector<uint16_t> d(64, 3); d[10] = 500;
          if (kornia::rvl_decompress(kornia::rvl_compress(d), 64) != d)
            return 3;
          kornia::ImageU8 m; m.rows = 2; m.cols = 3; m.channels = 1;
          m.data = {1, 0, 1, 1, 0, 1};
          int64_t k = 0;
          kornia::ccl_label(m, 4, &k);
          if (k != 2) return 4;
          std::puts("CPP SURFACE OK");
          return 0;
        }
    """))
    exe = tmp_path / "consumer"
    lib = tbuild.lib_path()
    load_native_library()
    _run(["g++", "-O1", "-std=c++17", f"-I{os.path.join(NATIVE, 'include')}",
          str(src), lib, f"-Wl,-rpath,{os.path.dirname(lib)}", "-o",
          str(exe)])
    assert "CPP SURFACE OK" in _run([str(exe)], cwd=tmp_path).stdout


@pytest.mark.skipif(shutil.which("cmake") is None, reason="no cmake")
def test_cmake_package_consumer(tmp_path):
    """The CMake package end to end: build and install
    kornia_tpu_torch::native to a prefix, configure a consumer through
    find_package(kornia_tpu_torch), run it."""
    prefix, build = tmp_path / "prefix", tmp_path / "build"
    _run(["cmake", "-S", NATIVE, "-B", str(build),
          "-DCMAKE_BUILD_TYPE=Release"])
    _run(["cmake", "--build", str(build), "-j2"])
    _run(["cmake", "--install", str(build), "--prefix", str(prefix)])
    consumer = tmp_path / "consumer"
    consumer.mkdir()
    (consumer / "main.cpp").write_text(textwrap.dedent("""
        #include <kornia_tpu.hpp>
        #include <cstdio>
        int main() {
          std::vector<uint16_t> d(64, 7); d[3] = 900;
          if (kornia::rvl_decompress(kornia::rvl_compress(d), 64) != d)
            return 1;
          std::puts("CMAKE CONSUMER OK");
          return 0;
        }
    """))
    (consumer / "CMakeLists.txt").write_text(textwrap.dedent("""
        cmake_minimum_required(VERSION 3.16)
        project(consumer CXX)
        find_package(kornia_tpu_torch REQUIRED)
        add_executable(app main.cpp)
        target_link_libraries(app PRIVATE kornia_tpu_torch::native)
    """))
    cbuild = tmp_path / "cbuild"
    _run(["cmake", "-S", str(consumer), "-B", str(cbuild),
          f"-DCMAKE_PREFIX_PATH={prefix}"])
    _run(["cmake", "--build", str(cbuild)])
    assert "CMAKE CONSUMER OK" in _run([str(cbuild / "app")]).stdout
