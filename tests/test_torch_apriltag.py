"""The port's AprilTag path, dense and host CCL and contours
(kornia_tpu_torch/apriltag/, ops/connected_components.py, ops/contours.py,
native/) against the JAX package, run as its own tests run it on the CPU.

Tolerances: the threshold, the dense CCL at every ``max_sweeps``, the host
CCL, the contours, tag ids, hamming and the quad and detection counts are
exact. Corners, centres, homographies, decision margins and poses are held
within 1e-9: both packages run the same float64 numpy on equal inputs (the
threshold images are equal), so they agree to the last bit in practice and
the bound only leaves room for BLAS summation order. Each mid-pipeline
route (native C++, numpy) is held to the reference's same route.
"""

import dataclasses
import hashlib
import os
import re
import subprocess
import sys

import cv2
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import kornia_tpu.native as jnative
from kornia_tpu import apriltag as jat
from kornia_tpu.apriltag import detector as jdet
from kornia_tpu.ops import connected_components as jccl
from kornia_tpu.ops import contours as jcont

from kornia_tpu_torch import apriltag as tat
from kornia_tpu_torch.apriltag import detector as tdet
from kornia_tpu_torch.native import build as tbuild
from kornia_tpu_torch.ops import connected_components as tccl
from kornia_tpu_torch.ops import contours as tcont

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-9   # float64 host numpy on equal inputs in both packages


def _blocky(seed, shape, cell=5, sigma=8.0, flat=True):
    """Blocky noise plus pixel noise, with a flat patch (low contrast, so
    the threshold emits UNKNOWN there)."""
    rng = np.random.default_rng(seed)
    h, w = shape
    base = rng.integers(0, 256, (h // cell + 1, w // cell + 1))
    up = np.kron(base, np.ones((cell, cell)))[:h, :w]
    img = up + rng.normal(0, sigma, up.shape)
    if flat:
        img[h // 5: 4 * h // 5, w // 5: 3 * w // 5] = 100.0
    return np.clip(img, 0, 255).astype(np.uint8)


# ------------------------------------------------------------ threshold


@pytest.mark.parametrize("shape", [(61, 83), (64, 96)])
@pytest.mark.parametrize("tile", [4, 8])
@pytest.mark.parametrize("split", [0.33, 0.5, 0.6])
def test_adaptive_threshold_exact(shape, tile, split):
    g = _blocky(1, shape)
    ref = np.asarray(jat.adaptive_threshold(jnp.asarray(g), tile, 5, split))
    got = tat.adaptive_threshold(g, tile, 5, split, device="cpu")
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), ref)
    assert set(np.unique(ref)) == {0, tat.threshold.UNKNOWN, 255}


def test_adaptive_threshold_three_channels_and_contrast():
    """A 3-channel input takes channel 0; a higher contrast floor."""
    g = np.stack([_blocky(2, (52, 70), sigma=3.0), _blocky(3, (52, 70)),
                  _blocky(4, (52, 70))], -1)
    for diff in (5, 40):
        ref = np.asarray(jat.adaptive_threshold(jnp.asarray(g), 4, diff,
                                                0.6))
        got = tat.adaptive_threshold(torch.as_tensor(g), 4, diff, 0.6,
                                     device="cpu")
        np.testing.assert_array_equal(got.numpy(), ref)


# ------------------------------------------------------------ dense CCL


def _spiral(n=40):
    """A one-pixel-wide square spiral: every turn costs a sweep."""
    m = np.zeros((n, n), np.uint8)
    top, left, bottom, right = 0, 0, n - 1, n - 1
    while top <= bottom and left <= right:
        m[top, left:right + 1] = 1
        m[top:bottom + 1, right] = 1
        m[bottom, left:right + 1] = 1
        if top + 2 <= bottom:
            m[top + 2:bottom + 1, left] = 1
        top, left, bottom, right = top + 2, left + 2, bottom - 2, right - 2
        if left - 1 >= 0 and top <= bottom:
            m[top, left - 1] = 1
    return m


def _dense_masks():
    rng = np.random.default_rng(5)
    return {"random": (rng.random((40, 40)) < 0.55).astype(np.uint8),
            "spiral": _spiral()}


@pytest.mark.parametrize("connectivity", [4, 8])
@pytest.mark.parametrize("max_sweeps", [1, 2, 64])
@pytest.mark.parametrize("which", ["random", "spiral"])
def test_connected_components_exact(connectivity, max_sweeps, which):
    mask = _dense_masks()[which]
    ref = np.asarray(jccl.connected_components(
        jnp.asarray(mask), connectivity, max_sweeps))
    got = tccl.connected_components(mask, connectivity, max_sweeps,
                                    device="cpu")
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)


def test_connected_components_cap_lands_on_the_count():
    """The spiral does not converge in 1 or 2 loop sweeps, and converges
    within 64: the sweep count is 1 + the cap there, fewer here."""
    m = torch.as_tensor(_spiral())
    for cap in (1, 2):
        _, sweeps = tccl._labels_sweeps(m, 4, cap)
        assert sweeps == 1 + cap
    full, sweeps = tccl._labels_sweeps(m, 4, 64)
    assert 3 < sweeps < 65
    capped, _ = tccl._labels_sweeps(m, 4, 2)
    assert not torch.equal(full, capped)
    np.testing.assert_array_equal(
        tccl.relabel_sequential(full),
        tccl.connected_components_host(m.numpy(), 4))


def test_connected_components_rejects():
    with pytest.raises(ValueError):
        tccl.connected_components(np.zeros((2, 3, 4)), device="cpu")
    with pytest.raises(ValueError):
        tccl.connected_components(np.zeros((3, 4)), 6, device="cpu")


def test_relabel_sequential_exact():
    mask = _dense_masks()["random"]
    lab = np.asarray(jccl.connected_components(jnp.asarray(mask), 8, 64))
    np.testing.assert_array_equal(tccl.relabel_sequential(lab),
                                  jccl.relabel_sequential(lab))
    np.testing.assert_array_equal(
        tccl.relabel_sequential(torch.as_tensor(lab.copy())),
        jccl.relabel_sequential(lab))


# ------------------------------------------------------------- host CCL


@pytest.fixture
def reference_numpy_route(monkeypatch):
    """The reference's numpy fallbacks: its native loader returns None."""
    monkeypatch.setattr(jnative, "load_native_library", lambda: None)


@pytest.mark.parametrize("connectivity", [4, 8])
def test_connected_components_host_exact(connectivity):
    rng = np.random.default_rng(6)
    mask = (rng.random((64, 80)) < 0.4).astype(np.uint8)
    got = tccl.connected_components_host(mask, connectivity)
    np.testing.assert_array_equal(
        got, jccl.connected_components_host(mask, connectivity))
    np.testing.assert_array_equal(tccl._ccl_numpy(mask, connectivity),
                                  jccl._ccl_numpy(mask, connectivity))
    np.testing.assert_array_equal(tccl._ccl_numpy(mask, connectivity), got)


def test_label_classes_host_native_route():
    t = np.asarray(jat.adaptive_threshold(
        jnp.asarray(_blocky(7, (60, 72))), 4, 5, 0.6))
    np.testing.assert_array_equal(tccl.label_classes_host(t, 127),
                                  jccl.label_classes_host(t, 127))


def test_label_classes_host_numpy_route(reference_numpy_route):
    t = np.asarray(jat.adaptive_threshold(
        jnp.asarray(_blocky(8, (48, 56))), 4, 5, 0.6))
    ref = jccl.label_classes_host(t, 127)       # the reference's numpy route
    got = tccl._label_classes_numpy(t, 127)
    np.testing.assert_array_equal(got, ref)
    # the same partition as the native route, numbered another way
    nat = tccl.label_classes_host(t, 127)
    pairs = set(zip(got.ravel().tolist(), nat.ravel().tolist()))
    assert len(pairs) == len({a for a, _ in pairs}) == len(
        {b for _, b in pairs})


# ------------------------------------------------------------- contours


def _blobs():
    rng = np.random.default_rng(9)
    small = (rng.random((12, 15)) < 0.45).astype(np.uint8)
    m = np.kron(small, np.ones((4, 4), np.uint8))
    m[3, 3] = 1                                  # an isolated pixel
    m[20:30, 30:45] = 1
    return m


@pytest.mark.parametrize("connectivity", [4, 8])
def test_contours_exact(connectivity):
    mask = _blobs()
    ref = jcont.find_contours(mask, connectivity)
    got = tcont.find_contours(mask, connectivity)
    assert len(got) == len(ref) > 5
    for c_ref, c in zip(ref, got):
        np.testing.assert_array_equal(c, c_ref)
        assert tcont.contour_area(c) == jcont.contour_area(c_ref)
        for closed in (True, False):
            assert (tcont.contour_perimeter(c, closed)
                    == jcont.contour_perimeter(c_ref, closed))
        for eps in (0.5, 1.5):
            np.testing.assert_array_equal(tcont.approx_polygon(c, eps),
                                          jcont.approx_polygon(c_ref, eps))


# ------------------------------------------------------------- families


def test_families_exact():
    for name in tat.FAMILY_NAMES:
        ref, got = jat.get_family(name), tat.get_family(name)
        for f in dataclasses.fields(ref):
            a, b = getattr(ref, f.name), getattr(got, f.name)
            if isinstance(a, np.ndarray) or a is None:
                np.testing.assert_array_equal(b, a)
            else:
                assert a == b, (name, f.name)
        assert got.max_safe_hamming == ref.max_safe_hamming
        np.testing.assert_array_equal(got.bit_centers_tag(),
                                      ref.bit_centers_tag())
        for tag_id in (0, len(got.codes) - 1):
            np.testing.assert_array_equal(tat.render_tag(got, tag_id, 3),
                                          jat.render_tag(ref, tag_id, 3))
    fam, jfam = tat.get_family("tag36h11"), jat.get_family("tag36h11")
    code = int(fam.codes[100]) ^ (1 << 3) ^ (1 << 20)
    assert fam.match(code, 2) == jfam.match(code, 2) == (100, 2, 0)
    assert fam.rotate_code(code, 1) == jfam.rotate_code(code, 1)
    assert fam.match(fam.rotate_code(int(fam.codes[5]), 1), 2) == \
        jfam.match(jfam.rotate_code(int(jfam.codes[5]), 1), 2)
    with pytest.raises(ValueError):
        fam.match(0, max_hamming=6)
    with pytest.raises(ValueError):
        tat.get_family("tag99h99")


def test_detector_config_fields_equal():
    ref, got = jat.DetectorConfig(), tat.DetectorConfig()
    assert [f.name for f in dataclasses.fields(got)] == \
        [f.name for f in dataclasses.fields(ref)]
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)
    assert got.threshold_split == 0.6


def _sha(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


@pytest.mark.parametrize("rel", [
    *(f"apriltag/families/{n}.json" for n in tat.FAMILY_NAMES),
    "native/ccl.cpp", "native/apriltag_mid.cpp", "native/rvl.cpp"])
def test_copies_equal_the_reference(rel):
    assert _sha(os.path.join(ROOT, "kornia_tpu_torch", rel)) == \
        _sha(os.path.join(ROOT, "kornia_tpu", rel))


# -------------------------------------------------------------- scenes


def _canvas(fam, tag_id, scale=12, size=300, pos=(90, 80)):
    tag = jat.render_tag(fam, tag_id, scale=scale)
    canvas = np.full((size, size), 255, np.uint8)
    canvas[pos[0]: pos[0] + tag.shape[0], pos[1]: pos[1] + tag.shape[1]] = tag
    return canvas


def _perspective():
    tag = jat.render_tag(jat.get_family("tag36h11"), 42, scale=20)
    s = tag.shape[0]
    src = np.array([[0, 0], [s, 0], [s, s], [0, s]], np.float32)
    dst = np.array([[140, 90], [430, 120], [460, 380], [110, 350]],
                   np.float32)
    h, _ = cv2.findHomography(src, dst)
    return cv2.warpPerspective(tag, h, (560, 480), borderValue=255)


def _three():
    fam = jat.get_family("tag36h11")
    canvas = np.full((300, 560), 255, np.uint8)
    for i, tag_id in enumerate((3, 17, 99)):
        tag = jat.render_tag(fam, tag_id, scale=10)
        canvas[100:100 + tag.shape[0],
               30 + 180 * i: 30 + 180 * i + tag.shape[1]] = tag
    return canvas


def _scene(name):
    fam = jat.get_family("tag36h11")
    if name.startswith("tag-"):
        return _canvas(fam, int(name[4:])), ("tag36h11",), 2, 1
    if name.startswith("rot"):
        return np.rot90(_canvas(fam, 5), int(name[3:])).copy(), \
            ("tag36h11",), 2, 1
    if name == "perspective":
        return _perspective(), ("tag36h11",), 2, 1
    if name == "noise":
        rng = np.random.default_rng(0)
        c = _canvas(fam, 9).astype(np.int16)
        return np.clip(c + rng.normal(0, 12, c.shape), 0, 255).astype(
            np.uint8), ("tag36h11",), 2, 1
    if name == "three":
        return _three(), ("tag36h11",), 2, 1
    if name == "tag16h5":
        return _canvas(jat.get_family("tag16h5"), 11, scale=16), \
            ("tag16h5",), 0, 1
    if name == "empty":
        return np.full((120, 120), 255, np.uint8), ("tag36h11",), 2, 1
    if name == "decimate2":
        return _three(), ("tag36h11",), 2, 2
    raise KeyError(name)


SCENES = ["tag-0", "tag-23", "tag-111", "tag-586", "rot1", "rot2", "rot3",
          "perspective", "noise", "three", "tag16h5", "empty", "decimate2"]


def _counts(text):
    """(quads, detections) of the last stage-table line."""
    found = re.findall(r"\((\d+) quads, (\d+) det\)", text)
    assert found, text
    return tuple(int(v) for v in found[-1])


def _detections_equal(ref, got):
    assert [(d.tag_id, d.family, d.hamming) for d in got] == \
        [(d.tag_id, d.family, d.hamming) for d in ref]
    for a, b in zip(ref, got):
        np.testing.assert_allclose(b.corners, a.corners, rtol=0, atol=TOL)
        np.testing.assert_allclose(b.center, a.center, rtol=0, atol=TOL)
        np.testing.assert_allclose(b.homography, a.homography, rtol=0,
                                   atol=TOL)
        assert abs(b.decision_margin - a.decision_margin) <= TOL


@pytest.mark.parametrize("route", ["native", "numpy"])
@pytest.mark.parametrize("scene", SCENES)
def test_decode_equals_reference(scene, route, monkeypatch, capsys):
    img, families, max_h, decimate = _scene(scene)
    monkeypatch.setenv("KORNIA_TPU_APRILTAG_MID", route)
    monkeypatch.setenv("KORNIA_TPU_APRILTAG_TRACE", "1")
    kw = dict(families=families, max_hamming=max_h, quad_decimate=decimate)
    ref = jat.AprilTagDecoder(jat.DetectorConfig(**kw)).decode(img)
    ref_err = capsys.readouterr().err
    dec = tat.AprilTagDecoder(tat.DetectorConfig(**kw), device="cpu")
    got = dec.decode(img)
    err = capsys.readouterr().err
    _detections_equal(ref, got)
    # both print the stage table, or neither (the numpy route returns
    # early when there is no boundary point)
    assert ("apriltag stages" in err) == ("apriltag stages" in ref_err)
    if "apriltag stages" in ref_err:
        assert _counts(err) == _counts(ref_err)
        assert "threshold[cpu]" in err and "readback" in err
        assert set(dec.last_trace) >= {"threshold[cpu]", "readback",
                                       "decode[host]", "dedup[host]"}
    if scene != "empty":
        assert got, scene
    # a tensor input, and a 3-channel one, give the same detections
    _detections_equal(ref, dec.decode(torch.as_tensor(img)))
    _detections_equal(ref, dec.decode(np.stack([img, img * 0, img], -1)))


def test_decode_reference_expectations():
    """The reference tests' own expectations, on the port."""
    dec = tat.AprilTagDecoder(device="cpu")
    fam = jat.get_family("tag36h11")
    for tag_id in (0, 23, 111, 586):
        ds = dec.decode(_canvas(fam, tag_id))
        assert [(d.tag_id, d.hamming) for d in ds] == [(tag_id, 0)]
    assert sorted(d.tag_id for d in dec.decode(_three())) == [3, 17, 99]
    d = dec.decode(_canvas(fam, 77))[0]
    p = d.homography @ np.array([-1.0, -1.0, 1.0])
    np.testing.assert_allclose(p[:2] / p[2], d.corners[0], atol=1e-6)
    assert dec.decode(np.full((120, 120), 255, np.uint8)) == []


# ----------------------------------------------------------------- pose


def _pose_scene():
    """tests/test_apriltag.py's synthetic pose scene."""
    k = np.array([[600.0, 0, 320], [0, 600.0, 240], [0, 0, 1]])
    th = np.deg2rad(25)
    r_true = np.array([[1, 0, 0], [0, np.cos(th), -np.sin(th)],
                       [0, np.sin(th), np.cos(th)]])
    t_true = np.array([0.05, -0.03, 1.0])
    size = 0.16
    half = size / 2
    obj = np.array([[-half, -half, 0], [half, -half, 0],
                    [half, half, 0], [-half, half, 0]])
    cam = obj @ r_true.T + t_true
    px = cam @ k.T
    px = px[:, :2] / px[:, 2:]
    tag = jat.render_tag(jat.get_family("tag36h11"), 7, scale=20)
    s = tag.shape[0]
    src = np.array([[s * .1, s * .1], [s * .9, s * .1],
                    [s * .9, s * .9], [s * .1, s * .9]], np.float32)
    h, _ = cv2.findHomography(src, px.astype(np.float32))
    canvas = cv2.warpPerspective(tag, h, (640, 480), borderValue=255)
    return canvas, k, size, r_true, t_true


def _pair_equal(ref, got):
    for a, b in ((ref.best, got.best), (ref.alternate, got.alternate)):
        np.testing.assert_allclose(b.rotation, a.rotation, rtol=0, atol=TOL)
        np.testing.assert_allclose(b.translation, a.translation, rtol=0,
                                   atol=TOL)
        assert abs(b.error - a.error) <= TOL
    assert abs(got.ambiguity - ref.ambiguity) <= TOL


def test_estimate_tag_pose_equals_reference():
    canvas, k, size, r_true, t_true = _pose_scene()
    ref_d = jat.AprilTagDecoder().decode(canvas)
    got_d = tat.AprilTagDecoder(device="cpu").decode(canvas)
    _detections_equal(ref_d, got_d)
    ref = jat.estimate_tag_pose(ref_d[0], k, size)
    got = tat.estimate_tag_pose(got_d[0], k, size)
    _pair_equal(ref, got)
    r_err = np.rad2deg(np.arccos(np.clip(
        (np.trace(got.best.rotation @ r_true.T) - 1) / 2, -1, 1)))
    assert r_err < 2.0
    assert np.linalg.norm(got.best.translation - t_true) < 0.01
    # the same function on the reference's detection object
    _pair_equal(ref, tat.estimate_tag_pose(ref_d[0], k, size))


def test_estimate_tag_pose_frontal_equals_reference():
    k = np.array([[600.0, 0, 320], [0, 600.0, 240], [0, 0, 1]])
    tag = jat.render_tag(jat.get_family("tag36h11"), 3, scale=12)
    canvas = np.full((480, 640), 255, np.uint8)
    canvas[180: 180 + tag.shape[0], 260: 260 + tag.shape[1]] = tag
    ref_d = jat.AprilTagDecoder().decode(canvas)[0]
    got_d = tat.AprilTagDecoder(device="cpu").decode(canvas)[0]
    _pair_equal(jat.estimate_tag_pose(ref_d, k, 0.1),
                tat.estimate_tag_pose(got_d, k, 0.1))


# ---------------------------------------------------- stage helpers


def test_host_stages_equal_reference():
    """The float64 helpers one by one on the perspective scene."""
    img = _perspective()
    t = np.asarray(jat.adaptive_threshold(jnp.asarray(img), 4, 5, 0.6))
    lab = tccl.label_classes_host(t, 127)
    for a, b in zip(tdet._boundary_points(t, lab),
                    jdet._boundary_points(t, lab)):
        np.testing.assert_array_equal(a, b)
    cfg_t, cfg_j = tat.DetectorConfig(), jat.DetectorConfig()
    nq_t = tdet._native_quads(t, cfg_t)
    nq_j = jdet._native_quads(t, cfg_j)
    assert len(nq_t) == len(nq_j) > 0
    for a, b in zip(nq_t, nq_j):
        np.testing.assert_array_equal(a, b)
    q = np.stack(nq_t)
    src = np.array([[-1.0, -1.0], [1.0, -1.0], [1.0, 1.0], [-1.0, 1.0]])
    hb = tdet._homography_dlt4_batch(src, q)
    np.testing.assert_allclose(hb, jdet._homography_dlt4_batch(src, q),
                               rtol=0, atol=TOL)
    np.testing.assert_allclose(tdet._homography_dlt4(src, q[0]),
                               jdet._homography_dlt4(src, q[0]), rtol=0,
                               atol=TOL)
    pts = np.random.default_rng(1).uniform(-1, 1, (20, 2))
    np.testing.assert_array_equal(tdet._project_batch(hb, pts),
                                  jdet._project_batch(hb, pts))
    np.testing.assert_array_equal(tdet._project(hb[0], pts),
                                  jdet._project(hb[0], pts))
    full = img.astype(np.float32)
    xy = np.random.default_rng(2).uniform(-5, 600, (50, 2))
    np.testing.assert_array_equal(tdet._bilinear_sample(full, xy),
                                  jdet._bilinear_sample(full, xy))
    x = np.random.default_rng(3).normal(0, 5, 40)
    y = np.random.default_rng(4).normal(0, 5, 40)
    np.testing.assert_array_equal(tdet._convex_hull(x, y),
                                  jdet._convex_hull(x, y))


# ---------------------------------------------------------- the build


@pytest.mark.parametrize("cxx", ["/nonexistent/g++", "false"],
                         ids=["missing", "failing"])
def test_failed_build_raises(cxx, tmp_path, monkeypatch):
    """A compiler that is missing or fails raises, with its output; no
    route falls back to numpy."""
    from kornia_tpu_torch import io as tio

    monkeypatch.setattr(tbuild, "CXX", cxx)
    monkeypatch.setattr(tbuild, "BUILD_DIR", str(tmp_path / "fresh"))
    monkeypatch.setattr(tbuild, "_lib", None)
    mask = np.eye(8, dtype=np.uint8)
    with pytest.raises(RuntimeError, match="native build"):
        tccl.connected_components_host(mask)
    with pytest.raises(RuntimeError, match="native build"):
        tccl.label_classes_host(mask * 255)
    with pytest.raises(RuntimeError, match="native build"):
        tcont.find_contours(mask)
    with pytest.raises(RuntimeError, match="native build"):
        tio.rvl_compress(np.ones((4, 4), np.uint16))
    monkeypatch.setenv("KORNIA_TPU_APRILTAG_MID", "native")
    with pytest.raises(RuntimeError, match="native build"):
        tat.AprilTagDecoder(device="cpu").decode(_three())
    assert not os.path.exists(tbuild.lib_path())


def test_concurrent_first_build(tmp_path, monkeypatch):
    """Three processes that start together into an empty build directory
    build one library, leave no temporary file and all load it."""
    code = ("import sys\n"
            "from kornia_tpu_torch.native import build\n"
            "build.BUILD_DIR = sys.argv[1]\n"
            "lib = build.load_native_library()\n"
            "print(hasattr(lib, 'kornia_ccl_label'))\n")
    out = str(tmp_path / "b")
    procs = [subprocess.Popen([sys.executable, "-c", code, out], cwd=ROOT,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(3)]
    for p in procs:
        stdout, stderr = p.communicate(timeout=120)
        assert p.returncode == 0, stderr
        assert stdout.strip() == "True"
    files = sorted(os.listdir(out))
    monkeypatch.setattr(tbuild, "BUILD_DIR", out)
    assert [f for f in files if f.endswith(".so")] == \
        [os.path.basename(tbuild.lib_path())]
    assert not [f for f in files if f.endswith(".tmp")]


def test_decoder_defaults_to_the_card():
    import inspect
    assert inspect.signature(tat.AprilTagDecoder).parameters[
        "device"].default == "cuda"
    for fn in (tccl.connected_components, tat.adaptive_threshold):
        assert inspect.signature(fn, follow_wrapped=False).parameters[
            "device"].default == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            tat.AprilTagDecoder()
        with pytest.raises(RuntimeError):
            tccl.connected_components(np.ones((4, 4)))
