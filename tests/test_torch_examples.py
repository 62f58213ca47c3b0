"""The port's examples (kornia_tpu_torch/examples/) on the CPU, against
the JAX package.

Each example's ``main(argv + ["--cpu"])`` runs in-process on seed-made
inputs written to a temporary directory, and its printed lines meet the
assertions tests/test_examples.py makes of the reference's CLI. Each
example's main figure is then held to the reference library's same
computation on the same inputs (one module-scoped reference run per
example, jitted where it is a program of many ops): exactly where the
reference is exact, else within the module's tolerance of ROADMAP.md §3,
the reason beside it. The JAX examples are not run here: they are
subprocesses, which is what makes tests/test_examples.py slow.

The examples' own timing loops (1 warm call and 5–50 timed ones) run one
call here (``_once``): they time, and each call computes the same.
The geometry examples (``two_view``, ``pnp_demo``,
``icp_registration``) are in test_torch_examples_geometry.py,
``slam_demo`` and ``frontend_step`` in test_torch_examples_slam.py: each
file stays under a minute alone.
"""

import ast
import contextlib
import functools
import importlib
import io as stdio
import os
import sys
import tempfile

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from kornia_tpu import apriltag as japriltag
from kornia_tpu import bow as jbow
from kornia_tpu import io as jio
from kornia_tpu import models as jmodels
from kornia_tpu.models import llm as jllm
from kornia_tpu.features import fast as jfast
from kornia_tpu.features import matching as jmatching
from kornia_tpu.features import orb as jorb
from kornia_tpu.geometry import camera as jcamera
from kornia_tpu.ops import color as jcolor
from kornia_tpu.ops import pallas_kernels
from kornia_tpu.ops.color import rgb_to_gray as jrgb_to_gray
from kornia_tpu.ops.filters import sobel as jsobel

import chip_smoke
from kornia_tpu_torch import convert
from kornia_tpu_torch.examples import (apriltag_pose, bag_of_words,
                                       camera_capture, colmap_stats,
                                       fast_detector, orb_detector,
                                       orb_tracking_live,
                                       preprocess_pipeline, undistort_image,
                                       video_player, vlm_demo)

# One intra-op thread: these tests run many small ops, and torch's pool
# of a thread per core spins against the other test processes.
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
tensor = functools.partial(convert.tensor, device="cpu")


def _once(fn, n, device):
    """The examples' timing loop, one call: what is printed is the same."""
    fn()
    return 0.0


def run(mod, *argv, timed=False):
    """``mod.main([*argv, "--cpu"])`` in-process: (stdout, its result).
    Its timing loop runs one call unless ``timed``."""
    out = stdio.StringIO()
    saved = getattr(mod, "ms_per_call", None)
    if saved is not None and not timed:
        mod.ms_per_call = _once
    try:
        with contextlib.redirect_stdout(out):
            res = mod.main([str(a) for a in argv] + ["--cpu"])
    finally:
        if saved is not None:
            mod.ms_per_call = saved
    return out.getvalue(), res


def _ppm(path, img):
    h, w = img.shape[:2]
    with open(path, "wb") as f:
        f.write(f"P6\n{w} {h}\n255\n".encode() + np.ascontiguousarray(
            img, np.uint8).tobytes())


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """The examples' inputs, seed-made, both 240×376 so that one jitted
    reference ORB program serves orb_detector and orb_tracking_live: an
    RGB JPEG of the two-plane views (chip_smoke.render_scene; it stands in
    for dog.jpeg) and 12 gray PPM frames of a texture panning 2 px a frame
    for a directory camera; and chip_smoke's small COLMAP text model."""
    d = tmp_path_factory.mktemp("examples")
    img1, img2, _, _ = chip_smoke.render_scene()
    rgb = np.stack([img1[:240, :376], img1[240:, 376:],
                    img2[:240, 100:476]], -1)
    paths = {"dir": str(d), "jpg": str(d / "img.jpg"),
             "frames": str(d / "frames"), "colmap": str(d / "colmap")}
    jio.write_image_jpeg(paths["jpg"], rgb)
    os.makedirs(paths["frames"])
    tex = chip_smoke._texture(np.random.default_rng(3), 80, 6)
    tex = np.clip(tex, 0, 255).astype(np.uint8)
    for i in range(12):
        g = tex[40:280, 2 * i: 2 * i + 376]
        _ppm(os.path.join(paths["frames"], f"f{i:02d}.ppm"),
             np.repeat(g[..., None], 3, -1))
    chip_smoke.colmap_model(paths["colmap"])
    return paths


@functools.lru_cache(maxsize=None)
def _ref_orb(n_features, n_levels):
    """The reference's ORB at one config, jitted once for the file."""
    cfg = jorb.OrbConfig(n_features=n_features, n_levels=n_levels)
    return jax.jit(lambda g: jorb.orb_detect_and_describe(g, cfg))


_ref_match = jax.jit(
    lambda a, b, ma, mb: jmatching.match_descriptors(
        a, b, a_mask=ma, b_mask=mb, max_distance=64, ratio=0.8))
_ref_match_cc = jax.jit(
    lambda a, b, ma, mb: jmatching.match_descriptors(
        a, b, a_mask=ma, b_mask=mb, cross_check=True))


# ---------------------------------------------------------------------------
# fast_detector, camera_capture
# ---------------------------------------------------------------------------


def _ref_fast(rgb, threshold=20.0, max_keypoints=2048):
    kps = jfast.fast_detect(jcolor.rgb_to_gray(jnp.asarray(rgb))[..., 0],
                            threshold=threshold, max_keypoints=max_keypoints)
    return np.asarray(kps.xy)[np.asarray(kps.mask)]


def test_fast_detector_equals_reference(inputs):
    """``corners:`` printed; the corners (count and coordinates) and the
    keypoint drawing written to --output equal the reference's: the FAST
    path is exact (ROADMAP.md §3). The timing loop runs all 11 calls here."""
    png = os.path.join(inputs["dir"], "fast.png")
    out, res = run(fast_detector, "--image", inputs["jpg"], "--output", png,
                   timed=True)
    assert "corners:" in out and f"wrote {png}" in out
    rgb = jio.read_image_any_rgb8(inputs["jpg"])
    want = _ref_fast(rgb)
    assert res["corners"] == len(want) > 100
    np.testing.assert_array_equal(res["xy"], want)
    from kornia_tpu.ops import draw as jdraw

    vis = np.asarray(jdraw.draw_keypoints(jnp.asarray(rgb),
                                          jnp.asarray(want)))
    np.testing.assert_array_equal(jio.read_image_any_rgb8(png), vis)


def test_camera_capture_equals_reference(inputs, monkeypatch):
    """The synthesized virtual camera (4 PPM frames through the port's
    native library, looped): ``corners`` and ``done`` printed, each
    frame's corner count equal to the reference's fast_detect (1024
    keypoints) on the frame the reference example writes; and through a
    --uri directory camera."""
    monkeypatch.setattr(tempfile, "tempdir", inputs["dir"])
    out, res = run(camera_capture, "--frames", "5")
    assert "corners" in out and "done" in out
    rng = np.random.default_rng(0)
    base = rng.integers(0, 64, (240, 320, 3), np.uint8)
    want = []
    for i in range(5):
        f = base.copy()
        x = 40 + 50 * (i % 4)
        f[80:160, x: x + 80] = 255
        want.append(len(_ref_fast(f, max_keypoints=1024)))
    assert res["corners"] == want
    out, res = run(camera_capture, "--uri", "dir:" + inputs["frames"],
                   "--frames", "2")
    assert "376x240" in out and "done" in out


# ---------------------------------------------------------------------------
# orb_detector, orb_tracking_live, bag_of_words
# ---------------------------------------------------------------------------


def test_orb_detector_matches_reference(inputs):
    """The printed median reprojection error under the known warp is
    < 1.5 px (tests/test_examples.py's gate). The warped pair is the
    reference's bit for bit; on it the reference's own ORB and match give
    a median within 0.05 px and a match count within 5% of the port's:
    the pyramid's ±1-LSB pixels move a few keypoint slots (ROADMAP.md §3,
    "Pyramid ±1 LSB")."""
    out, res = run(orb_detector, "--image", inputs["jpg"],
                   "--n-features", "800")
    err = float(out.split("median reproj err")[1].split("px")[0])
    assert err < 1.5 and abs(err - res["median_err"]) < 0.006
    rgb = jio.read_image_any_rgb8(inputs["jpg"])
    gray, warped, m = orb_detector.warped_pair(rgb, CPU)
    import cv2

    ref_gray = np.asarray(jcolor.rgb_to_gray(jnp.asarray(rgb)))[..., 0]
    ref_m = cv2.getRotationMatrix2D(
        (ref_gray.shape[1] / 2, ref_gray.shape[0] / 2), 8.0, 0.95)
    ref_m[0, 2] += 6
    np.testing.assert_array_equal(gray, ref_gray)
    np.testing.assert_array_equal(m, ref_m)
    np.testing.assert_array_equal(warped, cv2.warpAffine(
        ref_gray, ref_m, (gray.shape[1], gray.shape[0])))
    ref = _ref_orb(800, 4)
    fa, fb = ref(jnp.asarray(gray)), ref(jnp.asarray(warped))
    mm = _ref_match(fa.descriptors, fb.descriptors, fa.mask, fb.mask)
    ok = np.asarray(mm.mask)
    xa = np.asarray(fa.xy)[np.nonzero(ok)[0]]
    xb = np.asarray(fb.xy)[np.asarray(mm.idx)[ok]]
    e = np.linalg.norm(xa @ m[:, :2].T + m[:, 2] - xb, axis=1)
    assert abs(np.median(e[e < 3.0]) - res["median_err"]) < 0.05
    assert abs(int(ok.sum()) - res["matches"]) <= 0.05 * ok.sum()


def test_orb_tracking_live_matches_reference(inputs):
    """Over a directory camera of 12 240×376 frames panning 2 px a frame:
    ``tracked matches`` and ``fps`` printed, the trajectory view written,
    a median flow of (−2, 0) px; each frame's tracked count within 5% of
    the reference's ORB and cross-checked match on the same frames (the
    pyramid's ±1-LSB slots). The synthetic panning scene's frames equal
    the reference example's."""
    html = os.path.join(inputs["dir"], "tracks.html")
    out, res = run(orb_tracking_live, "--source", "dir:" + inputs["frames"],
                   "--frames", "12", "--n-features", "800", "--viz", html)
    assert "tracked matches" in out and "fps" in out
    assert os.path.exists(html)
    np.testing.assert_allclose(res["flow"][:, :2], [[-2.0, 0.0]] * 11)
    ref = _ref_orb(800, 4)
    names = sorted(os.listdir(inputs["frames"]))
    prev = None
    for name, got in zip(names, [None] + res["tracked"]):
        rgb = jio.read_image_any_rgb8(os.path.join(inputs["frames"], name))
        feats = ref(jnp.asarray(rgb.mean(-1).astype(np.uint8)))
        if prev is not None:
            m = _ref_match_cc(prev.descriptors, feats.descriptors,
                              prev.mask, feats.mask)
            want = int(np.asarray(m.mask).sum())
            assert abs(got - want) <= 0.05 * want, (name, got, want)
        prev = feats
    sys.path.insert(0, ROOT)
    try:
        ref_mod = importlib.import_module("examples.orb_tracking_live")
    finally:
        sys.path.remove(ROOT)
    for a, b in zip(orb_tracking_live._synthetic_frames(
            3, np.random.default_rng(0)), ref_mod._synthetic_frames(
            3, np.random.default_rng(0))):
        np.testing.assert_array_equal(a, b)


def test_bag_of_words_ranks_equal_reference(inputs):
    """Each of the four quadrant places retrieves itself; the places are
    the reference's bit for bit; given the reference's ORB descriptors the
    port's vocabulary and database rank every query as the reference's
    do, with equal scores (bow is exact: tests/test_torch_bow.py); the port's own
    descriptors give the same best entries."""
    vocab_path = os.path.join(inputs["dir"], "vocab.npz")
    out, res = run(bag_of_words, "--image", inputs["jpg"], "--save-vocab",
                   vocab_path)
    for i in range(4):
        assert f"query place {i}: best {i}" in out
    assert os.path.exists(vocab_path)
    import cv2

    rgb = jio.read_image_any_rgb8(inputs["jpg"])
    big = cv2.resize(np.asarray(jcolor.rgb_to_gray(jnp.asarray(rgb)))[..., 0],
                     (512, 512))
    ref_frames = [big[:256, :256], big[:256, 256:], big[256:, :256],
                  big[256:, 256:]]
    for a, b in zip(bag_of_words.quadrant_places(inputs["jpg"], CPU),
                    ref_frames):
        np.testing.assert_array_equal(a, b)
    ref = _ref_orb(256, 3)
    descs = []
    for f in ref_frames:
        ft = ref(jnp.asarray(np.ascontiguousarray(f)))
        bits = np.asarray(ft.descriptors)[np.asarray(ft.mask)]
        descs.append(np.packbits(bits.astype(np.uint8), axis=1))
    vocab = jbow.Vocabulary.build(np.concatenate(descs), k=8, depth=3)
    db = jbow.BowDatabase(vocab)
    for d in descs:
        db.add(d)
    _, tdb = bag_of_words.index_places(descs, 8, 3, CPU)
    for d in descs:
        want = [(r.entry_id, r.score) for r in db.query(d, top_k=2)]
        got = [(r.entry_id, r.score) for r in tdb.query(d, top_k=2)]
        assert [g[0] for g in got] == [w[0] for w in want]
        np.testing.assert_allclose([g[1] for g in got],
                                   [w[1] for w in want], rtol=1e-6)
    assert [r[0][0] for r in res["ranks"]] == [0, 1, 2, 3]


# ---------------------------------------------------------------------------
# undistort_image, preprocess_pipeline, video_player
# ---------------------------------------------------------------------------


def test_undistort_image_within_k7_rule(inputs):
    """``undistort`` printed and the image written; the undistorted image
    against the reference's undistort_image (its CPU route: the gather
    remap) within 1 LSB on < 1% of pixels, the K7 rule (ROADMAP.md §3:
    the port follows the Pallas path's contract)."""
    png = os.path.join(inputs["dir"], "undistorted.png")
    out, res = run(undistort_image, "--image", inputs["jpg"], "--output",
                   png)
    assert "undistort" in out and os.path.exists(png)
    rgb = jio.read_image_any_rgb8(inputs["jpg"])
    k, dist = undistort_image.calibration(*rgb.shape[:2], -0.25, 0.06)
    want = np.asarray(jcamera.undistort_image(
        jnp.asarray(rgb), jnp.asarray(k), jnp.asarray(dist)))
    diff = np.abs(res["image"].astype(int) - want.astype(int))
    assert diff.max() <= 1 and (diff > 0).mean() < 0.01
    np.testing.assert_array_equal(jio.read_image_any_rgb8(png),
                                  res["image"])


def test_preprocess_pipeline_matches_reference(inputs, tmp_path):
    """``fused preprocess`` printed at 224; the tensor within 1e-5 of the
    reference's fused_preprocess_pallas (interpret mode), the TPU kernel
    that K6 ports: K6's bound against it (ROADMAP.md §3), summation order
    and FMA of two-term
    products (the reference's resize_normalize_to_tensor takes two
    bfloat16 passes on the CPU, which tests/test_torch_preprocess.py holds
    to its corridor); the --video route over an AVI prints its
    frames."""
    out, res = run(preprocess_pipeline, "--image", inputs["jpg"], "--size",
                   224)
    assert "fused preprocess" in out and "(1, 3, 224, 224)" in out
    rgb = jio.read_image_any_rgb8(inputs["jpg"])
    want = np.asarray(pallas_kernels.fused_preprocess_pallas(
        jnp.asarray(rgb), 224, 224, (0.485, 0.456, 0.406),
        (0.229, 0.224, 0.225)))
    np.testing.assert_allclose(res["tensor"][0], want, rtol=0, atol=1e-5)
    avi = str(tmp_path / "clip.avi")
    video_player._synth_clip(avi, n=3)
    out, res = run(preprocess_pipeline, "--video", avi, "--size", 64)
    assert "frame 0: (1, 3, 64, 64)" in out and res["frames"] == 3


def test_video_player_matches_reference(monkeypatch, inputs):
    """``wrote 5 frames`` printed; the synthesized clip is the reference
    example's byte for byte; each processed frame within 1 LSB of the
    reference's gray + Sobel overlay on the same frame (ATen's CPU
    float32 sqrt is not correctly rounded on every input, XLA's is)."""
    monkeypatch.setattr(tempfile, "tempdir", inputs["dir"])
    out, res = run(video_player, "--frames", "5")
    assert "wrote 5 frames" in out and res["frames"] == 5
    sys.path.insert(0, ROOT)
    try:
        ref_mod = importlib.import_module("examples.video_player")
    finally:
        sys.path.remove(ROOT)
    ref_clip = os.path.join(inputs["dir"], "ref_clip.avi")
    ref_mod._synth_clip(ref_clip)
    clip = os.path.join(os.path.dirname(res["out"]), "clip.avi")
    with open(clip, "rb") as a, open(ref_clip, "rb") as b:
        assert a.read() == b.read()
    with jio.VideoReader(clip) as vr:
        frames = [f for _, f in zip(range(3), vr)]

    def ref_overlay(rgb_u8):
        g = jrgb_to_gray(rgb_u8).squeeze(-1).astype(jnp.float32)
        gx, gy = jsobel(g, 1, 0), jsobel(g, 0, 1)
        mag = jnp.sqrt(gx * gx + gy * gy)
        mag = jnp.clip(mag / (mag.max() + 1e-6) * 255.0, 0, 255)
        out = rgb_u8.astype(jnp.float32) * 0.5
        out = out.at[..., 1].add(0.5 * mag.astype(jnp.uint8).astype(
            jnp.float32))
        return jnp.clip(out, 0, 255).astype(jnp.uint8)

    for f in frames:
        got = video_player.edge_overlay(f, CPU).numpy().astype(int)
        want = np.asarray(ref_overlay(jnp.asarray(f))).astype(int)
        assert np.abs(got - want).max() <= 1


# ---------------------------------------------------------------------------
# apriltag_pose, colmap_stats, vlm_demo
# ---------------------------------------------------------------------------


def test_apriltag_pose_equals_reference():
    """``id 42`` printed for each synthetic frame; the frames equal the
    reference example's (cv2 on the same homography) and the ids and
    translations equal the reference decoder's and pose's (float64 host
    code on equal inputs: 1e-9, ROADMAP.md §3)."""
    out, res = run(apriltag_pose, "--synthetic", "2")
    assert out.count("id 42") == 2
    det = japriltag.AprilTagDecoder()
    for i, (tag_id, t) in enumerate(res["frames"]):
        ds = det.decode(apriltag_pose.synthetic_frame(i, 0.16))
        pose = japriltag.estimate_tag_pose(ds[0], apriltag_pose.K, 0.16)
        assert tag_id == ds[0].tag_id == 42
        np.testing.assert_allclose(t, pose.best.translation, atol=1e-9)
        assert abs(t[2] - (0.8 + 0.05 * i)) < 0.01


def test_colmap_stats_equals_reference(inputs):
    """The stats of a COLMAP text model and its PLY export equal the
    reference's reader on the same files (host code, exact)."""
    ply = os.path.join(inputs["dir"], "cloud.ply")
    out, res = run(colmap_stats, inputs["colmap"], "--export-ply", ply)
    cams, imgs, pts = jio.read_colmap_model(inputs["colmap"])
    assert (res["cameras"], res["images"], res["points"]) == (
        len(cams), len(imgs), len(pts)) == (2, 3, 2)
    centers = np.stack([im.camera_center() for im in imgs.values()])
    np.testing.assert_array_equal(res["span"],
                                  centers.max(0) - centers.min(0))
    assert "points3D: 2  mean track 2.5  mean reproj err 0.60 px" in out
    cloud = jio.read_ply(ply)
    np.testing.assert_allclose(cloud["points"],
                               np.stack([p.xyz for p in pts.values()]))


@pytest.mark.parametrize("arch", ["smolvlm", "paligemma"])
def test_vlm_demo_tokens_equal_reference(inputs, arch):
    """``generated`` printed; with the reference's seed-0 flax weights
    (its init jitted, as tests/test_torch_models.py builds them) carried
    across by convert.model_params, the example's answer (4 greedy
    tokens, streamed) equals the reference's generate on the same image:
    greedy tokens are exact on the CPU (tests/test_torch_models.py)."""
    out, res = run(vlm_demo, "--image", inputs["jpg"], "--max-new", 4,
                   "--arch", arch)
    assert "generated" in out and len(res["tokens"]) >= 1
    cfg, model = vlm_demo.build(arch, CPU)
    pkg_cfg = _ref_config(arch)
    ref_model = (jmodels.PaliGemma if arch == "paligemma"
                 else jmodels.SmolVLM)(pkg_cfg)
    s = pkg_cfg.vision.image_size
    params = jax.jit(ref_model.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32),
        jnp.zeros((1, s, s, 3)), jllm.KVCache.zeros(pkg_cfg.text, 1))
    import flax.traverse_util as tu

    flat = {k: np.asarray(v)
            for k, v in tu.flatten_dict(params, sep="/").items()}
    model.load_state_dict({k: torch.from_numpy(v) for k, v in
                           convert.model_params(flat).items()}, strict=True)
    rgb = jio.read_image_any_rgb8(inputs["jpg"])
    toks, got = vlm_demo.answer(model, cfg, rgb, 4, CPU)
    pixels = np.asarray(jmodels.preprocess_image(rgb, 112))
    tokens = jmodels.build_prompt_tokens([10, 11, 12], cfg.tokens_per_image,
                                         500)[None]
    want = []
    ref = jmodels.generate(ref_model, params, tokens, pixels,
                           max_new_tokens=4, stream_callback=want.append)
    assert toks == want
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(ref.tokens))


def _ref_config(arch):
    m = jmodels
    vision = m.ViTConfig(image_size=112, patch_size=14, hidden_size=64,
                         intermediate_size=128, num_layers=2, num_heads=4)
    if arch == "paligemma":
        return m.PaliGemmaConfig(
            vision=vision,
            text=m.GemmaConfig(vocab_size=512, hidden_size=64,
                               intermediate_size=128, num_layers=2,
                               num_heads=4, num_kv_heads=1, head_dim=16,
                               max_seq_len=128),
            image_token_id=500)
    return m.VLMConfig(
        vision=vision,
        text=m.LLMConfig(vocab_size=512, hidden_size=64,
                         intermediate_size=128, num_layers=2, num_heads=4,
                         num_kv_heads=2, max_seq_len=128),
        pixel_shuffle_factor=2, image_token_id=500)


# ---------------------------------------------------------------------------
# every script has its port, which imports neither package of JAX
# ---------------------------------------------------------------------------


def test_every_example_has_a_port_module_free_of_jax():
    """Every ``examples/*.py`` script but ``_common.py`` has a module of
    the same name under ``kornia_tpu_torch/examples/`` (besides
    ``_common.py`` and ``frontend_step.py``), listed in its ``__all__``;
    no module there imports jax, flax, kornia_tpu or tests (an AST scan
    of every import), and none touches ``sys.path``."""
    ref = sorted(f for f in os.listdir(os.path.join(ROOT, "examples"))
                 if f.endswith(".py") and f != "_common.py")
    port_dir = os.path.join(ROOT, "kornia_tpu_torch", "examples")
    port = sorted(f for f in os.listdir(port_dir) if f.endswith(".py"))
    assert ref == sorted(set(port) - {"_common.py", "frontend_step.py",
                                      "__init__.py"})
    from kornia_tpu_torch import examples

    assert sorted(examples.__all__) == sorted(
        f[:-3] for f in ref + ["frontend_step.py"])
    banned = ("jax", "jaxlib", "flax", "kornia_tpu", "tests")
    for f in port:
        tree = ast.parse(open(os.path.join(port_dir, f)).read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                if isinstance(node, ast.Attribute) and node.attr == "path":
                    assert not (isinstance(node.value, ast.Name)
                                and node.value.id == "sys"), f
                continue
            for n in names:
                assert n.split(".")[0] not in banned, (f, n)


@pytest.mark.parametrize("mod, argv, flag, name", [
    (fast_detector, [], "--image", "dog.jpeg"),
    (orb_detector, [], "--image", "dog.jpeg"),
    (undistort_image, [], "--image", "dog.jpeg"),
    (preprocess_pipeline, [], "--image", "dog.jpeg"),
    (bag_of_words, [], "--image", "dog.jpeg"),
    (vlm_demo, [], "--image", "dog.jpeg"),
    (apriltag_pose, [], "--image", "apriltags_tag36h11.jpg"),
    ("two_view", [], "--frame-a", "mh01_frame1.png"),
    ("two_view", ["--frame-a", "a.png"], "--frame-b", "mh01_frame2.png"),
])
def test_examples_without_their_input_file_stop(mod, argv, flag, name,
                                                capsys):
    """The reference's examples default to test images of the reference
    library, which the repository does not hold: without the flag the
    port's example stops with a usage error (exit code 2) that names the
    flag and the reference's file, before it reads or builds anything."""
    if isinstance(mod, str):
        mod = importlib.import_module(f"kornia_tpu_torch.examples.{mod}")
    with pytest.raises(SystemExit) as e:
        mod.main([*argv, "--cpu"])
    assert e.value.code == 2
    err = capsys.readouterr().err
    assert f"{flag} PATH is required" in err and name in err
