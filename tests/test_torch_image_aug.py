"""Image, the augmentations, utils, depth and segmentation against the JAX
package on the CPU.

Augmentations: each is fed the reference's draws (the values its
``jax.random`` calls give, replayed here from the same keys and splits,
``_ref_draws``) through ``draws=``. Their outputs are exact, except where
the reference's CPU route warps by the XLA gather and the port by K7's
plain version (``RandomAffine``, and what follows one in a pipeline; and
``warp_frame_depth``): there u8 may differ by 1 LSB on at most 1% of the
pixels, the reference's own bound between its two routes (the 2×2 inverse
by adjugate against ``jnp.linalg.inv``; tests/test_warp_pallas.py:129-132).
"""

import functools
import os
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from kornia_tpu import augmentations as jaug
from kornia_tpu import image as jimage
from kornia_tpu.ops import depth as jdepth
from kornia_tpu.ops import segmentation as jseg
from kornia_tpu.utils import tensor_ops as jto
from kornia_tpu.utils import tracing as jtr
from kornia_tpu.utils import viz as jviz

from kornia_tpu_torch import augmentations as taug
from kornia_tpu_torch import convert
from kornia_tpu_torch import image as timage
from kornia_tpu_torch.ops import cuda_kernels as ck
from kornia_tpu_torch.ops import depth as tdepth
from kornia_tpu_torch.ops import segmentation as tseg
from kornia_tpu_torch.slam.map import Keyframe, SlamMap
from kornia_tpu_torch.utils import tensor_ops as tto
from kornia_tpu_torch.utils import tracing as ttr
from kornia_tpu_torch.utils import viz as tviz

torch.set_num_threads(1)

tensor = functools.partial(convert.tensor, device="cpu")


def _rgb(seed, shape=(48, 64, 3)):
    """Smooth colour ramps plus blocks of noise, u8."""
    rng = np.random.default_rng(seed)
    h, w = shape[:2]
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([xx * 255 / w, yy * 255 / h,
                     128 + 100 * np.sin(xx / 5.0)], -1)[..., : shape[-1]
                                                         if len(shape) == 3
                                                         else 1]
    noise = np.kron(rng.normal(0, 30, (h // 4 + 1, w // 4 + 1, 1)),
                    np.ones((4, 4, 1)))[:h, :w]
    img = np.clip(base + noise, 0, 255).astype(np.uint8)
    return img if len(shape) == 3 else img[..., 0]


def _lsb_rule(got, ref):
    """u8: at most 1 LSB apart, on at most 1% of the values."""
    d = np.abs(got.astype(np.int32) - ref.astype(np.int32))
    assert d.max() <= 1 and (d > 0).mean() <= 0.01, (d.max(), (d > 0).mean())


# --------------------------------------------------------------------------
# the reference's draws, replayed
# --------------------------------------------------------------------------


def _ref_draws(aug, key):
    """The values ``aug(key, img)`` of the JAX package draws, with its
    splits, as the port's ``draws=`` dict."""
    if isinstance(aug, (jaug.RandomHorizontalFlip, jaug.RandomVerticalFlip)):
        return {"flip": np.asarray(jax.random.bernoulli(key, aug.p))}
    if isinstance(aug, jaug.ColorJitter):
        kb, kc, ks, kh = jax.random.split(key, 4)
        return {name: np.asarray(jax.random.uniform(k, minval=-lim,
                                                    maxval=lim))
                for name, k, lim in (("brightness", kb, aug.brightness),
                                     ("contrast", kc, aug.contrast),
                                     ("saturation", ks, aug.saturation),
                                     ("hue", kh, aug.hue_deg))}
    if isinstance(aug, jaug.RandomGaussianBlur):
        kp, ks = jax.random.split(key)
        return {"apply": np.asarray(jax.random.bernoulli(kp, aug.p)),
                "mix": np.asarray(jax.random.uniform(ks))}
    if isinstance(aug, jaug.RandomAffine):
        kr, kt, ks = jax.random.split(key, 3)
        return {"angle": np.asarray(jax.random.uniform(
                    kr, minval=-aug.degrees, maxval=aug.degrees)),
                "translate": np.asarray(jax.random.uniform(
                    kt, (2,), minval=-aug.translate, maxval=aug.translate)),
                "scale": np.asarray(jax.random.uniform(
                    ks, minval=aug.scale_range[0],
                    maxval=aug.scale_range[1]))}
    if isinstance(aug, jaug.RandomErasing):
        kp, ka, kx, ky, kv = jax.random.split(key, 5)
        return {"apply": np.asarray(jax.random.bernoulli(kp, aug.p)),
                "area": np.asarray(jax.random.uniform(
                    ka, minval=aug.area[0], maxval=aug.area[1])),
                "x": np.asarray(jax.random.uniform(kx)),
                "y": np.asarray(jax.random.uniform(ky)),
                "fill": np.asarray(jax.random.uniform(kv))}
    raise TypeError(type(aug))


def _port(aug):
    import dataclasses
    return convert.augmentation({"type": type(aug).__name__,
                                 **dataclasses.asdict(aug)})


_EXACT_AUGS = [
    jaug.RandomHorizontalFlip(), jaug.RandomVerticalFlip(p=0.7),
    jaug.ColorJitter(), jaug.ColorJitter(0.4, 0.3, 0.5, 30.0),
    jaug.RandomGaussianBlur(), jaug.RandomGaussianBlur(p=0.9, ksize=7),
    jaug.RandomErasing(), jaug.RandomErasing(p=0.9, area=(0.1, 0.4))]


@pytest.mark.parametrize("aug", _EXACT_AUGS, ids=lambda a: repr(a)[:40])
@pytest.mark.parametrize("dtype", ["u8", "f32"])
def test_augmentation_on_reference_draws_exact(aug, dtype):
    """Flips, jitter, blur and erasing on the reference's draws: exact,
    for 6 keys (both sides of the coin where p <= 0.7)."""
    img = _rgb(20)
    if dtype == "f32":
        img = (img / 255.0).astype(np.float32)
    port = _port(aug)
    seen = set()
    for i in range(6):
        key = jax.random.PRNGKey(100 + i)
        ref = np.asarray(aug(key, jnp.asarray(img)))
        draws = _ref_draws(aug, key)
        got = port(tensor(img), draws=draws, device="cpu").numpy()
        assert got.dtype == ref.dtype
        if dtype == "f32" and isinstance(aug, jaug.ColorJitter):
            # the hue rotation's float32 HSV round trip, in each package's
            # op order (measured 8.3e-7)
            np.testing.assert_allclose(got, ref, atol=2e-6)
        else:
            np.testing.assert_array_equal(got, ref)
        seen.update(bool(v) for k, v in draws.items()
                    if k in ("flip", "apply"))
    if getattr(aug, "p", 1.0) <= 0.7:
        assert seen == {True, False}


@pytest.mark.parametrize("aug", [jaug.RandomAffine(),
                                 jaug.RandomAffine(30.0, 0.1, (0.5, 1.5))],
                         ids=["default", "wide"])
@pytest.mark.parametrize("shape", [(48, 64, 3), (40, 56)])
def test_random_affine_on_reference_draws(aug, shape):
    """The K7 rule: ≤ 1 LSB on ≤ 1% of pixels (measured: 1 pixel of one
    of the 16 images, 1 LSB)."""
    img = _rgb(21, shape)
    port = _port(aug)
    for i in range(4):
        key = jax.random.PRNGKey(200 + i)
        ref = np.asarray(aug(key, jnp.asarray(img)))
        got = port(tensor(img), draws=_ref_draws(aug, key),
                   device="cpu").numpy()
        assert got.shape == ref.shape
        _lsb_rule(got, ref)


def _pipeline_augs():
    return [jaug.RandomHorizontalFlip(), jaug.ColorJitter(),
            jaug.RandomAffine()]


def test_pipeline_on_reference_draws_and_seed_replay():
    """``AugmentationPipeline`` of three, two calls in a row on the
    reference's draws (its key splits replayed: one split per call, one
    key per augmentation), under the K7 rule; the port's own pipeline
    replays after ``set_seed``."""
    img = _rgb(22)
    augs = _pipeline_augs()
    ref_pipe = jaug.AugmentationPipeline(augs, seed=7)
    pipe = convert.augmentation_pipeline(
        {"augs": [{"type": type(a).__name__, **vars(a)} for a in augs],
         "seed": 7}, device="cpu")
    key = jax.random.PRNGKey(7)
    for _ in range(2):
        ref = np.asarray(ref_pipe(jnp.asarray(img)))
        key, sub = jax.random.split(key)
        keys = jax.random.split(sub, len(augs))
        draws = [_ref_draws(a, k) for a, k in zip(augs, keys)]
        _lsb_rule(pipe(tensor(img), draws=draws).numpy(), ref)
    pipe.set_seed(3)
    a = pipe(tensor(img))
    b = pipe(tensor(img))
    pipe.set_seed(3)
    assert torch.equal(pipe(tensor(img)), a)
    assert torch.equal(pipe(tensor(img)), b)
    assert a.dtype == torch.uint8 and a.shape == img.shape


def test_apply_batch_on_reference_draws():
    """``apply_batch`` over 4 images with the reference's per-image keys
    (``split(key, 4)``, then each image's split per augmentation), under
    the K7 rule; and from the port's generator, image by image as
    ``__call__`` would go."""
    imgs = np.stack([_rgb(30 + i) for i in range(4)])
    augs = _pipeline_augs()
    ref_pipe = jaug.AugmentationPipeline(augs, seed=0)
    key = jax.random.PRNGKey(5)
    ref = np.asarray(ref_pipe.apply_batch(key, jnp.asarray(imgs)))
    draws = [[_ref_draws(a, k) for a, k in zip(
        augs, jax.random.split(ki, len(augs)))]
        for ki in jax.random.split(key, 4)]
    pipe = taug.AugmentationPipeline([_port(a) for a in augs], seed=0,
                                     device="cpu")
    got = pipe.apply_batch(tensor(imgs), draws=draws).numpy()
    assert got.shape == ref.shape
    _lsb_rule(got, ref)
    pipe.set_seed(9)
    batch = pipe.apply_batch(tensor(imgs))
    pipe.set_seed(9)
    one_by_one = torch.stack([pipe(tensor(im)) for im in imgs])
    assert torch.equal(batch, one_by_one)


def test_augmentations_draw_from_the_generator():
    """Without ``draws``: the draws come from the generator, in range, and
    the same seed gives the same output; nothing launches a kernel on the
    CPU."""
    img = tensor(_rgb(23))
    ck.reset_launch_counts()
    for aug in (taug.RandomHorizontalFlip(), taug.ColorJitter(),
                taug.RandomGaussianBlur(), taug.RandomAffine(),
                taug.RandomErasing()):
        d = aug.draw(torch.Generator().manual_seed(1), img)
        for v in d.values():
            assert isinstance(v, torch.Tensor)
        a = aug(img, generator=torch.Generator().manual_seed(1),
                device="cpu")
        b = aug(img, draws=d, device="cpu")
        assert torch.equal(a, b) and a.dtype == torch.uint8
    d = taug.RandomAffine().draw(torch.Generator().manual_seed(2), img)
    assert abs(float(d["angle"])) <= 10 and 0.9 <= float(d["scale"]) <= 1.1
    assert all(v == 0 for v in ck.LAUNCHES.values())


# --------------------------------------------------------------------------
# Image
# --------------------------------------------------------------------------


def test_image_numpy_and_dlpack_round_trips():
    arr = _rgb(24)
    img = timage.Image.from_numpy(arr, device="cpu")
    np.testing.assert_array_equal(img.numpy(), arr)
    assert (img.height, img.width, img.channels) == (48, 64, 3)
    assert img.pixel_format is timage.PixelFormat.U8
    # numpy → Image (zero-copy), Image → torch, Image → jax
    back = timage.Image.from_dlpack(arr)
    np.testing.assert_array_equal(back.numpy(), arr)
    assert back.color_space is timage.ColorSpace.UNKNOWN
    np.testing.assert_array_equal(torch.from_dlpack(img).numpy(), arr)
    np.testing.assert_array_equal(np.asarray(jnp.from_dlpack(img)), arr)
    # the reference's Image → the port's, through DLPack and by convert
    ref = jimage.Image.from_numpy(arr, jimage.ColorSpace.BGR)
    via = timage.Image.from_dlpack(ref, color_space=timage.ColorSpace.BGR)
    np.testing.assert_array_equal(via.numpy(), arr)
    conv = convert.image({"data": np.asarray(ref.data),
                          "color_space": ref.color_space,
                          "layout": ref.layout.value}, device="cpu")
    assert conv.color_space is timage.ColorSpace.BGR
    assert conv.layout is timage.ImageLayout.HWC
    np.testing.assert_array_equal(conv.numpy(), arr)
    t = torch.zeros(2, 3)
    assert timage.Image.from_torch(t).to_torch() is t
    assert timage.as_array(img) is img.data
    assert torch.equal(timage.as_array(arr), torch.as_tensor(arr))


def test_image_casts_and_layouts_equal_reference():
    arr = _rgb(25)
    f = (arr / 255.0).astype(np.float32) * 1.3
    ref, img = (jimage.Image.from_numpy(arr),
                timage.Image.from_numpy(arr, device="cpu"))
    reff, imgf = (jimage.Image.from_numpy(f),
                  timage.Image.from_numpy(f, device="cpu"))
    pairs = [
        (ref.cast(jnp.float32), img.cast(torch.float32)),
        (ref.cast_and_scale(jnp.float32, 1 / 255.0),
         img.cast_and_scale(torch.float32, 1 / 255.0)),
        (ref.cast_and_scale(jnp.uint8, 2), img.cast_and_scale(torch.uint8,
                                                              2)),
        (reff.scale_and_cast(jnp.uint8, 255.0),
         imgf.scale_and_cast(torch.uint8, 255.0)),
        (reff.scale_and_cast(jnp.uint16, 60000.0),
         imgf.scale_and_cast(torch.uint16, 60000.0)),
        (reff.scale_and_cast(jnp.float32, 0.5),
         imgf.scale_and_cast(torch.float32, 0.5)),
        (ref.to_chw(), img.to_chw()), (ref.to_chw().to_hwc(),
                                       img.to_chw().to_hwc()),
        (ref.map(lambda x: x[::2]), img.map(lambda x: x[::2])),
    ]
    for r, p in pairs:
        np.testing.assert_array_equal(p.numpy().astype(np.float64),
                                      np.asarray(r.data, np.float64))
        assert p.layout.value == r.layout.value
        assert p.pixel_format.value == r.pixel_format.value
        assert (p.height, p.width, p.channels) == (r.height, r.width,
                                                   r.channels)
        assert tuple(p.size) == tuple(r.size)
    for layout in ("hwc", "chw"):
        r = ref if layout == "hwc" else ref.to_chw()
        p = img if layout == "hwc" else img.to_chw()
        for i in range(3):
            np.testing.assert_array_equal(p.channel(i).numpy(),
                                          np.asarray(r.channel(i)))
        for a, b in zip(p.split_channels(), r.split_channels()):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    s = timage.ImageSize(width=64, height=48)
    assert s.wh == (64, 48) and s.hw == (48, 64) and tuple(s) == (64, 48)
    full = timage.Image.from_size_val(s, 7, channels=2, device="cpu")
    np.testing.assert_array_equal(full.numpy(), np.asarray(
        jimage.Image.from_size_val(jimage.ImageSize(64, 48), 7, 2).data))
    assert [m.value for m in timage.ColorSpace] == [
        m.value for m in jimage.ColorSpace]
    assert [m.value for m in timage.InterpolationMode] == [
        m.value for m in jimage.InterpolationMode]


# --------------------------------------------------------------------------
# utils
# --------------------------------------------------------------------------


def test_tensor_ops_equal_reference_and_raise_the_same_errors():
    rng = np.random.default_rng(27)
    a = rng.normal(size=(4, 5)).astype(np.float32)
    b = rng.normal(size=(4, 5)).astype(np.float32) + 3.0
    v = rng.normal(size=7).astype(np.float32)
    ia = rng.integers(0, 9, (4, 5)).astype(np.int32)
    ja, jb, ta, tb = jnp.asarray(a), jnp.asarray(b), tensor(a), tensor(b)
    for name in ("add", "sub", "mul", "div", "element_min",
                 "cosine_similarity", "cosine_distance"):
        np.testing.assert_allclose(getattr(tto, name)(ta, tb).numpy(),
                                   np.asarray(getattr(jto, name)(ja, jb)),
                                   rtol=1e-6)
    for name, arg in (("mul_scalar", 2.5), ("powf", 2.0), ("powi", 3)):
        np.testing.assert_allclose(getattr(tto, name)(tb, arg).numpy(),
                                   np.asarray(getattr(jto, name)(jb, arg)),
                                   rtol=1e-6)
    np.testing.assert_array_equal(tto.abs(ta).numpy(), np.asarray(
        jto.abs(ja)))
    np.testing.assert_allclose(float(tto.mean(ta)), float(jto.mean(ja)),
                               rtol=1e-6)
    assert float(tto.mean(tensor(ia))) == pytest.approx(
        float(jto.mean(jnp.asarray(ia))), rel=1e-6)
    for dim in (0, 1, -1):
        np.testing.assert_allclose(tto.sum_elements(ta, dim).numpy(),
                                   np.asarray(jto.sum_elements(ja, dim)),
                                   rtol=1e-6)
    r = tto.sum_elements(tensor(ia), 0)
    np.testing.assert_array_equal(r.numpy(), np.asarray(
        jto.sum_elements(jnp.asarray(ia), 0)))
    assert r.numpy().dtype == np.asarray(jto.sum_elements(
        jnp.asarray(ia), 0)).dtype
    np.testing.assert_allclose(float(tto.dot_product1(tensor(v), tensor(v))),
                               float(jto.dot_product1(jnp.asarray(v),
                                                      jnp.asarray(v))),
                               rtol=1e-6)
    for call, ref_call in (
            (lambda m: m.add(ta, tensor(a[:3])),
             lambda m: m.add(ja, ja[:3])),
            (lambda m: m.sum_elements(ta, 2),
             lambda m: m.sum_elements(ja, 2)),
            (lambda m: m.dot_product1(ta, ta),
             lambda m: m.dot_product1(ja, ja))):
        with pytest.raises(Exception) as got:
            call(tto)
        with pytest.raises(Exception) as want:
            ref_call(jto)
        assert type(got.value).__name__ == type(want.value).__name__
        assert isinstance(got.value, tto.TensorOpsError)


def test_tracing_equals_reference(monkeypatch, tmp_path):
    monkeypatch.delenv("KORNIA_TPU_TRACE", raising=False)
    assert ttr.trace_enabled() == jtr.trace_enabled() is False
    assert not ttr.Tracer().enabled
    monkeypatch.setenv("KORNIA_TPU_TRACE", "1")
    assert ttr.trace_enabled() and ttr.Tracer().enabled
    monkeypatch.setenv("KORNIA_TPU_FAST", "xla")
    assert ttr.env_variant("fast", "pallas") == jtr.env_variant(
        "fast", "pallas") == "xla"
    assert ttr.env_variant("other", "d") == "d"
    lines = []
    tr = ttr.Tracer(force=True, stream=types.SimpleNamespace(
        write=lines.append, flush=lambda: None))
    for _ in range(3):
        with tr.stage("add", sync=[torch.ones(3), {"x": (torch.zeros(2),)}]):
            torch.ones(100).sum()
    s = tr.summary()
    ref = jtr.Tracer(force=True, stream=types.SimpleNamespace(
        write=lambda t: None, flush=lambda: None))
    with ref.stage("add"):
        pass
    assert set(s) == {"add"} and set(s["add"]) == set(ref.summary()["add"])
    assert s["add"]["count"] == 3 and any("[trace] add:" in x for x in lines)
    tr.reset()
    assert tr.summary() == {}
    with ttr.profile_trace(str(tmp_path)):
        torch.ones(64).sum()
    assert any(f.endswith(".json") for f in os.listdir(tmp_path))


def test_write_trajectory_html_same_bytes_as_reference(tmp_path):
    rng = np.random.default_rng(28)
    est = np.cumsum(rng.normal(0, 0.1, (40, 3)), 0)
    gt = est + rng.normal(0, 0.01, est.shape)
    pts = rng.normal(size=(300, 3))
    loops = [(3, 30), (5, 35)]
    for kw in (dict(), dict(gt_centers=gt, points=pts, loop_edges=loops,
                            title="run 1", max_points=100)):
        jviz.write_trajectory_html(str(tmp_path / "ref.html"), est, **kw)
        tviz.write_trajectory_html(str(tmp_path / "port.html"),
                                   tensor(est) if not kw else est, **kw)
        assert (tmp_path / "ref.html").read_bytes() == \
            (tmp_path / "port.html").read_bytes()


def test_slam_viz_same_bytes_as_reference(tmp_path):
    """``slam_viz`` over a map (keyframes, points, edges with loop
    weights): the same file as the reference's ``slam_viz`` on it (the
    float32 pose inversions agree to the written 5 decimals)."""
    rng = np.random.default_rng(29)
    m = SlamMap()
    from kornia_tpu.geometry import liegroup as jlg
    for i in range(6):
        pose = np.asarray(jlg.se3_exp(jnp.asarray(
            rng.normal(0, 0.2, 6), jnp.float32)), np.float64)
        m.keyframes.append(Keyframe(i, 2 * i, pose, np.zeros((0, 2)),
                                    np.zeros((0, 32), np.uint8),
                                    np.zeros(0, np.int64)))
    m.add_points(rng.normal(size=(50, 3)), np.zeros((50, 32), np.uint8),
                 [[] for _ in range(50)])
    m.point_valid[::7] = False
    m.edges = [(0, 1, np.zeros(7), 1.0), (0, 5, np.zeros(7), 100.0),
               (2, 4, np.zeros(7), 50.0)]
    system = types.SimpleNamespace(map=m)
    jviz.slam_viz(str(tmp_path / "ref.html"), system)
    tviz.slam_viz(str(tmp_path / "port.html"), system)
    assert (tmp_path / "ref.html").read_bytes() == \
        (tmp_path / "port.html").read_bytes()


# --------------------------------------------------------------------------
# depth and segmentation
# --------------------------------------------------------------------------

KD = np.array([[100.0, 0, 31.5], [0, 98.0, 23.5], [0, 0, 1]], np.float32)


def _depth(seed, shape=(48, 64), holes=True):
    rng = np.random.default_rng(seed)
    h, w = shape
    yy, xx = np.mgrid[0:h, 0:w]
    d = 2.0 + 0.5 * np.sin(xx / 9.0) + 0.3 * yy / h
    d = d + rng.normal(0, 0.01, d.shape)
    if holes:
        d[rng.random(d.shape) < 0.05] = 0.0
    return d.astype(np.float32)


def test_depth_to_3d_and_normals_equal_reference():
    """1e-5 relative (measured: 3D equal, normals 1.2e-7 relative)."""
    d = _depth(40)
    for fn_r, fn_t in ((jdepth.depth_to_3d, tdepth.depth_to_3d),
                       (jdepth.depth_to_normals, tdepth.depth_to_normals)):
        ref = np.asarray(fn_r(jnp.asarray(d), jnp.asarray(KD)))
        got = fn_t(d, KD, device="cpu").numpy()
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("mode,window", [("nearest", 0), ("nearest", 1),
                                         ("nearest", 2), ("bilinear", 0)])
def test_sample_depth_equals_reference(mode, window):
    """Exact: the windowed median takes the mean of the two middle values
    of an even count, as ``jnp.nanmedian``."""
    d = _depth(41)
    rng = np.random.default_rng(42)
    xy = np.concatenate([rng.uniform(-3, 66, (200, 2)),
                         rng.integers(0, 48, (20, 2))]).astype(np.float32)
    val_r, ok_r = jdepth.sample_depth(jnp.asarray(d), jnp.asarray(xy), mode,
                                      window=window)
    val, ok = tdepth.sample_depth(d, xy, mode, window=window, device="cpu")
    np.testing.assert_array_equal(ok.numpy(), np.asarray(ok_r))
    np.testing.assert_array_equal(val.numpy(), np.asarray(val_r))
    assert ok.sum() > 100


@pytest.mark.parametrize("rgb", [True, False], ids=["rgb", "gray"])
def test_warp_frame_depth_equals_reference(rgb):
    """A 2° turn and 5 cm step through the depth map: the K7 rule."""
    img = _rgb(43, (48, 64, 3) if rgb else (48, 64))
    d = _depth(44, holes=False)
    from kornia_tpu.geometry import liegroup as jlg
    t44 = np.asarray(jlg.se3_to_matrix(jlg.se3_exp(jnp.asarray(
        [0.05, -0.02, 0.01, 0.0, 0.035, 0.01], jnp.float32))))
    ref = np.asarray(jdepth.warp_frame_depth(jnp.asarray(img), jnp.asarray(d),
                                             jnp.asarray(t44),
                                             jnp.asarray(KD)))
    ck.reset_launch_counts()
    got = tdepth.warp_frame_depth(img, d, t44, KD, device="cpu").numpy()
    assert got.shape == ref.shape and got.dtype == ref.dtype
    _lsb_rule(got, ref)
    assert all(v == 0 for v in ck.LAUNCHES.values())


def test_segmentation_equals_reference():
    rng = np.random.default_rng(45)
    for shape in ((1, 1), (7, 5), (40, 33)):
        for p in (0.0, 0.3, 1.0):
            mask = (rng.random(shape) < p).astype(np.uint8)
            rle = tseg.mask_to_rle(tensor(mask))
            assert rle == jseg.mask_to_rle(mask)
            np.testing.assert_array_equal(tseg.rle_to_mask(rle, *shape),
                                          jseg.rle_to_mask(rle, *shape))
            np.testing.assert_array_equal(tseg.rle_to_mask(rle, *shape), mask)
    a = rng.random((30, 40)) < 0.4
    b = rng.random((30, 40)) < 0.5
    assert tseg.masks_iou(tensor(a), b) == jseg.masks_iou(a, b)
    assert tseg.masks_iou(np.zeros((3, 3)), np.zeros((3, 3))) == 0.0
    with pytest.raises(ValueError):
        tseg.rle_to_mask([3, 4], 3, 3)
    with pytest.raises(ValueError):
        tseg.mask_to_rle(np.zeros(4))


def test_convert_icp_params_and_augmentations():
    import dataclasses
    from kornia_tpu.geometry import icp as jicp
    p = convert.icp_params(dataclasses.asdict(jicp.ICPParams(
        max_iterations=12, distance_threshold=0.5)))
    assert (p.max_iterations, p.distance_threshold, p.tolerance) == (
        12, 0.5, 1e-6)
    for aug in _EXACT_AUGS + [jaug.RandomAffine(5.0, 0.02, (0.8, 1.2))]:
        port = _port(aug)
        assert type(port).__name__ == type(aug).__name__
        assert dataclasses.asdict(port) == dataclasses.asdict(aug)
    with pytest.raises(ValueError):
        convert.augmentation({"type": "RandomCrop"})
