"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Phases (any failure raises, so the script exits non-zero):

1. Device: requires CUDA, prints the card's name and power limit, builds the
   CUDA kernels from kornia_tpu_torch/ops/csrc/ and prints the build time.
2. Kernels vs their plain PyTorch versions on the card, at main-path
   shapes: the 8 pyramid levels of a 480×752 frame, 2000 keypoints (with
   border keypoints and pairs that straddle two levels). All three must be
   bit-equal (max_abs_err 0).
3. The slice at full size on a seed-made scene with known pose: two
   480×752 views of two textured, non-coplanar planes; ORB (OrbConfig())
   on both, Hamming matching, the two-view bootstrap (TwoViewParams()).
   Launch counts for the pair must be fast_harris 16, windows_paired 4,
   brief_sample 2; rotation error ≤ 0.5°, translation direction ≤ 5°,
   ≥ 100 inliers. The same pair is then run on the CPU and the shares of
   pyramid pixels, selected keypoints and descriptor bits that differ
   are printed (keypoints: ≤ 1%).
4. Times (CUDA events, warm-up, median of 20): each kernel, its plain
   version and one PyTorch library call computing the same function where
   there is one; each stage and the whole pair.
5. rectify (the warping slice's path): a raw, distorted EuRoC-size stereo
   pair of the same scene (0.11 m baseline, < 1° relative rotation,
   K_EUROC and radtan distortion) → StereoRectifier.from_calib →
   rectify_left/right (K7 with data maps, 2 launches) → ORB ×2 → match.
   The median |y1 − y2| of the matches must be < 0.5 px.
6. warp: a seed-made 1080×1920×3 u8 image through warp_affine (10°, 30°,
   scale 0.5), warp_perspective, undistort_image and remap (bilinear and
   nearest, zeros and border): one K7 launch each, each bit-equal to the
   plain version, timed beside the plain version and
   torch.nn.functional.grid_sample on the same map.
7. lane_shift: K8 at the shapes the JAX package's sheared branch gives it
   for the 1080p 30° warp (s = 1920, ht = 3944, 3 channels).
8. shear: warp_affine(method="shear") at 1080p RGB, 25° (canvas 3072):
   6 K9 launches, each input held to the plain version.

The line before the last is the card's name and power limit, the one
before it a JSON object with one entry per kernel; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from kornia_tpu_torch.features import matching, orb
from kornia_tpu_torch.geometry import camera, stereo, twoview
from kornia_tpu_torch.ops import cuda_kernels as ck
from kornia_tpu_torch.ops import interpolation, warp, warp_exact
from kornia_tpu_torch.ops.filters import gaussian_blur

H, W = 480, 752
SEED = 0
REPS = 20
HBM_BYTES_PER_S = 3.35e12   # H100 SXM, NVIDIA data sheet
F32_OPS_PER_S = 67e12       # float32 outside the tensor cores
K_EUROC = np.array([[458.654, 0.0, 367.215], [0.0, 457.296, 248.375],
                    [0.0, 0.0, 1.0]])
# radtan k1 k2 p1 p2 k3 of tests/test_geometry.py:71-72
DIST_RADTAN = np.array([-0.28, 0.07, 0.0002, -0.0001, 0.001])
STEREO_BASELINE = 0.11      # m, the EuRoC stereo rig's baseline
STEREO_DEG = (0.4, -0.6, 0.3)
KERNELS = {
    "fast_harris": ("kornia_tpu_torch/ops/csrc/fast_harris.cu",
                    "kornia_tpu/ops/pallas_kernels.py:143"),
    "windows_paired": ("kornia_tpu_torch/ops/csrc/windows_paired.cu",
                       "kornia_tpu/ops/pallas_kernels.py:451"),
    "brief_sample": ("kornia_tpu_torch/ops/csrc/brief_sample.cu",
                     "kornia_tpu/ops/pallas_kernels.py:519"),
    "remap": ("kornia_tpu_torch/ops/csrc/remap.cu",
              "kornia_tpu/ops/warp_pallas.py:87"),
    "lane_shift": ("kornia_tpu_torch/ops/csrc/lane_shift.cu",
                   "kornia_tpu/ops/warp_pallas.py:835"),
    "shear_x": ("kornia_tpu_torch/ops/csrc/shear_x.cu",
                "kornia_tpu/ops/warp_shear.py:53"),
}
HW_1080P = (1080, 1920)
DEV = torch.device("cuda")


def log(*args):
    print(*args, flush=True)


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, reps: int = REPS, warmup: int = 3) -> float:
    """Median device time of ``fn`` in ms (CUDA events around each call)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


# --------------------------------------------------------------------------
# scene
# --------------------------------------------------------------------------


def _texture(rng, n: int = 320, up: int = 8) -> np.ndarray:
    """Seeded noise upsampled ×``up`` bilinearly, float64 in [0, 255]."""
    small = rng.random((n + 1, n + 1)) * 255.0
    f = (np.arange(n * up) + 0.5) / up - 0.5
    i0 = np.clip(np.floor(f).astype(int), 0, n - 1)
    a = np.clip(f - i0, 0.0, 1.0)
    rows = small[i0] * (1 - a)[:, None] + small[i0 + 1] * a[:, None]
    return rows[:, i0] * (1 - a)[None] + rows[:, i0 + 1] * a[None]


def _bilinear(tex: np.ndarray, u: np.ndarray, v: np.ndarray) -> np.ndarray:
    n = tex.shape[0]
    u = np.clip(u, 0, n - 1.001)
    v = np.clip(v, 0, n - 1.001)
    u0, v0 = np.floor(u).astype(int), np.floor(v).astype(int)
    du, dv = u - u0, v - v0
    return (tex[v0, u0] * (1 - du) * (1 - dv) + tex[v0, u0 + 1] * du * (1 - dv)
            + tex[v0 + 1, u0] * (1 - du) * dv
            + tex[v0 + 1, u0 + 1] * du * dv)


_PLANES = [(np.array([1.0, 0.0, 1.0]), 5.0),    # X > 0 side
           (np.array([-1.0, 0.0, 1.0]), 5.0)]   # X < 0 side


def _rot_xyz(deg) -> np.ndarray:
    """Rz·Ry·Rx of the three angles in degrees."""
    ang = np.deg2rad(deg)
    cx, cy, cz = np.cos(ang)
    sx, sy, sz = np.sin(ang)
    rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    return rz @ ry @ rx


def _view(pix, rot, origin, texs):
    """Ray-cast the two textured planes: ``pix`` (H, W, 3) camera rays,
    camera = rot·(X − origin)."""
    d = pix @ rot          # world ray directions, rows: Rᵀ·dir
    best = np.full((H, W), np.inf)
    img = np.zeros((H, W))
    for (n, off), tex in zip(_PLANES, texs):
        s = (off - origin @ n) / (d @ n)
        s = np.where(s > 0, s, np.inf)
        p = origin + s[..., None] * d
        val = _bilinear(tex, (p[..., 0] + 6.0) * 200.0,
                        (p[..., 1] + 6.0) * 200.0)
        take = s < best
        img = np.where(take, val, img)
        best = np.minimum(best, s)
    return np.clip(np.round(img), 0, 255).astype(np.uint8)


def render_scene(seed: int = SEED):
    """Two views of a 'roof' of two textured planes z = 5 ∓ X (they meet
    at X = 0), camera 2 = R·X + t. Returns (img1, img2, R, t)."""
    rng = np.random.default_rng(seed)
    texs = [_texture(rng), _texture(rng)]
    r = _rot_xyz([1.0, -2.0, 0.5])
    center2 = np.array([0.3, 0.05, 0.02])
    t = -r @ center2
    kinv = np.linalg.inv(K_EUROC)
    vv, uu = np.mgrid[0:H, 0:W].astype(np.float64)
    pix = np.stack([uu, vv, np.ones_like(uu)], -1) @ kinv.T   # (H, W, 3)
    img1 = _view(pix, np.eye(3), np.zeros(3), texs)
    img2 = _view(pix, r, center2, texs)
    return img1, img2, r, t / np.linalg.norm(t)


def _undistort_normalized(xd, yd, dist, iters: int = 200):
    """Invert radtan distortion by fixed-point iteration in float64; returns
    (x, y) and the largest residual of the distortion model."""
    k1, k2, p1, p2, k3 = dist
    x, y = xd.copy(), yd.copy()

    def distort(x, y):
        r2 = x * x + y * y
        rad = 1 + k1 * r2 + k2 * r2 * r2 + k3 * r2 ** 3
        return (x * rad + 2 * p1 * x * y + p2 * (r2 + 2 * x * x),
                y * rad + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y)

    for _ in range(iters):
        dx, dy = distort(x, y)
        x, y = xd - (dx - x), yd - (dy - y)
    dx, dy = distort(x, y)
    return x, y, float(max(np.abs(dx - xd).max(), np.abs(dy - yd).max()))


def render_stereo(seed: int = SEED):
    """A raw EuRoC-size stereo pair of the same scene: camera 2 is moved
    STEREO_BASELINE m along x and turned by STEREO_DEG (each ≤ 1°), and
    both views are distorted by K_EUROC and DIST_RADTAN (each pixel sees
    the ray of its undistorted position). Returns (img1, img2, R, t) with
    cam2 = R·cam1 + t."""
    rng = np.random.default_rng(seed)
    texs = [_texture(rng), _texture(rng)]
    r = _rot_xyz(STEREO_DEG)
    center2 = np.array([STEREO_BASELINE, 0.0, 0.0])
    vv, uu = np.mgrid[0:H, 0:W].astype(np.float64)
    xd = (uu - K_EUROC[0, 2]) / K_EUROC[0, 0]
    yd = (vv - K_EUROC[1, 2]) / K_EUROC[1, 1]
    x, y, resid = _undistort_normalized(xd, yd, DIST_RADTAN)
    if resid > 1e-9:
        raise AssertionError(f"distortion inverse did not converge: {resid}")
    pix = np.stack([x, y, np.ones_like(x)], -1)
    img1 = _view(pix, np.eye(3), np.zeros(3), texs)
    img2 = _view(pix, r, center2, texs)
    return img1, img2, r, -r @ center2


def rot_err_deg(r_est, r_gt) -> float:
    c = (np.trace(r_est.T @ r_gt) - 1) / 2
    return float(np.degrees(np.arccos(np.clip(c, -1, 1))))


def dir_err_deg(t_est, t_gt) -> float:
    c = abs(np.dot(t_est / np.linalg.norm(t_est), t_gt))
    return float(np.degrees(np.arccos(np.clip(c, -1, 1))))


# --------------------------------------------------------------------------
# the slice
# --------------------------------------------------------------------------


def run_pair(img1, img2, device, generator=None):
    cfg = orb.OrbConfig()
    f1 = orb.orb_detect_and_describe(img1, cfg, device=device)
    f2 = orb.orb_detect_and_describe(img2, cfg, device=device)
    m = matching.match_descriptors(f1.descriptors, f2.descriptors,
                                   a_mask=f1.mask, b_mask=f2.mask,
                                   max_distance=64, ratio=0.8,
                                   device=device)
    x1, x2, mk = matching.matched_points(f1.xy, f2.xy, m)
    res = None
    if device != "cpu":
        res = twoview.estimate_relative_pose(
            x1, x2, K_EUROC, K_EUROC, mask=mk,
            params=twoview.TwoViewParams(), generator=generator,
            device=device)
    return f1, f2, m, res


def device_share(label, fn, card_line):
    """``fn`` once under torch.profiler: the device's busy share of the
    host wall time, the number of kernels launched and the kernels that
    take the most device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kern = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kern) / 1e3
    n = sum(e.count for e in kern)
    if not kern:
        log("profile: no device time in the trace: device busy share not "
            "measured")
        return
    log(f"profile {label}: wall {wall_ms:.3f} ms (profiled), device busy "
        f"{busy_ms:.3f} ms = {busy_ms / wall_ms:.4f} of wall, {n} kernel "
        f"launches [{card_line}]")
    for e in sorted(kern, key=lambda e: -e.self_device_time_total)[:8]:
        log(f"  {e.self_device_time_total / 1e3:8.3f} ms  x{e.count:<5d} "
            f"{e.key[:90]}")


# --------------------------------------------------------------------------
# the warping slice: rectify, warp, lane_shift, shear
# --------------------------------------------------------------------------


def bound(nbytes, ops=0):
    """(least ms, what bounds it) at the card's published peaks."""
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    to = ops / F32_OPS_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


class Record:
    """Record the arguments of every call of one kernel wrapper while
    the block runs (the calls themselves go through)."""

    def __init__(self, name: str):
        self.name = name
        self.calls = []

    def __enter__(self):
        self.orig = getattr(ck, self.name)

        def rec(*args, **kwargs):
            self.calls.append((args, kwargs))
            return self.orig(*args, **kwargs)

        setattr(ck, self.name, rec)
        return self

    def __exit__(self, *exc):
        setattr(ck, self.name, self.orig)


def counted(fn):
    """Run ``fn`` with every launch count set to 0 just before; returns
    (result, the counts just after)."""
    torch.cuda.synchronize()
    ck.reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    return out, dict(ck.LAUNCHES)


def only(launches, want):
    full = {name: 0 for name in ck.SOURCES}
    full.update(want)
    if launches != full:
        raise AssertionError(f"launch counts {launches} != {full}")


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    if a.shape != b.shape or a.dtype != b.dtype:
        raise AssertionError(f"{a.shape}/{a.dtype} vs {b.shape}/{b.dtype}")
    return float((a.double() - b.double()).abs().max()) if a.numel() else 0.0


def _grid(sx: torch.Tensor, sy: torch.Tensor, h: int, w: int):
    """Pixel coordinates → grid_sample's align_corners=True grid."""
    return torch.stack([sx * (2.0 / (w - 1)) - 1.0,
                        sy * (2.0 / (h - 1)) - 1.0], -1)[None]


def remap_case(args, kwargs):
    """K7 on one recorded call: kernel vs plain, times, library time, bound.
    Returns a dict for the kernels line."""
    img, out_hw, form = args
    k_out = ck.remap(*args, **kwargs)
    p_out = ck._remap_plain(*args, **kwargs)
    torch.cuda.synchronize()
    err = max_err(k_out, p_out)
    if err != 0.0:
        raise AssertionError(f"remap ({form}) differs from its plain "
                             f"version: {err}")
    h, w, c = img.shape
    sx, sy = ck._source_coords(form, out_hw, kwargs.get("coefs"),
                               kwargs.get("map_x"), kwargs.get("map_y"),
                               img.device)
    if kwargs.get("border"):
        sx = sx.clamp(0.0, w - 1.0)
        sy = sy.clamp(0.0, h - 1.0)
    nearest = kwargs.get("nearest", False)
    if nearest:
        sx, sy = torch.floor(sx + 0.5), torch.floor(sy + 0.5)
    # source values the function needs, each once: the taps with weight
    # (one for nearest, four for bilinear) that land in the image
    x0, y0 = torch.floor(sx).long(), torch.floor(sy).long()
    touched = torch.zeros(h * w, dtype=torch.bool, device=img.device)
    for dy, dx in ((0, 0),) if nearest else ((0, 0), (0, 1), (1, 0), (1, 1)):
        ix, iy = x0 + dx, y0 + dy
        ok = (ix >= 0) & (ix < w) & (iy >= 0) & (iy < h)
        touched[(iy * w + ix)[ok]] = True
    esize = img.element_size()
    nbytes = (int(touched.sum()) * c * esize + k_out.numel() * esize
              + (sx.numel() * 8 if form == "data" else 0))
    bms, by = bound(nbytes)
    ms = cuda_ms(lambda: ck.remap(*args, **kwargs))
    plain = cuda_ms(lambda: ck._remap_plain(*args, **kwargs))
    lib_in = img.permute(2, 0, 1)[None].float().contiguous()
    grid = _grid(sx, sy, h, w)
    pad = "border" if kwargs.get("border") else "zeros"
    mode = "nearest" if nearest else "bilinear"

    def lib():
        return torch.nn.functional.grid_sample(
            lib_in, grid, mode=mode, padding_mode=pad, align_corners=True)

    lib_dev = float((lib()[0].permute(1, 2, 0) - p_out.float()).abs().mean())
    return {"launches": 1, "max_abs_err": err, "ms": ms, "plain_ms": plain,
            "library_ms": cuda_ms(lib), "bound_ms": bms, "bound_by": by,
            "bytes": nbytes, "library_mean_abs_dev": lib_dev}


def phase_rectify(card_line):
    """The slice's path: raw stereo pair → rectify → ORB ×2 → match."""
    img1, img2, r, t = render_stereo()
    rect = stereo.StereoRectifier.from_calib(
        K_EUROC, DIST_RADTAN, K_EUROC, DIST_RADTAN, (H, W), r, t)
    raw1 = torch.as_tensor(img1, device=DEV)
    raw2 = torch.as_tensor(img2, device=DEV)
    cfg = orb.OrbConfig()

    def rectify():
        return (rect.rectify_left(raw1, device=DEV),
                rect.rectify_right(raw2, device=DEV))

    def path():
        g1, g2 = rectify()
        f1 = orb.orb_detect_and_describe(g1, cfg, device=DEV)
        f2 = orb.orb_detect_and_describe(g2, cfg, device=DEV)
        m = matching.match_descriptors(
            f1.descriptors, f2.descriptors, a_mask=f1.mask, b_mask=f2.mask,
            max_distance=64, ratio=0.8, device=DEV)
        return g1, g2, f1, f2, m

    path()                                          # warm-up
    (g1, g2, f1, f2, m), launches = counted(path)
    log(f"rectify path launches: {launches}")
    only(launches, {"remap": 2, "fast_harris": 16, "windows_paired": 4,
                    "brief_sample": 2})
    x1, x2, mk = matching.matched_points(f1.xy, f2.xy, m)
    dy = (x1[:, 1] - x2[:, 1]).abs()[mk].double()
    disp = (x1[:, 0] - x2[:, 0])[mk].double()
    if dy.numel() < 100:
        raise AssertionError(f"only {dy.numel()} matches after rectify")
    med, p95 = float(dy.median()), float(torch.quantile(dy, 0.95))
    log(f"rectify: baseline {rect.baseline:.6f} m, bf {rect.bf:.4f}; "
        f"{dy.numel()} matches, |y1 - y2| median {med:.4f} px, p95 "
        f"{p95:.4f} px; disparity median {float(disp.median()):.4f} px")
    if not med < 0.5:
        raise AssertionError("rectified rows disagree: median |y1 - y2| "
                             f"{med} >= 0.5 px")
    for g in (g1, g2):
        if g.dtype != torch.uint8 or tuple(g.shape) != (H, W):
            raise AssertionError("rectified image shape/dtype")

    with Record("remap") as rec:
        rectify()
    cases = [remap_case(a, kw) for a, kw in rec.calls]
    row = dict(cases[0])
    row["max_abs_err"] = max(c["max_abs_err"] for c in cases)
    row["launches"] = launches["remap"]
    log(f"K7 remap on the rectify path ({H}x{W} u8, data maps): bit-equal "
        f"on both views; kernel {row['ms']:.4f} ms, plain "
        f"{row['plain_ms']:.4f} ms, grid_sample {row['library_ms']:.4f} ms "
        f"(mean |dev| {row['library_mean_abs_dev']:.4f}), bound "
        f"{row['bound_ms']:.5f} ms ({row['bound_by']}, {row['bytes']} B) "
        f"[{card_line}]")

    def stage(name, fn):
        log(f"stage {name}: {cuda_ms(fn):.3f} ms [{card_line}]")

    stage("rectify left+right", rectify)
    stage("orb_detect_and_describe x2 (rectified)", lambda: [
        orb.orb_detect_and_describe(g, cfg, device=DEV) for g in (g1, g2)])
    stage("match_descriptors (rectified)", lambda: matching.match_descriptors(
        f1.descriptors, f2.descriptors, a_mask=f1.mask, b_mask=f2.mask,
        max_distance=64, ratio=0.8, device=DEV))
    stage("whole rectify path", path)
    device_share("whole rectify path", path, card_line)
    return row


def phase_warp(card_line):
    """K7 at the reference's audit size, 1080×1920×3 u8."""
    hh, ww = HW_1080P
    img = np.random.default_rng(SEED + 1).integers(0, 256, (hh, ww, 3),
                                                   np.uint8)
    x = torch.as_tensor(img, device=DEV)
    ctr = (ww / 2, hh / 2)
    k1080 = K_EUROC * np.array([[ww / W], [hh / H], [1.0]])
    hom = np.array([[1.0, 0.05, -20.0], [0.02, 0.98, 15.0],
                    [2e-5, -1.5e-5, 1.0]], np.float32)
    mx, my = camera.generate_correction_map_polynomial(
        k1080, DIST_RADTAN, HW_1080P, device=DEV)
    cases = [
        ("warp_affine rot10", lambda: warp.warp_affine(
            x, warp.get_rotation_matrix2d(ctr, 10.0, 1.0, device=DEV),
            HW_1080P, device=DEV)),
        ("warp_affine rot30", lambda: warp.warp_affine(
            x, warp.get_rotation_matrix2d(ctr, 30.0, 1.0, device=DEV),
            HW_1080P, device=DEV)),
        ("warp_affine scale0.5", lambda: warp.warp_affine(
            x, np.array([[0.5, 0.0, ww / 4], [0.0, 0.5, hh / 4]]), HW_1080P,
            device=DEV)),
        ("warp_perspective", lambda: warp.warp_perspective(
            x, hom, HW_1080P, device=DEV)),
        ("undistort_image", lambda: camera.undistort_image(
            x, k1080, DIST_RADTAN, device=DEV)),
    ] + [(f"remap {mode} {pad}",
          lambda mode=mode, pad=pad: interpolation.remap(
              x, mx, my, mode=mode, padding_mode=pad, device=DEV))
         for mode in ("bilinear", "nearest") for pad in ("zeros", "border")]
    rows = []
    for name, fn in cases:
        out, launches = counted(fn)
        only(launches, {"remap": 1})
        if out.dtype != torch.uint8 or tuple(out.shape) != (hh, ww, 3):
            raise AssertionError(f"{name}: output {out.dtype} {out.shape}")
        with Record("remap") as rec:
            fn()
        row = remap_case(*rec.calls[0])
        row["case"] = name
        stage_ms = cuda_ms(fn)
        log(f"K7 {name} ({hh}x{ww}x3 u8): launches 1, bit-equal; kernel "
            f"{row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, "
            f"grid_sample {row['library_ms']:.4f} ms (mean |dev| "
            f"{row['library_mean_abs_dev']:.4f}), bound "
            f"{row['bound_ms']:.5f} ms ({row['bound_by']}, {row['bytes']} B);"
            f" entry point {stage_ms:.4f} ms [{card_line}]")
        rows.append(row)
    return rows


def _sheared_branch_shifts(m: torch.Tensor, s: int):
    """The pre-shear slope, s0 and per-row shifts that the JAX package's
    sheared branch computes for an affine warp whose central row rate picks
    rot90 case 0 (warp_pallas.py:927-986): κ = −d/a of the inverse map,
    clipped to ±1.05 and quantised to 2^-20."""
    c = warp_exact.affine_coefs(m)
    if not (c[4] >= c[1].abs() and c[4] > 0):
        raise AssertionError("lane_shift phase expects rot90 case 0")
    kappa = torch.clamp(-c[3] / c[0], -1.05, 1.05)
    kappa = torch.round(kappa * 2.0 ** 20) * 2.0 ** -20
    s0 = torch.minimum(torch.floor(kappa * 0.0),
                       torch.floor(kappa * float(s - 1)))
    shift = torch.floor(kappa * torch.arange(s, dtype=torch.float32)) - s0
    return shift.to(torch.int32)


def phase_lane_shift(card_line):
    """K8 at the 1080p 30° sheared-branch shapes, 3 channels."""
    hh, ww = HW_1080P
    s = max(hh, ww)
    ht = s + int(np.ceil(1.05 * s)) + 8
    img = np.random.default_rng(SEED + 2).integers(0, 256, (hh, ww, 3),
                                                   np.uint8)
    m = warp.get_rotation_matrix2d((ww / 2, hh / 2), 30.0, 1.0, device="cpu")
    shift = _sheared_branch_shifts(m, s).to(DEV)
    # rot90 case 0: the transposed content, zero-padded to the s × s canvas
    xt = torch.as_tensor(img, device=DEV).float().permute(2, 1, 0)
    src = torch.nn.functional.pad(xt, (0, s - hh, 0, s - ww)).contiguous()
    out, launches = counted(lambda: warp_exact.lane_shift(src, shift, ht,
                                                          device=DEV))
    only(launches, {"lane_shift": 1})
    plain = ck._lane_shift_plain(src, shift, ht)
    err = max_err(out, plain)
    if err != 0.0 or tuple(out.shape) != (3, s, ht):
        raise AssertionError(f"lane_shift differs from its plain version: "
                             f"{err}, {tuple(out.shape)}")
    nbytes = src.numel() * 4 + shift.numel() * 4 + out.numel() * 4
    bms, by = bound(nbytes)
    ms = cuda_ms(lambda: ck.lane_shift(src, shift, ht))
    pms = cuda_ms(lambda: ck._lane_shift_plain(src, shift, ht))
    j = torch.arange(ht, dtype=torch.float32, device=DEV)
    r = torch.arange(s, dtype=torch.float32, device=DEV)
    grid = _grid(j[None, :] - shift.float()[:, None],
                 r[:, None].expand(s, ht), s, s)
    lib_in = src[None]

    def lib():
        return torch.nn.functional.grid_sample(
            lib_in, grid, mode="nearest", padding_mode="zeros",
            align_corners=True)

    dev = float((lib()[0] - plain).abs().mean())
    lms = cuda_ms(lib)
    log(f"K8 lane_shift (3 x {s} x {s} f32 -> 3 x {s} x {ht}, shifts "
        f"{int(shift.min())}..{int(shift.max())}): launches 1, bit-equal; "
        f"kernel {ms:.4f} ms, plain {pms:.4f} ms, grid_sample nearest "
        f"{lms:.4f} ms (mean |dev| {dev:.4f}), bound {bms:.5f} ms ({by}, "
        f"{nbytes} B) [{card_line}]")
    return {"launches": launches["lane_shift"], "max_abs_err": err,
            "ms": ms, "plain_ms": pms, "library_ms": lms, "bound_ms": bms,
            "bound_by": by}


def phase_shear(card_line):
    """warp_affine(method="shear") at 1080p RGB, 25°: six K9 passes."""
    hh, ww = HW_1080P
    img = np.random.default_rng(SEED + 3).integers(0, 256, (hh, ww, 3),
                                                   np.uint8)
    x = torch.as_tensor(img, device=DEV)
    m = warp.get_rotation_matrix2d((ww / 2, hh / 2), 25.0, 1.0, device=DEV)

    def fn():
        return warp.warp_affine(x, m, HW_1080P, method="shear", device=DEV)

    fn()                                            # warm-up
    out, launches = counted(fn)
    only(launches, {"shear_x": 6})
    if out.dtype != torch.uint8 or tuple(out.shape) != (hh, ww, 3):
        raise AssertionError("shear warp output shape/dtype")
    with Record("shear_x") as rec:
        fn()
    err = 0.0
    for args, kw in rec.calls:
        e = max_err(ck.shear_x(*args, **kw), ck._shear_x_plain(*args, **kw))
        if e != 0.0:
            raise AssertionError(f"shear_x differs from its plain version: "
                                 f"{e}")
        err = max(err, e)
    canvas, shifts = rec.calls[0][0]
    b, c, _ = canvas.shape
    nbytes = canvas.numel() * 4 * 2 + shifts.numel() * 4
    bms, by = bound(nbytes)
    ms = cuda_ms(lambda: ck.shear_x(canvas, shifts))
    pms = cuda_ms(lambda: ck._shear_x_plain(canvas, shifts))
    xs = torch.arange(c, dtype=torch.float32, device=DEV)
    grid = _grid(xs[None, :] + shifts[:, None], xs[:, None].expand(c, c),
                 c, c)
    lib_in = canvas[None] if canvas.ndim == 2 else canvas[:, None]

    def lib():
        return torch.nn.functional.grid_sample(
            lib_in, grid.expand(lib_in.shape[0], c, c, 2), mode="bilinear",
            padding_mode="zeros", align_corners=True)

    lms = cuda_ms(lib)
    exact = warp.warp_affine(x, m, HW_1080P, device=DEV)
    inner = (slice(hh // 5, hh - hh // 5), slice(ww // 6, ww - ww // 6))
    dev = (out[inner].float() - exact[inner].float()).abs()
    log(f"K9 shear_x ({b} x {c} x {c} f32 canvas): launches 6 per warp, "
        f"all 6 inputs bit-equal; one pass: kernel {ms:.4f} ms, plain "
        f"{pms:.4f} ms, grid_sample {lms:.4f} ms, bound {bms:.5f} ms ({by}, "
        f"{nbytes} B) [{card_line}]")
    log(f"shear route vs exact K7 warp at 25 deg (inner region): mean |diff| "
        f"{float(dev.mean()):.3f}, max {float(dev.max()):.0f} of 255; whole "
        f"shear warp {cuda_ms(fn):.3f} ms [{card_line}]")
    return {"launches": launches["shear_x"], "max_abs_err": err, "ms": ms,
            "plain_ms": pms, "library_ms": lms, "bound_ms": bms,
            "bound_by": by}


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is False; a GPU is "
                 "required")
    card_line = card()
    log(f"card: {card_line}")
    kind = torch.cuda.get_device_name(0)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {kind}")

    # 1. build
    build_s = ck.build()
    log(f"kernel build: {build_s:.2f} s ({len(ck.SOURCES)} sources, "
        f"one nvcc each, in parallel)")
    for name, text in ck.BUILD_LOG.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    img1, img2, r_gt, t_gt = render_scene()
    cfg = orb.OrbConfig()
    budgets = orb._level_budgets(cfg)
    g1 = torch.as_tensor(img1, device=DEV)
    levels = orb._pyramid(g1, cfg)
    shapes = [tuple(lv.shape) for lv in levels]
    log(f"levels: {shapes}; budgets {budgets}")

    # 2. kernels vs plain versions on the card
    errs = {}
    k1_err = 0.0
    for lv in levels:
        s_k, h_k = ck.fast_harris(lv, cfg.fast_threshold_low)
        s_p, h_p = ck._fast_harris_plain(lv, cfg.fast_threshold_low)
        torch.cuda.synchronize()
        if not torch.equal(s_k, s_p):
            raise AssertionError(f"fast_harris score/NMS differs at {lv.shape}")
        if not torch.equal(h_k, h_p):
            raise AssertionError(f"fast_harris Harris differs at {lv.shape}: "
                                 f"{float((h_k - h_p).abs().max())}")
        k1_err = max(k1_err, float((s_k - s_p).abs().max()),
                     float((h_k - h_p).abs().max()))
    errs["fast_harris"] = k1_err
    log(f"K1 fast_harris: score, NMS and Harris bit-equal on all "
        f"{len(levels)} levels")

    sels = [orb._select_level(lv, b, cfg) for lv, b in zip(levels, budgets)]
    xy_ints = [torch.round(s[0]).to(torch.int32) for s in sels]
    # force border keypoints into every level: corners and edges
    for i, (xy, lv) in enumerate(zip(xy_ints, levels)):
        lh, lw = lv.shape
        border = torch.tensor([[0, 0], [lw - 1, lh - 1], [lw - 1, 0],
                               [0, lh - 1], [lw // 2, 0], [0, lh // 2]],
                              dtype=torch.int32, device=DEV)
        xy_ints[i] = torch.cat([border, xy[len(border):]])
    grays_f = [lv.to(torch.float32) for lv in levels]
    canvas, starts = ck.prepare_window_canvas(grays_f)
    xy_c = torch.cat([x + torch.tensor([0, s], dtype=torch.int32,
                                       device=DEV)[None]
                      for x, s in zip(xy_ints, starts)]).contiguous()
    level_of = np.repeat(np.arange(len(budgets)), budgets)
    straddle = int(np.sum(level_of[0::2] != level_of[1::2]))
    if straddle == 0:
        raise AssertionError("no pair straddles two levels")
    w_k = ck.windows_paired(canvas, xy_c, W)
    w_p = ck._windows_paired_plain(canvas, xy_c, W)
    torch.cuda.synchronize()
    if not torch.equal(w_k, w_p):
        raise AssertionError("windows_paired differs from its plain version")
    errs["windows_paired"] = float((w_k - w_p).abs().max())
    log(f"K2 windows_paired: bit-equal, {xy_c.shape[0]} keypoints "
        f"({straddle} pairs straddle two levels), out {tuple(w_k.shape)}")

    ang = orb.orientation_from_windows_paired(w_k)
    rows, cols = orb._brief_tap_coords(ang, cfg.pattern_seed, cfg.pattern)
    k = ang.shape[0]
    rows = rows.reshape(k // 2, 1024).contiguous()
    cols = (cols.reshape(k // 2, 2, 512)
            + torch.tensor([0, 64], dtype=torch.int32,
                           device=DEV)[None, :, None]).reshape(
        k // 2, 1024).contiguous()
    b_k = ck.brief_sample(w_k, rows, cols)
    b_p = ck._brief_sample_plain(w_k, rows, cols)
    torch.cuda.synchronize()
    if not torch.equal(b_k, b_p):
        raise AssertionError("brief_sample differs from its plain version")
    errs["brief_sample"] = float((b_k - b_p).abs().max())
    log(f"K3 brief_sample: bit-equal, {tuple(b_k.shape)} taps")

    # 3. the slice at full size
    gen = torch.Generator(device=DEV).manual_seed(SEED)
    run_pair(img1, img2, "cuda", gen)          # warm-up (cuBLAS, caches)
    torch.cuda.synchronize()
    ck.reset_launch_counts()
    gen = torch.Generator(device=DEV).manual_seed(SEED)
    f1, f2, m, res = run_pair(img1, img2, "cuda", gen)
    torch.cuda.synchronize()
    launches = dict(ck.LAUNCHES)
    log(f"launches for the pair: {launches}")
    only(launches, {"fast_harris": 16, "windows_paired": 4,
                    "brief_sample": 2})
    for f in (f1, f2):
        for name, t in f._asdict().items():
            if t.dtype.is_floating_point and not torch.isfinite(t).all():
                raise AssertionError(f"ORB {name} not finite")
        if tuple(f.descriptors.shape) != (cfg.n_features, 256):
            raise AssertionError("descriptor shape")
    r_est = res.rotation.double().cpu().numpy()
    t_est = res.translation.double().cpu().numpy()
    if not (np.isfinite(r_est).all() and np.isfinite(t_est).all()):
        raise AssertionError("pose not finite")
    n_matches = int(m.mask.sum())
    n_inl = int(res.n_inliers)
    rerr, terr = rot_err_deg(r_est, r_gt), dir_err_deg(t_est, t_gt)
    log(f"slice: keypoints {int(f1.mask.sum())}/{int(f2.mask.sum())}, "
        f"matches {n_matches}, inliers {n_inl}, homography "
        f"{bool(res.use_homography)}, rotation error {rerr:.4f} deg, "
        f"translation direction error {terr:.4f} deg")
    if not (rerr <= 0.5 and terr <= 5.0 and n_inl >= 100):
        raise AssertionError("pose outside the bounds (0.5 deg, 5 deg, "
                             ">= 100 inliers)")

    t0 = time.perf_counter()
    c1, c2, cm, _ = run_pair(img1, img2, "cpu")
    cpu_s = time.perf_counter() - t0
    lv_cpu = orb._pyramid(torch.as_tensor(img1), cfg) + orb._pyramid(
        torch.as_tensor(img2), cfg)
    lv_gpu = levels + orb._pyramid(torch.as_tensor(img2, device=DEV), cfg)
    px_diff = sum(int((a.cpu().int() - b.int()).abs().gt(0).sum())
                  for a, b in zip(lv_gpu, lv_cpu))
    px_max = max(int((a.cpu().int() - b.int()).abs().max())
                 for a, b in zip(lv_gpu, lv_cpu))
    px_all = sum(b.numel() for b in lv_cpu)
    kp_diff = kp_all = bit_diff = bit_all = 0
    for fg, fc in ((f1, c1), (f2, c2)):
        same = ((fg.xy.cpu() == fc.xy).all(1)
                & (fg.mask.cpu() == fc.mask))
        kp_diff += int((~same).sum())
        kp_all += same.numel()
        both = same & fc.mask
        bit_diff += int((fg.descriptors.cpu()[both]
                         != fc.descriptors[both]).sum())
        bit_all += int(both.sum()) * 256
    match_same = float((m.idx.cpu() == cm.idx).float().mean())
    log(f"card vs cpu ({cpu_s:.1f} s on the CPU): pyramid pixels differing "
        f"{px_diff}/{px_all} = {px_diff / px_all:.3e} (max |diff| {px_max} "
        f"LSB); keypoints differing {kp_diff}/{kp_all} = "
        f"{kp_diff / kp_all:.4f}; descriptor bits differing "
        f"{bit_diff}/{bit_all} = {bit_diff / max(bit_all, 1):.3e}; "
        f"match idx equal {match_same:.4f}")
    if kp_diff / kp_all > 0.01:
        raise AssertionError("more than 1% of keypoints differ from the "
                             "CPU run")

    # 4. times
    thr = cfg.fast_threshold_low
    t_k1 = cuda_ms(lambda: [ck.fast_harris(lv, thr) for lv in levels])
    t_k1p = cuda_ms(lambda: [ck._fast_harris_plain(lv, thr)
                             for lv in levels])
    t_k2 = cuda_ms(lambda: ck.windows_paired(canvas, xy_c, W))
    t_k2p = cuda_ms(lambda: ck._windows_paired_plain(canvas, xy_c, W))
    hc, wc = canvas.shape
    xy_pad = xy_c.long()
    ri = (xy_pad[:, 1, None] + torch.arange(40, device=DEV)).clamp(max=hc - 1)
    ci = (xy_pad[:, 0, None] + 32 + torch.arange(64, device=DEV)).clamp(
        max=wc - 1)
    ri2 = ri.reshape(-1, 2, 40).permute(0, 2, 1)[:, :, :, None]   # (K/2,40,2,1)
    ci2 = ci.reshape(-1, 2, 64)[:, None, :, :]                    # (K/2,1,2,64)
    lib_k2 = canvas[ri2, ci2].reshape(-1, 40, 128)
    if not torch.equal(lib_k2, w_k):
        raise AssertionError("K2 library gather disagrees")
    t_k2l = cuda_ms(lambda: canvas[ri2, ci2])
    t_k3 = cuda_ms(lambda: ck.brief_sample(w_k, rows, cols))
    t_k3p = cuda_ms(lambda: ck._brief_sample_plain(w_k, rows, cols))
    flat_idx = (rows.long() * 128 + cols.long())
    wflat = w_k.reshape(w_k.shape[0], -1)
    if not torch.equal(torch.gather(wflat, 1, flat_idx), b_k):
        raise AssertionError("K3 library gather disagrees")
    t_k3l = cuda_ms(lambda: torch.gather(wflat, 1, flat_idx))

    # bounds from this run's inputs
    px = sum(a * b for a, b in shapes)
    # per pixel: 16 ring differences, 4 doubling steps of min and max over
    # 16 arcs (128), 2×15 to reduce the arcs, 3 for max/threshold, 9 for
    # the NMS; Harris: 4 for the gradients, 3 products, 3×(5+5) multiplies
    # and 3×(4+4) adds for the window, 6 for det/trace/response
    k1_ops = px * (16 + 128 + 30 + 3 + 9 + 4 + 3 + 54 + 6)
    k1_bytes = px * (1 + 4 + 4)
    # canvas values the windows cover, each read once
    touched = torch.zeros_like(canvas, dtype=torch.bool)
    touched[ri2, ci2] = True
    k2_bytes = (int(touched.sum()) * 4 + xy_c.numel() * 4
                + w_k.numel() * 4)
    uniq = torch.unique(flat_idx + torch.arange(
        flat_idx.shape[0], device=DEV)[:, None] * 5120).numel()
    k3_bytes = uniq * 4 + rows.numel() * 4 * 2 + b_k.numel() * 4

    rows_out = []
    for name, ms, plain, lib, (bms, by) in (
            ("fast_harris", t_k1, t_k1p, None, bound(k1_bytes, k1_ops)),
            ("windows_paired", t_k2, t_k2p, t_k2l, bound(k2_bytes)),
            ("brief_sample", t_k3, t_k3p, t_k3l, bound(k3_bytes))):
        src, rep = KERNELS[name]
        rows_out.append({
            "name": name, "route": "cuda", "source": src, "replaces": rep,
            "launches": launches[name], "max_abs_err": errs[name],
            "ms": ms, "plain_ms": plain, "bound_ms": bms, "bound_by": by,
            "library_ms": lib})
        log(f"time {name}: kernel {ms:.4f} ms, plain {plain:.4f} ms, "
            f"library {lib if lib is None else f'{lib:.4f} ms'}, bound "
            f"{bms:.4f} ms ({by}) [{card_line}]")
    log("  (fast_harris times and bound cover the 8 levels of one frame; "
        "windows_paired and brief_sample one call at 2000 keypoints)")

    def stage(name, fn):
        ms = cuda_ms(fn)
        log(f"stage {name}: {ms:.3f} ms [{card_line}]")
        return ms

    stage("pyramid (1 frame)", lambda: orb._pyramid(g1, cfg))
    stage("detect+select, 8 levels (1 frame)",
          lambda: [orb._select_level(lv, b, cfg)
                   for lv, b in zip(levels, budgets)])
    stage("blur, 8 levels (1 frame)",
          lambda: [gaussian_blur(g, (7, 7), 2.0) for g in grays_f])
    blurs = [gaussian_blur(g, (7, 7), 2.0) for g in grays_f]

    def describe():
        a = orb.orientation_from_windows_paired(
            orb._extract_windows_packed_paired(grays_f, xy_ints))
        return orb.brief_from_windows_paired(
            orb._extract_windows_packed_paired(blurs, xy_ints), a,
            cfg.pattern_seed, cfg.pattern)

    stage("describe (1 frame)", describe)
    stage("orb_detect_and_describe (1 frame)",
          lambda: orb.orb_detect_and_describe(img1, cfg, device="cuda"))
    stage("match_descriptors", lambda: matching.match_descriptors(
        f1.descriptors, f2.descriptors, a_mask=f1.mask, b_mask=f2.mask,
        max_distance=64, ratio=0.8, device="cuda"))
    x1, x2, mk = matching.matched_points(f1.xy, f2.xy, m)
    stage("estimate_relative_pose", lambda: twoview.estimate_relative_pose(
        x1, x2, K_EUROC, K_EUROC, mask=mk, params=twoview.TwoViewParams(),
        generator=torch.Generator(device=DEV).manual_seed(SEED),
        device="cuda"))
    stage("whole pair", lambda: run_pair(
        img1, img2, "cuda", torch.Generator(device=DEV).manual_seed(SEED)))
    device_share("whole pair", lambda: run_pair(
        img1, img2, "cuda", torch.Generator(device=DEV).manual_seed(SEED)),
        card_line)

    # 5-8. the warping slice
    k7 = phase_rectify(card_line)
    k7["cases"] = phase_warp(card_line)
    k7["max_abs_err"] = max([k7["max_abs_err"]]
                            + [c["max_abs_err"] for c in k7["cases"]])
    k8 = phase_lane_shift(card_line)
    k9 = phase_shear(card_line)
    keep = ("launches", "max_abs_err", "ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms")
    for name, row in (("remap", k7), ("lane_shift", k8), ("shear_x", k9)):
        src, rep = KERNELS[name]
        entry = {"name": name, "route": "cuda", "source": src,
                 "replaces": rep}
        entry.update({k: row[k] for k in keep})
        if "cases" in row:
            entry["cases"] = [{k: c[k] for k in ("case",) + keep}
                              for c in row["cases"]]
        rows_out.append(entry)
    for row in rows_out:
        if row["launches"] < 1 or row["max_abs_err"] != 0.0:
            raise AssertionError(f"kernel {row['name']}: launches "
                                 f"{row['launches']}, max_abs_err "
                                 f"{row['max_abs_err']}")

    log(json.dumps({"kernels": rows_out}))
    log(card_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
