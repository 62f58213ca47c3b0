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

9. orb_variants (the third slice): the other describe forms of ORB on the
   480×752 frame with OrbConfig(): describe="unpaired" (K4 windows 2, K3
   brief_sample 1 on (K, 48, 128) windows, fast_harris 8) with descriptors
   and angles equal to the paired run's; brief="lane_gather" (K5
   lane_gather 4), bit-equal descriptors again; OrbConfig(n_features=2001)
   (an odd budget sum); describe="gather"; the quadtree pipeline (windows
   16, brief_sample 8; keypoints kept per level); harris_at_windows at the
   level-0 keypoints (windows 1) against the dense central-gradient map.
10. lk: frame 2 = warp_affine (K7) of frame 1 by a 2° rotation about the
   centre plus a (6, −4) px shift; the valid ORB keypoints of frame 1 are
   tracked with PyrLKParams() by "taps", "windows" and "gather". For
   "taps" ≥ 90% of the interior points must be tracked with a median
   end-point error < 0.1 px; the Newton iterations and K4 launches per
   level are printed.
11. preprocess: a seed-made 1080×1920×3 u8 image → 640×640 with the
   ImageNet mean/std (K6 preprocess 1 launch), bit-equal to the kernel's
   own arithmetic in PyTorch ops and within 2e-6 of the dense float32
   matrix products; the same image → 224×224 (tap weights that are not
   dyadic); one letterbox case (360×640 placed on the pad canvas).

The line before the last is the card's name and power limit, the one
before it a JSON object with one entry per kernel; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import inspect
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from kornia_tpu_torch.features import matching, orb, responses
from kornia_tpu_torch.geometry import camera, stereo, twoview
from kornia_tpu_torch.ops import cuda_kernels as ck
from kornia_tpu_torch.ops import interpolation, optical_flow, preprocess
from kornia_tpu_torch.ops import warp, warp_exact
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
    "windows": ("kornia_tpu_torch/ops/csrc/windows.cu",
                "kornia_tpu/ops/pallas_kernels.py:401"),
    "lane_gather": ("kornia_tpu_torch/ops/csrc/lane_gather.cu",
                    "kornia_tpu/ops/pallas_kernels.py:327"),
    "preprocess": ("kornia_tpu_torch/ops/csrc/preprocess.cu",
                   "kornia_tpu/ops/pallas_kernels.py:59"),
    "remap": ("kornia_tpu_torch/ops/csrc/remap.cu",
              "kornia_tpu/ops/warp_pallas.py:87"),
    "lane_shift": ("kornia_tpu_torch/ops/csrc/lane_shift.cu",
                   "kornia_tpu/ops/warp_pallas.py:835"),
    "shear_x": ("kornia_tpu_torch/ops/csrc/shear_x.cu",
                "kornia_tpu/ops/warp_shear.py:53"),
}
HW_1080P = (1080, 1920)
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
# max |kernel − plain| allowed: 0 (bit-equal) unless named here. K6's plain
# version sums its dense float32 products in cuBLAS's order.
PLAIN_TOL = {"preprocess": 2e-6}
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


# --------------------------------------------------------------------------
# the third slice: ORB variants, Lucas-Kanade, fused preprocess
# --------------------------------------------------------------------------


def windows_case(args, kwargs, card_line, label):
    """K4 on one recorded call: kernel vs plain (bit-equal), times, the
    library call (one advanced-indexing gather with prebuilt indices) and
    the byte bound. Returns a dict for the kernels line."""
    b = inspect.signature(ck._windows_plain).bind(*args, **kwargs)
    b.apply_defaults()
    src, xy, win_h = b.arguments["src"], b.arguments["xy"], \
        b.arguments["win_h"]
    got = ck.windows(*args, **kwargs)
    want = ck._windows_plain(*args, **kwargs)
    torch.cuda.synchronize()
    err = max_err(got, want)
    if err != 0.0:
        raise AssertionError(f"windows ({label}) differs from its plain "
                             f"version: {err}")
    oy, ox, xmax, ymax = ck._window_frame(
        src, win_h, b.arguments["cy_off"], b.arguments["cx_off"],
        b.arguments["prepared"])
    hs, ws = src.shape
    xyl = xy.long()
    cx, cy = xyl[:, 0].clamp(0, xmax), xyl[:, 1].clamp(0, ymax)
    ri = (cy[:, None] + torch.arange(win_h, device=DEV) - oy).clamp(
        0, hs - 1)[:, :, None]
    ci = (cx[:, None] + torch.arange(128, device=DEV) - ox).clamp(
        0, ws - 1)[:, None, :]
    if not torch.equal(src[ri, ci], got):
        raise AssertionError("K4 library gather disagrees")
    touched = torch.zeros_like(src, dtype=torch.bool)
    touched[ri, ci] = True
    nbytes = int(touched.sum()) * 4 + xy.numel() * 4 + got.numel() * 4
    bms, by = bound(nbytes)
    row = {"case": label, "max_abs_err": err,
           "ms": cuda_ms(lambda: ck.windows(*args, **kwargs)),
           "plain_ms": cuda_ms(lambda: ck._windows_plain(*args, **kwargs)),
           "library_ms": cuda_ms(lambda: src[ri, ci]), "bound_ms": bms,
           "bound_by": by}
    log(f"K4 windows {label} ({tuple(src.shape)} f32 -> {tuple(got.shape)}):"
        f" bit-equal; kernel {row['ms']:.4f} ms, plain "
        f"{row['plain_ms']:.4f} ms, advanced indexing "
        f"{row['library_ms']:.4f} ms, bound {bms:.5f} ms ({by}, {nbytes} B) "
        f"[{card_line}]")
    return row


def phase_orb_variants(card_line, img1):
    """The unpaired, lane-gather, odd-budget, gather and quadtree forms of
    ORB and harris_at_windows. Returns (K4 row, K5 row)."""
    cfg = orb.OrbConfig()
    frame = torch.as_tensor(img1, device=DEV)

    def run(cfg=cfg, **kw):
        return orb.orb_detect_and_describe(frame, cfg, device=DEV, **kw)

    paired = run()
    unp, n_unp = counted(lambda: run(describe="unpaired"))
    log(f"orb unpaired launches: {n_unp}")
    only(n_unp, {"fast_harris": 8, "windows": 2, "brief_sample": 1})
    for name in ("xy", "mask", "angle", "descriptors"):
        if not torch.equal(getattr(unp, name), getattr(paired, name)):
            raise AssertionError(f"unpaired ORB {name} differs from paired")
    lg, n_lg = counted(lambda: run(brief="lane_gather"))
    log(f"orb lane_gather launches: {n_lg}")
    only(n_lg, {"fast_harris": 8, "windows": 2, "lane_gather": 4})
    if not torch.equal(lg.descriptors, paired.descriptors):
        raise AssertionError("lane_gather BRIEF differs from paired")
    log("orb variants: unpaired xy/mask/angle/descriptors and lane_gather "
        "descriptors bit-equal to the paired run "
        f"({int(paired.mask.sum())} keypoints)")
    odd, n_odd = counted(lambda: run(orb.OrbConfig(n_features=2001)))
    only(n_odd, {"fast_harris": 8, "windows": 2, "brief_sample": 1})
    if tuple(odd.descriptors.shape) != (2001, 256):
        raise AssertionError("odd budget sum: descriptor shape")
    gat, n_gat = counted(lambda: run(describe="gather"))
    only(n_gat, {"fast_harris": 8})
    flips = int((gat.descriptors != paired.descriptors)[paired.mask].sum())
    log(f"orb n_features=2001: {int(odd.mask.sum())} keypoints, launches "
        f"{n_odd}; describe=gather: {flips} of "
        f"{int(paired.mask.sum()) * 256} bits differ from the window forms "
        "(angles from gathered patches, another summation order)")

    quad, n_quad = counted(lambda: orb.orb_detect_and_describe_quadtree(
        frame, cfg, device=DEV))
    log(f"orb quadtree launches: {n_quad}")
    only(n_quad, {"windows": 16, "brief_sample": 8})
    kept = [int(quad.mask[quad.octave == i].sum())
            for i in range(cfg.n_levels)]
    log(f"orb quadtree: keypoints kept per level {kept} of budgets "
        f"{orb._level_budgets(cfg)}")
    if tuple(quad.descriptors.shape) != (cfg.n_features, 256) or \
            sum(kept) < cfg.n_features // 2:
        raise AssertionError("quadtree ORB output")

    gray_f = frame.to(torch.float32)
    lvl0 = paired.mask & (paired.octave == 0)
    xy0 = torch.round(paired.xy[lvl0]).to(torch.int32).contiguous()
    hw, n_hw = counted(lambda: responses.harris_at_windows(gray_f, xy0))
    only(n_hw, {"windows": 1})
    dense = responses.harris_response(gray_f, grad="central", block_size=5)
    inner = ((xy0[:, 0] >= 4) & (xy0[:, 0] < W - 4)
             & (xy0[:, 1] >= 4) & (xy0[:, 1] < H - 4))
    at = dense[xy0[inner, 1].long(), xy0[inner, 0].long()]
    rel = float((hw[inner] - at).abs().max() / at.abs().max())
    log(f"harris_at_windows at {int(inner.sum())} interior level-0 "
        f"keypoints vs the dense map: max |diff| / max |response| "
        f"{rel:.3e}")
    if not rel < 1e-4:
        raise AssertionError("harris_at_windows disagrees with the dense "
                             "map")

    # the kernels on the very inputs of the unpaired path
    with Record("windows") as rec_w, Record("brief_sample") as rec_b, \
            Record("lane_gather") as rec_l:
        run(describe="unpaired")
        run(brief="lane_gather")
    if len(rec_w.calls) != 4 or len(rec_b.calls) != 1 or \
            len(rec_l.calls) != 4:
        raise AssertionError("recorded calls of the unpaired path")
    cases = [windows_case(a, kw, card_line, f"orb {what} canvas")
             for (a, kw), what in zip(rec_w.calls[:2], ("gray", "blurred"))]
    a, kw = rec_b.calls[0]
    if not torch.equal(ck.brief_sample(*a, **kw),
                       ck._brief_sample_plain(*a, **kw)):
        raise AssertionError("brief_sample on (K, 48, 128) windows differs "
                             "from its plain version")
    log(f"K3 brief_sample on {tuple(a[0].shape)} windows, "
        f"{a[1].shape[1]} taps: bit-equal; kernel "
        f"{cuda_ms(lambda: ck.brief_sample(*a, **kw)):.4f} ms, plain "
        f"{cuda_ms(lambda: ck._brief_sample_plain(*a, **kw)):.4f} ms "
        f"[{card_line}]")
    k4 = dict(cases[0])
    k4["cases"] = cases
    k4["paths"] = {"orb unpaired": n_unp["windows"],
                   "orb lane_gather": n_lg["windows"],
                   "orb n_features=2001": n_odd["windows"],
                   "orb quadtree": n_quad["windows"],
                   "harris_at_windows": n_hw["windows"]}

    err = 0.0
    for src, idx in (c[0] for c in rec_l.calls):
        e = max_err(ck.lane_gather(src, idx),
                    ck._lane_gather_plain(src, idx))
        if e != 0.0:
            raise AssertionError(f"lane_gather differs from its plain "
                                 f"version: {e}")
        err = max(err, e)
    src, idx = rec_l.calls[0][0]
    idx64 = idx.long().clamp(0, 127)
    nbytes = src.numel() * 4 * 3
    bms, by = bound(nbytes)
    k5 = {"launches": n_lg["lane_gather"], "max_abs_err": err,
          "ms": cuda_ms(lambda: ck.lane_gather(src, idx)),
          "plain_ms": cuda_ms(lambda: ck._lane_gather_plain(src, idx)),
          "library_ms": cuda_ms(lambda: torch.gather(src, 1, idx64)),
          "bound_ms": bms, "bound_by": by}
    log(f"K5 lane_gather ({tuple(src.shape)} f32 + i32 idx): launches 4 per "
        f"describe, all 4 bit-equal; kernel {k5['ms']:.4f} ms, plain "
        f"{k5['plain_ms']:.4f} ms, torch.gather (int64 indices ready) "
        f"{k5['library_ms']:.4f} ms, bound {bms:.5f} ms ({by}, {nbytes} B) "
        f"[{card_line}]")

    def stage(name, fn):
        log(f"stage {name}: {cuda_ms(fn):.3f} ms [{card_line}]")

    stage("orb paired (1 frame)", run)
    stage("orb unpaired (1 frame)", lambda: run(describe="unpaired"))
    stage("orb unpaired, lane_gather BRIEF (1 frame)",
          lambda: run(brief="lane_gather"))
    stage("orb gather form (1 frame)", lambda: run(describe="gather"))
    stage("orb quadtree (1 frame)",
          lambda: orb.orb_detect_and_describe_quadtree(frame, cfg,
                                                       device=DEV))
    stage("harris_at_windows (level-0 keypoints)",
          lambda: responses.harris_at_windows(gray_f, xy0))
    return k4, k5, paired


def phase_lk(card_line, img1, feats):
    """Track frame 1's ORB keypoints into an affine warp of it. Returns
    (K4 cases, K4 launches by path, K7 launches by path)."""
    params = optical_flow.PyrLKParams()
    frame1 = torch.as_tensor(img1, device=DEV)
    m = warp.get_rotation_matrix2d((W / 2, H / 2), 2.0, 1.0,
                                   device="cpu").double().numpy()
    m[:, 2] += (6.0, -4.0)
    pts = feats.xy[feats.mask].contiguous()
    true = pts.double().cpu().numpy() @ m[:, :2].T + m[:, 2]
    p0 = pts.cpu().numpy()
    margin = 24.0
    interior = ((np.minimum(p0, true) >= margin).all(1)
                & (np.maximum(p0[:, 0], true[:, 0]) <= W - 1 - margin)
                & (np.maximum(p0[:, 1], true[:, 1]) <= H - 1 - margin))

    def path(method, stats=None):
        frame2 = warp.warp_affine(frame1, m, (H, W), device=DEV)
        return optical_flow.calc_optical_flow_pyr_lk(
            frame1, frame2, pts, params, method=method, device=DEV,
            stats=stats)

    results, paths, remaps, cases = {}, {}, {}, []
    for method in ("taps", "windows", "gather"):
        path(method)                                # warm-up
        stats = {}
        with Record("windows") as rec:
            res, launches = counted(lambda: path(method, stats))
        iters = stats["iterations"]
        want = {"taps": sum(4 + it for it in iters),
                "windows": 4 * len(iters), "gather": 0}[method]
        only(launches, {"remap": 1, "windows": want} if want
             else {"remap": 1})
        per_level = {}
        for a, _ in rec.calls:
            per_level[tuple(a[0].shape)] = per_level.get(
                tuple(a[0].shape), 0) + 1
        st = res.status.cpu().numpy()
        epe = np.linalg.norm(res.points.double().cpu().numpy() - true,
                             axis=1)
        tracked = float(st[interior].mean())
        med = float(np.median(epe[interior & st]))
        if not (torch.isfinite(res.points).all()
                and torch.isfinite(res.errors).all()):
            raise AssertionError(f"lk {method}: result not finite")
        ms = cuda_ms(lambda: path(method), reps=5, warmup=1)
        log(f"lk {method}: {len(p0)} points ({int(interior.sum())} "
            f"interior), tracked {int(st.sum())} ({tracked:.4f} of "
            f"interior), end-point error median {med:.4f} px, p95 "
            f"{float(np.percentile(epe[interior & st], 95)):.4f} px; Newton "
            f"iterations per level (finest first) {iters}; K4 launches "
            f"{launches['windows']} = per level "
            f"{[per_level[k] for k in sorted(per_level, reverse=True)]}; "
            f"warp + track {ms:.3f} ms [{card_line}]")
        results[method] = res
        paths[f"lk {method}"] = launches["windows"]
        remaps[f"lk {method}"] = launches["remap"]
        if method == "taps":
            if not (tracked >= 0.9 and med < 0.1):
                raise AssertionError("lk taps outside the bounds (>= 90% "
                                     "of interior points, median < 0.1 px)")
            for a, kw in rec.calls:           # every call of the path
                if not torch.equal(ck.windows(*a, **kw),
                                   ck._windows_plain(*a, **kw)):
                    raise AssertionError("windows (lk taps) differs from "
                                         "its plain version")
            cases.append(windows_case(*rec.calls[-1], card_line,
                                      "lk taps, level 0"))
        if method == "windows":
            cases.append(windows_case(*rec.calls[-1], card_line,
                                      "lk windows, level 0"))
        device_share(f"lk {method} (warp + track)", lambda: path(method),
                     card_line)
    for method in ("windows", "gather"):
        both = (results[method].status & results["taps"].status).cpu().numpy()
        d = (results[method].points - results["taps"].points).norm(
            dim=1).cpu().numpy()
        log(f"lk {method} vs taps: {int(both.sum())} tracked by both, "
            f"|difference| median {float(np.median(d[both])):.5f} px, median "
            f"over interior {float(np.median(d[both & interior])):.5f} px, "
            f"max over interior {float(d[both & interior].max()):.4f} px")
    pre = optical_flow.build_lk_precomputed(
        frame1, warp.warp_affine(frame1, m, (H, W), device=DEV), params,
        device=DEV)
    log(f"stage build_lk_precomputed: "
        f"{cuda_ms(lambda: optical_flow.build_lk_precomputed(frame1, pre.next_levels[0], params, device=DEV)):.3f}"
        f" ms [{card_line}]")
    return cases, paths, remaps


def phase_preprocess(card_line):
    """K6 at 1080p → 640×640, stretch and letterbox."""
    hh, ww = HW_1080P
    img = np.random.default_rng(SEED + 4).integers(0, 256, (hh, ww, 3),
                                                   np.uint8)
    x = torch.as_tensor(img, device=DEV)
    cfg = preprocess.PreprocessorConfig(
        out_size=(640, 640), normalize=preprocess.NormalizeMode.MEAN_STD,
        mean=IMAGENET_MEAN, std=IMAGENET_STD)
    pre = preprocess.Preprocessor(cfg, device=DEV)
    pre(x)                                           # warm-up
    out, launches = counted(lambda: pre(x))
    only(launches, {"preprocess": 1})
    if tuple(out.shape) != (1, 3, 640, 640) or out.dtype != torch.float32 \
            or not torch.isfinite(out).all():
        raise AssertionError("preprocess output")
    args = (x, 640, 640, IMAGENET_MEAN, IMAGENET_STD)
    taps = ck._fused_preprocess_taps(*args)
    plain = ck._fused_preprocess_plain(*args)
    if not torch.equal(out[0], taps):
        raise AssertionError("preprocess differs from its own arithmetic in "
                             f"PyTorch ops: {max_err(out[0], taps)}")
    err = max_err(out[0], plain)
    ulp = float(((out[0] - plain).abs()
                 / torch.finfo(torch.float32).eps
                 / plain.abs().clamp(min=2.0 ** -126)).max())
    if err > PLAIN_TOL["preprocess"]:
        raise AssertionError(f"preprocess differs from its plain version: "
                             f"{err}")
    src = x.permute(2, 0, 1)[None].float().contiguous()
    scale, bias = (torch.as_tensor(a, device=DEV)[None, :, None, None]
                   for a in ck._norm_scale_bias(IMAGENET_MEAN, IMAGENET_STD))

    def lib_resize():
        return torch.nn.functional.interpolate(
            src, size=(640, 640), mode="bilinear", align_corners=False,
            antialias=False)

    def lib_all():
        t = torch.nn.functional.interpolate(
            x.permute(2, 0, 1)[None].float(), size=(640, 640),
            mode="bilinear", align_corners=False, antialias=False)
        return t * scale + bias

    lib_dev = max_err(lib_all()[0], plain)
    yi, _ = ck._resize_taps(hh, 640)
    xi, _ = ck._resize_taps(ww, 640)
    touched = np.zeros((hh, ww), bool)
    touched[np.ix_(np.unique(yi), np.unique(xi))] = True
    nbytes = (int(touched.sum()) * 3 + out.numel() * 4
              + (yi.size + xi.size) * 8)
    bms, by = bound(nbytes, out.numel() * 11)
    row = {"max_abs_err": err,
           "ms": cuda_ms(lambda: ck.fused_preprocess(*args)),
           "plain_ms": cuda_ms(lambda: ck._fused_preprocess_plain(*args)),
           "library_ms": cuda_ms(lib_resize), "bound_ms": bms,
           "bound_by": by}
    log(f"K6 preprocess ({hh}x{ww}x3 u8 -> 3x640x640 f32, ImageNet "
        f"mean/std): launches 1; bit-equal to the two-tap formula in "
        f"PyTorch ops; vs the plain version (dense f32 matmuls) max |diff| "
        f"{err:.3e} (largest relative {ulp:.2f} eps); kernel "
        f"{row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, "
        f"F.interpolate on ready f32 NCHW {row['library_ms']:.4f} ms "
        f"(with u8->f32, CHW and normalise {cuda_ms(lib_all):.4f} ms; max "
        f"|dev| from plain {lib_dev:.3e}), bound {bms:.5f} ms ({by}, "
        f"{nbytes} B); entry point {cuda_ms(lambda: pre(x)):.4f} ms "
        f"[{card_line}]")

    # 1920/640 = 3 and 1080/640 = 27/16: every tap weight above is a
    # multiple of 1/32, so all products are exact. A classifier's 224 x 224
    # has weights that are not: the dense products' rounding shows here.
    c224 = preprocess.PreprocessorConfig(
        out_size=(224, 224), normalize=preprocess.NormalizeMode.MEAN_STD,
        mean=IMAGENET_MEAN, std=IMAGENET_STD)
    o224, n224 = counted(
        lambda: preprocess.resize_normalize_to_tensor(x, c224, device=DEV))
    only(n224, {"preprocess": 1})
    a224 = (x, 224, 224, IMAGENET_MEAN, IMAGENET_STD)
    if not torch.equal(o224[0], ck._fused_preprocess_taps(*a224)):
        raise AssertionError("preprocess 224 differs from its own "
                             "arithmetic in PyTorch ops")
    p224 = ck._fused_preprocess_plain(*a224)
    e224 = max_err(o224[0], p224)
    if e224 > PLAIN_TOL["preprocess"]:
        raise AssertionError(f"preprocess 224 differs from its plain "
                             f"version: {e224}")
    log(f"K6 preprocess ({hh}x{ww}x3 u8 -> 3x224x224): launches 1; "
        f"bit-equal to the two-tap formula; vs the plain version max |diff| "
        f"{e224:.3e} on {float((o224[0] != p224).float().mean()):.4f} of the "
        f"values (tolerance {PLAIN_TOL['preprocess']:.0e}); kernel "
        f"{cuda_ms(lambda: ck.fused_preprocess(*a224)):.4f} ms, plain "
        f"{cuda_ms(lambda: ck._fused_preprocess_plain(*a224)):.4f} ms "
        f"[{card_line}]")
    row["max_abs_err"] = max(err, e224)

    lcfg = preprocess.PreprocessorConfig(
        out_size=(640, 640), resize_mode=preprocess.ResizeMode.LETTERBOX,
        normalize=preprocess.NormalizeMode.MEAN_STD, mean=IMAGENET_MEAN,
        std=IMAGENET_STD)
    lout, llaunch = counted(
        lambda: preprocess.resize_normalize_to_tensor(x, lcfg, device=DEV))
    only(llaunch, {"preprocess": 1})
    inner = ck._fused_preprocess_taps(x, 360, 640, IMAGENET_MEAN,
                                      IMAGENET_STD)
    if tuple(lout.shape) != (1, 3, 640, 640) or \
            not torch.equal(lout[0, :, 140:500, :], inner):
        raise AssertionError("letterbox interior (360 x 640 at row 140)")
    pad = torch.tensor([(lcfg.pad_value - mu) / sd for mu, sd in
                        zip(IMAGENET_MEAN, IMAGENET_STD)], device=DEV)
    border = torch.cat([lout[0, :, :140], lout[0, :, 500:]], dim=1)
    if float((border - pad[:, None, None]).abs().max()) > 1e-6:
        raise AssertionError("letterbox pad canvas")
    cpu = preprocess.resize_normalize_to_tensor(img, lcfg, device="cpu")
    log(f"preprocess letterbox (1080x1920 -> 360x640 on a 640x640 canvas): "
        f"launches 1, interior bit-equal to the two-tap formula, pad rows "
        f"equal (pad - mean)/std; max |card - cpu| "
        f"{max_err(lout.cpu(), cpu):.3e}; entry point "
        f"{cuda_ms(lambda: preprocess.resize_normalize_to_tensor(x, lcfg, device=DEV)):.4f}"
        f" ms [{card_line}]")
    row["launches"] = (launches["preprocess"] + n224["preprocess"]
                       + llaunch["preprocess"])
    return row


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
    rows, cols = orb._brief_tap_coords(ang, cfg.pattern_seed, cfg.pattern,
                                       half_w=32)
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

    # 9-11. the third slice
    k4, k5, feats = phase_orb_variants(card_line, img1)
    lk_cases, lk_paths, lk_remaps = phase_lk(card_line, img1, feats)
    k4["cases"] += lk_cases
    k4["paths"].update(lk_paths)
    k4["launches"] = sum(k4["paths"].values())
    k4["max_abs_err"] = max(c["max_abs_err"] for c in k4["cases"])
    k7["paths"] = {"rectify": k7["launches"], **lk_remaps}
    k7["launches"] = sum(k7["paths"].values())
    k6 = phase_preprocess(card_line)
    keep = ("launches", "max_abs_err", "ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms")
    for name, row in (("windows", k4), ("lane_gather", k5),
                      ("preprocess", k6), ("remap", k7), ("lane_shift", k8),
                      ("shear_x", k9)):
        src, rep = KERNELS[name]
        entry = {"name": name, "route": "cuda", "source": src,
                 "replaces": rep}
        entry.update({k: row[k] for k in keep})
        if "cases" in row:
            entry["cases"] = [{k: c[k] for k in ("case",) + keep if k in c}
                              for c in row["cases"]]
        if "paths" in row:
            entry["launches_by_path"] = row["paths"]
        rows_out.append(entry)
    for row in rows_out:
        if row["launches"] < 1 or \
                row["max_abs_err"] > PLAIN_TOL.get(row["name"], 0.0):
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
