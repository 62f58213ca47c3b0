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
from kornia_tpu_torch.geometry import twoview
from kornia_tpu_torch.ops import cuda_kernels as ck
from kornia_tpu_torch.ops.filters import gaussian_blur

H, W = 480, 752
SEED = 0
REPS = 20
HBM_BYTES_PER_S = 3.35e12   # H100 SXM, NVIDIA data sheet
F32_OPS_PER_S = 67e12       # float32 outside the tensor cores
K_EUROC = np.array([[458.654, 0.0, 367.215], [0.0, 457.296, 248.375],
                    [0.0, 0.0, 1.0]])
KERNELS = {
    "fast_harris": ("kornia_tpu_torch/ops/csrc/fast_harris.cu",
                    "kornia_tpu/ops/pallas_kernels.py:143"),
    "windows_paired": ("kornia_tpu_torch/ops/csrc/windows_paired.cu",
                       "kornia_tpu/ops/pallas_kernels.py:451"),
    "brief_sample": ("kornia_tpu_torch/ops/csrc/brief_sample.cu",
                     "kornia_tpu/ops/pallas_kernels.py:519"),
}
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


def render_scene(seed: int = SEED):
    """Two views of a 'roof' of two textured planes z = 5 ∓ X (they meet
    at X = 0), camera 2 = R·X + t. Returns (img1, img2, R, t)."""
    rng = np.random.default_rng(seed)
    texs = [_texture(rng), _texture(rng)]
    planes = [(np.array([1.0, 0.0, 1.0]), 5.0),    # X > 0 side
              (np.array([-1.0, 0.0, 1.0]), 5.0)]   # X < 0 side
    ang = np.deg2rad([1.0, -2.0, 0.5])
    cx, cy, cz = np.cos(ang)
    sx, sy, sz = np.sin(ang)
    rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    r = rz @ ry @ rx
    center2 = np.array([0.3, 0.05, 0.02])
    t = -r @ center2
    kinv = np.linalg.inv(K_EUROC)
    vv, uu = np.mgrid[0:H, 0:W].astype(np.float64)
    pix = np.stack([uu, vv, np.ones_like(uu)], -1) @ kinv.T   # (H, W, 3)

    def view(rot, origin):
        d = pix @ rot          # world ray directions, rows: Rᵀ·dir
        best = np.full((H, W), np.inf)
        img = np.zeros((H, W))
        for (n, off), tex in zip(planes, texs):
            s = (off - origin @ n) / (d @ n)
            s = np.where(s > 0, s, np.inf)
            p = origin + s[..., None] * d
            val = _bilinear(tex, (p[..., 0] + 6.0) * 200.0,
                            (p[..., 1] + 6.0) * 200.0)
            take = s < best
            img = np.where(take, val, img)
            best = np.minimum(best, s)
        return np.clip(np.round(img), 0, 255).astype(np.uint8)

    img1 = view(np.eye(3), np.zeros(3))
    img2 = view(r, center2)
    return img1, img2, r, t / np.linalg.norm(t)


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


def device_share(img1, img2, card_line):
    """One whole pair under torch.profiler: the device's busy share of the
    host wall time, the number of kernels launched and the kernels that
    take the most device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    gen = torch.Generator(device=DEV).manual_seed(SEED)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_pair(img1, img2, "cuda", gen)
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
    log(f"profile whole pair: wall {wall_ms:.3f} ms (profiled), device busy "
        f"{busy_ms:.3f} ms = {busy_ms / wall_ms:.4f} of wall, {n} kernel "
        f"launches [{card_line}]")
    for e in sorted(kern, key=lambda e: -e.self_device_time_total)[:8]:
        log(f"  {e.self_device_time_total / 1e3:8.3f} ms  x{e.count:<5d} "
            f"{e.key[:90]}")


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
    want = {"fast_harris": 16, "windows_paired": 4, "brief_sample": 2}
    if launches != want:
        raise AssertionError(f"launch counts {launches} != {want}")
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

    def bound(nbytes, ops=0):
        tb = nbytes / HBM_BYTES_PER_S * 1e3
        to = ops / F32_OPS_PER_S * 1e3
        return (tb, "bytes") if tb >= to else (to, "operations")

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
    device_share(img1, img2, card_line)

    log(json.dumps({"kernels": rows_out}))
    log(card_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
