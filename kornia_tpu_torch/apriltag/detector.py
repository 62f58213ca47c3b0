"""AprilTag detector: threshold → CCL → boundary clusters → quads → decode
(port of kornia_tpu/apriltag/detector.py).

The reference's host/device split: the dense threshold runs on the card
(threshold.py); the CCL, the boundary clustering and the quad fit run in
native C++ (``native/apriltag_mid.cpp``, or the numpy stages when
``KORNIA_TPU_APRILTAG_MID=numpy``); the decode is float64 numpy on the
host. One read-back a frame brings the thresholded image, and the gray
when it came as a device tensor, to the host.
"""

from __future__ import annotations

import ctypes
import os
import sys
import time
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from kornia_tpu_torch import resolve_device
from kornia_tpu_torch.apriltag import threshold as thr_mod
from kornia_tpu_torch.apriltag.families import get_family
from kornia_tpu_torch.native import load_native_library
from kornia_tpu_torch.ops.connected_components import label_classes_host


@dataclass
class Detection:
    """One decoded tag (reference: decoder.rs Detection)."""

    tag_id: int
    family: str
    hamming: int
    decision_margin: float
    center: np.ndarray            # (2,) xy
    corners: np.ndarray           # (4, 2) xy, CCW, corner 0 = tag (-1,-1)
    homography: np.ndarray        # (3, 3) tag [-1,1]² → image px


@dataclass
class DetectorConfig:
    """Mirror of the reference's DecodeTagsConfig (lib.rs:57)."""

    families: Tuple[str, ...] = ("tag36h11",)
    max_hamming: int = 2
    quad_decimate: int = 1
    min_cluster_pixels: int = 24
    max_cluster_pixels: int = 50000
    min_tag_area: float = 64.0
    tile_size: int = 4
    min_white_black_diff: int = 5
    # where between tile min/max the black/white cut sits (reference
    # threshold.rs adaptive_threshold_with_split; their decoder default
    # is 0.33). 0.5 = classic midpoint. THIS pipeline's measured optimum
    # on the real-photo fixture is 0.6 — biasing toward BLACK severs the
    # sub-pixel white leaks between a tag's interior cells and the
    # background (under the C library's white-8-connectivity rule one
    # leaked diagonal merges them into one component and the tag's
    # boundary cluster becomes unfittable): 14/14 recall vs 10/14 at
    # 0.33/0.5 (tests/test_apriltag.py::test_real_photo_recall)
    threshold_split: float = 0.6
    decode_sharpening: float = 0.25


def _homography_dlt4(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """Exact 4-point DLT homography (host, f64)."""
    a = []
    for (x, y), (u, v) in zip(src, dst):
        a.append([-x, -y, -1, 0, 0, 0, u * x, u * y, u])
        a.append([0, 0, 0, -x, -y, -1, v * x, v * y, v])
    _, _, vt = np.linalg.svd(np.asarray(a, np.float64))
    h = vt[-1].reshape(3, 3)
    return h / h[2, 2]


def _homography_dlt4_batch(src: np.ndarray,
                           quads: np.ndarray) -> np.ndarray:
    """(N, 4, 2) quads → (N, 3, 3) homographies mapping the fixed
    ``src`` tag corners onto each quad, via one batched LAPACK SVD."""
    n = quads.shape[0]
    a = np.zeros((n, 8, 9), np.float64)
    for i, (x, y) in enumerate(src):
        u = quads[:, i, 0]
        v = quads[:, i, 1]
        a[:, 2 * i, 0] = -x
        a[:, 2 * i, 1] = -y
        a[:, 2 * i, 2] = -1.0
        a[:, 2 * i, 6] = u * x
        a[:, 2 * i, 7] = u * y
        a[:, 2 * i, 8] = u
        a[:, 2 * i + 1, 3] = -x
        a[:, 2 * i + 1, 4] = -y
        a[:, 2 * i + 1, 5] = -1.0
        a[:, 2 * i + 1, 6] = v * x
        a[:, 2 * i + 1, 7] = v * y
        a[:, 2 * i + 1, 8] = v
    _, _, vt = np.linalg.svd(a)
    h = vt[:, -1].reshape(n, 3, 3)
    return h / h[:, 2:3, 2:3]


def _project_batch(h: np.ndarray, pts: np.ndarray) -> np.ndarray:
    """(N, 3, 3) x (P, 2) → (N, P, 2)."""
    p = np.einsum("nij,pj->npi", h[:, :, :2], pts) + h[:, None, :, 2]
    return p[..., :2] / p[..., 2:3]


def _project(h: np.ndarray, pts: np.ndarray) -> np.ndarray:
    p = pts @ h[:, :2].T + h[:, 2]
    return p[:, :2] / p[:, 2:3]


def _boundary_points(threshim: np.ndarray, labels: np.ndarray):
    """Black/white boundary points keyed by (black_label, white_label).

    Reference behavior: segmentation.rs gradient clusters. Returns
    (keys u64, x2 f32, y2 f32) where (x2, y2) are doubled midpoint
    coordinates (0.5-px resolution, like the reference/apriltag C).
    """
    t = threshim
    keys, xs, ys = [], [], []
    for dy, dx in ((0, 1), (1, 0), (1, 1), (1, -1)):
        if dx >= 0:
            a = t[: t.shape[0] - dy, : t.shape[1] - dx]
            b = t[dy:, dx:]
            la = labels[: t.shape[0] - dy, : t.shape[1] - dx]
            lb = labels[dy:, dx:]
            ya, xa = np.mgrid[0: a.shape[0], 0: a.shape[1]]
        else:
            a = t[: t.shape[0] - dy, -dx:]
            b = t[dy:, : t.shape[1] + dx]
            la = labels[: t.shape[0] - dy, -dx:]
            lb = labels[dy:, : t.shape[1] + dx]
            ya, xa = np.mgrid[0: a.shape[0], 0: a.shape[1]]
            xa = xa - dx  # actual x of `a`
        m = ((a.astype(np.int16) + b.astype(np.int16)) == 255) \
            & (la > 0) & (lb > 0)
        if not m.any():
            continue
        la_m = la[m].astype(np.uint64)
        lb_m = lb[m].astype(np.uint64)
        black_first = np.where(a[m] == 0, la_m, lb_m)
        white_first = np.where(a[m] == 0, lb_m, la_m)
        keys.append((black_first << np.uint64(32)) | white_first)
        xs.append((2 * xa[m] + dx).astype(np.float32))
        ys.append((2 * ya[m] + dy).astype(np.float32))
    if not keys:
        return (np.empty(0, np.uint64), np.empty(0, np.float32),
                np.empty(0, np.float32))
    return np.concatenate(keys), np.concatenate(xs), np.concatenate(ys)


def _convex_hull(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """Andrew's monotone chain; returns indices into (x, y), CCW."""
    order = np.lexsort((y, x))
    pts = np.stack([x[order], y[order]], 1)

    def half(indices):
        out: List[int] = []
        for i in indices:
            while len(out) >= 2:
                o, a = pts[out[-2]], pts[out[-1]]
                if ((a[0] - o[0]) * (pts[i][1] - o[1])
                        - (a[1] - o[1]) * (pts[i][0] - o[0])) <= 0:
                    out.pop()
                else:
                    break
            out.append(i)
        return out[:-1]

    idx = list(range(len(pts)))
    lower = half(idx)
    upper = half(idx[::-1])
    return order[np.asarray(lower + upper, np.int64)]


def _fit_quad(px: np.ndarray, py: np.ndarray,
              cfg: DetectorConfig) -> Optional[np.ndarray]:
    """Fit an ordered convex quad to a boundary cluster.

    Corner hypothesis = 4 strongest local maxima of centroid distance in
    angular order; sides refined by total-least-squares line fits and
    corners recomputed as line intersections (reference: quad.rs).
    Returns (4, 2) xy corners (CCW in image coords) or None.

    Unlike the native fit (apriltag_mid.cpp:79, a 20-bit sort-key index),
    this one has no cap at 2^20 points; it matters only when
    ``max_cluster_pixels`` admits such clusters. The reference's two
    routes differ there the same way, and the port keeps both as they
    are (each is held to its own reference route).
    """
    cx, cy = px.mean(), py.mean()
    ang = np.arctan2(py - cy, px - cx)
    order = np.argsort(ang)
    x, y = px[order], py[order]
    n = len(x)

    # corner hypotheses: farthest point pair, then the extreme point on
    # each side of that diagonal (robust for oblique quads where
    # distance-to-centroid peaks are weak). The extremes of these
    # vectorized argmaxes are convex-hull vertices by construction, so
    # the per-point Python hull loop (the old ~5 ms/cluster hot spot —
    # 640 ms/frame at 113 clusters) is unnecessary.
    # subsample the farthest-pair search on big clusters (the corners
    # are re-derived from full-resolution line fits below, so coarse
    # initial picks are fine); ceil-stride caps the pairwise matrix at
    # 192² (the floor-stride 256-target admitted up to 334 samples —
    # the O(ns²) scan was the largest fit_quad substage, PERF_NOTES
    # round 5g; must match apriltag_mid.cpp's stride exactly)
    stride = max(1, -(-n // 192))
    cand = np.arange(0, n, stride)
    xc, yc_ = x[cand], y[cand]
    da = (xc[:, None] - xc[None, :]) ** 2 + (yc_[:, None] - yc_[None, :]) ** 2
    ia_, ib_ = np.unravel_index(np.argmax(da), da.shape)
    ia, ib = cand[ia_], cand[ib_]
    ax, ay, bx, by = x[ia], y[ia], x[ib], y[ib]
    side = (bx - ax) * (y - ay) - (by - ay) * (x - ax)
    if side.max() <= 0 or side.min() >= 0:
        return None
    ic = int(np.argmax(side))
    id_ = int(np.argmin(side))
    picked = sorted({int(ia), int(ib), ic, id_})
    if len(picked) < 4:
        return None

    corners = []
    lines = []
    for i in range(4):
        a = picked[i]
        b = picked[(i + 1) % 4]
        idx = np.arange(a, b + 1) % n if b > a else \
            np.arange(a, b + n + 1) % n
        if len(idx) < 4:
            return None
        # trim ends so corner blobs don't skew the line fit
        trim = max(1, len(idx) // 8)
        idx = idx[trim:-trim] if len(idx) > 2 * trim + 2 else idx
        sx, sy = x[idx], y[idx]
        mx, my = sx.mean(), sy.mean()
        dxs, dys = sx - mx, sy - my
        # principal axis of the 2x2 covariance, closed form (replaces a
        # per-side LAPACK SVD call)
        sxx = float(dxs @ dxs)
        syy = float(dys @ dys)
        sxy = float(dxs @ dys)
        theta = 0.5 * np.arctan2(2.0 * sxy, sxx - syy)
        direction = np.array([np.cos(theta), np.sin(theta)])
        normal = np.array([-direction[1], direction[0]])
        lines.append((normal, normal @ np.array([mx, my])))
    for i in range(4):
        n1, c1 = lines[i - 1]
        n2, c2 = lines[i]
        a = np.stack([n1, n2])
        if abs(np.linalg.det(a)) < 1e-9:
            return None
        corners.append(np.linalg.solve(a, np.array([c1, c2])))
    q = np.asarray(corners)

    # convexity + area checks, normalize to CCW (positive shoelace)
    area = 0.0
    for i in range(4):
        j = (i + 1) % 4
        area += q[i, 0] * q[j, 1] - q[j, 0] * q[i, 1]
    area /= 2.0
    if abs(area) < cfg.min_tag_area:
        return None
    if area < 0:
        q = q[::-1].copy()
    cross = []
    for i in range(4):
        v1 = q[(i + 1) % 4] - q[i]
        v2 = q[(i + 2) % 4] - q[(i + 1) % 4]
        cross.append(v1[0] * v2[1] - v1[1] * v2[0])
    if not all(c > 0 for c in cross):
        return None
    return q


def _native_quads(threshim: np.ndarray,
                  cfg: "DetectorConfig") -> List[np.ndarray]:
    """The fused native mid-pipeline: CCL, boundary clustering, the
    cluster filter and the quad fit in one C++ call
    (native/apriltag_mid.cpp). Returns a list of (4, 2) quads."""
    fn = load_native_library().kornia_apriltag_quads
    fn.restype = ctypes.c_int64
    fn.argtypes = [ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
                   ctypes.c_int64, ctypes.c_uint8,
                   ctypes.c_int32, ctypes.c_int32, ctypes.c_float,
                   ctypes.POINTER(ctypes.c_float), ctypes.c_int64]
    t = np.ascontiguousarray(threshim, np.uint8)
    max_quads = 4096
    out = np.empty((max_quads, 4, 2), np.float32)
    nq = fn(t.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            t.shape[0], t.shape[1], thr_mod.UNKNOWN,
            cfg.min_cluster_pixels, cfg.max_cluster_pixels,
            cfg.min_tag_area,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            max_quads)
    if nq < 0:
        raise ValueError(f"kornia_apriltag_quads refused a "
                         f"{t.shape} threshold image")
    return [out[i].astype(np.float64) for i in range(int(nq))]


def _bilinear_sample(img: np.ndarray, pts: np.ndarray) -> np.ndarray:
    h, w = img.shape
    x = np.clip(pts[:, 0], 0, w - 1.001)
    y = np.clip(pts[:, 1], 0, h - 1.001)
    x0 = x.astype(np.int64)
    y0 = y.astype(np.int64)
    fx, fy = x - x0, y - y0
    v = (img[y0, x0] * (1 - fx) * (1 - fy)
         + img[y0, x0 + 1] * fx * (1 - fy)
         + img[y0 + 1, x0] * (1 - fx) * fy
         + img[y0 + 1, x0 + 1] * fx * fy)
    return v


class AprilTagDecoder:
    """Full-pipeline AprilTag detector; the threshold runs on ``device``
    (default ``"cuda"``).

    >>> det = AprilTagDecoder(DetectorConfig(families=("tag36h11",)))
    >>> detections = det.decode(gray_u8)

    ``KORNIA_TPU_APRILTAG_TRACE=1`` prints a per-stage ms table to stderr
    and keeps it in ``last_trace`` (name → ms); the threshold's stage
    then waits for the device, so its time is the device's.
    """

    def __init__(self, config: DetectorConfig = DetectorConfig(),
                 device="cuda"):
        self.config = config
        self.device = resolve_device(device)
        self._families = [get_family(f) for f in config.families]
        self.last_trace = {}

    def decode(self, gray) -> List[Detection]:
        """Detect tags in an (H, W) or (H, W, C) gray image (channel 0),
        a numpy array or a tensor."""
        trace = os.environ.get("KORNIA_TPU_APRILTAG_TRACE")
        stamps = [("start", time.perf_counter())]
        dev = self.device

        def mark(name, wait=False):
            if trace:
                if wait and dev.type == "cuda":
                    torch.cuda.synchronize(dev)
                stamps.append((name, time.perf_counter()))

        cfg = self.config
        step = cfg.quad_decimate
        if isinstance(gray, torch.Tensor):
            gray_t = gray.to(dev)
            full = None
        else:
            gray = np.asarray(gray)
            if gray.ndim == 3:
                gray = gray[:, :, 0]
            full = gray.astype(np.float32)
            gray_t = torch.as_tensor(np.ascontiguousarray(gray), device=dev)
        if gray_t.ndim == 3:
            gray_t = gray_t[..., 0]
        gray_d = gray_t[::step, ::step] if step > 1 else gray_t
        thresh_t = thr_mod.adaptive_threshold(
            gray_d, cfg.tile_size, cfg.min_white_black_diff,
            cfg.threshold_split, device=dev)
        mark(f"threshold[{dev.type}]", wait=True)

        # the one read-back: the threshold image, and a u8 gray with it
        if full is not None:
            threshim = thresh_t.cpu().numpy()
        elif gray_t.dtype == torch.uint8:
            both = torch.cat([thresh_t.reshape(-1),
                              gray_t.reshape(-1)]).cpu().numpy()
            threshim = both[: thresh_t.numel()].reshape(thresh_t.shape)
            full = both[thresh_t.numel():].reshape(
                gray_t.shape).astype(np.float32)
        else:
            threshim = thresh_t.cpu().numpy()
            full = gray_t.to(torch.float32).cpu().numpy()
        mark("readback")

        scale = float(cfg.quad_decimate)
        if os.environ.get("KORNIA_TPU_APRILTAG_MID", "native") != "numpy":
            quads = _native_quads(threshim, cfg)
            mark("ccl+cluster+quads[native C++]")
        else:
            labels = label_classes_host(threshim, skip=thr_mod.UNKNOWN)
            mark("ccl[native C++]")

            keys, x2, y2 = _boundary_points(threshim, labels)
            mark("boundary[host]")
            if keys.size == 0:
                return []
            order = np.argsort(keys, kind="stable")
            keys, x2, y2 = keys[order], x2[order], y2[order]
            uniq, starts = np.unique(keys, return_index=True)
            ends = np.r_[starts[1:], keys.size]

            # vectorized cluster prefilter: size and bounding-box area
            npts_all = ends - starts
            bbox_w = (np.maximum.reduceat(x2, starts)
                      - np.minimum.reduceat(x2, starts)) / 2.0
            bbox_h = (np.maximum.reduceat(y2, starts)
                      - np.minimum.reduceat(y2, starts)) / 2.0
            keep = ((npts_all >= cfg.min_cluster_pixels)
                    & (npts_all <= cfg.max_cluster_pixels)
                    & (bbox_w * bbox_h >= cfg.min_tag_area)
                    & (npts_all <= 6 * (bbox_w + bbox_h) + 16))

            mark("cluster_filter[host]")
            quads = []
            for s, e in zip(starts[keep], ends[keep]):
                quad = _fit_quad(x2[s:e] / 2.0, y2[s:e] / 2.0, cfg)
                if quad is not None:
                    quads.append(quad)
            mark("quad_fit[host]")
        detections = self._decode_quads(
            full, [quad * scale for quad in quads])
        mark("decode[host]")
        kept = _dedup(detections)
        mark("dedup[host]")
        if trace:
            self.last_trace = {n: 1e3 * (t1 - t0) for (_, t0), (n, t1)
                               in zip(stamps, stamps[1:])}
            total = (stamps[-1][1] - stamps[0][1]) * 1e3
            parts = " ".join(f"{n}={ms:.2f}ms"
                             for n, ms in self.last_trace.items())
            print(f"# apriltag stages: {parts} total={total:.2f}ms "
                  f"({len(quads)} quads, {len(detections)} det)",
                  file=sys.stderr)
        return kept

    # ------------------------------------------------------------- decode
    def _decode_quads(self, gray_f: np.ndarray,
                      quads: List[np.ndarray]) -> List[Detection]:
        """Decode all quads batched: one LAPACK SVD batch for the
        homographies and one bilinear-sampling pass per family instead
        of per-quad python loops (reference: decoder.rs decode_tags;
        the 45 ms/frame host decode stage drops to a few ms)."""
        cfg = self.config
        if not quads:
            return []
        tag_corners = np.array(
            [[-1.0, -1.0], [1.0, -1.0], [1.0, 1.0], [-1.0, 1.0]])
        q = np.asarray(quads, np.float64)             # (N, 4, 2)
        n = q.shape[0]
        hs = _homography_dlt4_batch(tag_corners, q)   # (N, 3, 3)

        best: List[Optional[Detection]] = [None] * n
        for fam in self._families:
            wb = fam.width_at_border
            centers = fam.bit_centers_tag()           # (nbits, 2)
            nbits = centers.shape[0]
            pts = _project_batch(hs, centers).reshape(-1, 2)
            samples = _bilinear_sample(gray_f, pts).reshape(n, nbits)

            # black/white model from the border ring and the quiet zone
            ring = np.linspace(-1 + 1.0 / wb, 1 - 1.0 / wb, wb)
            inner_edge = 1 - 1.0 / wb
            outer_edge = 1 + 1.0 / wb
            border_pts = np.concatenate([
                np.stack([ring, np.full(wb, -inner_edge)], 1),
                np.stack([ring, np.full(wb, inner_edge)], 1),
                np.stack([np.full(wb, -inner_edge), ring], 1),
                np.stack([np.full(wb, inner_edge), ring], 1),
            ])
            quiet_pts = border_pts * (outer_edge / inner_edge)
            dark = _bilinear_sample(
                gray_f, _project_batch(hs, border_pts).reshape(-1, 2)
            ).reshape(n, -1)
            light = _bilinear_sample(
                gray_f, _project_batch(hs, quiet_pts).reshape(-1, 2)
            ).reshape(n, -1)
            if fam.reversed_border:
                dark, light = light, dark
            black = np.median(dark, axis=1)
            white = np.median(light, axis=1)
            ok = (white - black) >= 2 * cfg.min_white_black_diff
            mid = (black + white) / 2.0
            bits = samples > mid[:, None]
            margins = np.min(np.abs(samples - mid[:, None]), axis=1)
            # MSB-first code packing, vectorized over quads
            shifts = np.arange(nbits - 1, -1, -1, dtype=np.uint64)
            codes = (bits.astype(np.uint64) << shifts[None, :]).sum(
                axis=1, dtype=np.uint64)

            max_h = min(cfg.max_hamming, fam.max_safe_hamming)
            for i in np.nonzero(ok)[0]:
                m = fam.match(int(codes[i]), max_h)
                if m is None:
                    continue
                tag_id, ham, rot = m
                prev = best[i]
                if prev is None or ham < prev.hamming:
                    # rotation r means the observed code matched after
                    # r 90°-rotations: re-anchor corner 0 onto the
                    # tag's (-1,-1) corner and rebuild H in that frame
                    corners = np.roll(q[i], rot, axis=0)
                    h_fix = (_homography_dlt4(tag_corners, corners)
                             if rot else hs[i])
                    center = _project(h_fix, np.zeros((1, 2)))[0]
                    best[i] = Detection(
                        tag_id=tag_id, family=fam.name, hamming=ham,
                        decision_margin=float(margins[i]),
                        center=center, corners=corners,
                        homography=h_fix,
                    )
        return [d for d in best if d is not None]


def _dedup(dets: List[Detection]) -> List[Detection]:
    """Keep the best detection per (family, id) among overlapping quads
    (reference: lib.rs:338 dedup_detections)."""
    out: List[Detection] = []
    for d in sorted(dets, key=lambda d: (d.hamming, -d.decision_margin)):
        dup = False
        for kept in out:
            if np.linalg.norm(kept.center - d.center) < 10.0:
                dup = True
                break
        if not dup:
            out.append(d)
    return out
