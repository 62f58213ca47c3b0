"""Hand-written CUDA kernels of the port, their plain PyTorch versions, the
build and the launch counters.

Each TPU kernel on a ported path (kornia_tpu/ops/pallas_kernels.py,
warp_pallas.py, warp_shear.py) has one CUDA C++ source under ``csrc/`` for
sm_90a and one wrapper here:

==============  ==========================================  =================
wrapper         replaces                                    source
==============  ==========================================  =================
fast_harris_    pallas_kernels.py::fast_score_pallas        fast_harris.cu
levels,         (nms=True, harris=True): up to 16 levels
fast_harris     of a pyramid in one launch, or one level
fast_score      the same kernel's score-only forms          fast_harris.cu
                (harris=False; nms on or off; border_mask
                under the XLA path's contract; any
                arc_length), one level
windows_paired  pallas_kernels.py::                         windows_paired.cu
                extract_windows_prepared_paired
brief_sample    pallas_kernels.py::brief_sample_pallas      brief_sample.cu
brief_rotated   the same kernel, with the tap rotation,     brief_sample.cu
                clamps and A < B compare of orb.py around
                it fused in
windows         pallas_kernels.py::extract_windows_prepared windows.cu
                (and extract_windows_pallas)
lane_gather     pallas_kernels.py::lane_gather, and a       lane_gather.cu
                broadcast-index mode (one index row for g
                source rows)
fused_          pallas_kernels.py::fused_preprocess_pallas  preprocess.cu
preprocess
remap           warp_pallas.py::_make_kernel                remap.cu
                (launched by _remap_chunks)
lane_shift      warp_pallas.py::_lane_shift_pallas          lane_shift.cu
shear_x         warp_shear.py::_shear_x                     shear_x.cu
shear_y         the same kernel on the transpose            shear_x.cu
                (warp_shear.py::_shear_y), as a column
                pass on the canvas in its own layout
==============  ==========================================  =================

Dispatch is by the tensor's device only: a CPU tensor runs the plain
version, a CUDA tensor launches the kernel or raises. There is no fallback.

Build: each source is compiled by ``nvcc`` into its own shared library with
a plain C interface, loaded with ctypes, in ``kornia_tpu_torch/_build/``
(git-ignored), named by the hash of the source, so an edited source is
rebuilt. The first kernel call builds every library, one ``nvcc`` per
source, all started together. ``LAUNCHES`` counts launches per C entry
point (``KERNELS``: one per library, and the extra entries of
``_EXTRA_ENTRIES``).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import operator
import os
import shutil
import subprocess
import time
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from kornia_tpu_torch.features import fast as _fast
from kornia_tpu_torch.features.responses import harris_response
from kornia_tpu_torch.ops.filters import gaussian_kernel1d
from kornia_tpu_torch.ops.resize import _resize_matrix

_CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "_build")
SOURCES = ("fast_harris", "windows_paired", "brief_sample", "windows",
           "lane_gather", "preprocess", "remap", "lane_shift", "shear_x")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-fmad=false",
              "-Xptxas", "-v")

# C entry points of a library beside ``kt_<library>``
_EXTRA_ENTRIES = {"fast_harris": ("fast_score",),
                  "brief_sample": ("brief_rotated",), "shear_x": ("shear_y",)}
KERNELS = SOURCES + tuple(e for v in _EXTRA_ENTRIES.values() for e in v)

LAUNCHES: Dict[str, int] = {name: 0 for name in KERNELS}
BUILD_LOG: Dict[str, str] = {}
_LIBS: Dict[str, ctypes.CDLL] = {}
_FNS: Dict[str, object] = {}     # C entry name → its bound ctypes function


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _lib_path(name: str) -> str:
    with open(os.path.join(_CSRC, name + ".cu"), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}_{digest.hexdigest()[:16]}.so")


def build(names: Sequence[str] = SOURCES) -> float:
    """Compile every library of ``names`` that is missing, all in parallel,
    and load them. Returns the wall seconds spent."""
    t0 = time.perf_counter()
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = []
    for name in names:
        out = _lib_path(name)
        if os.path.exists(out):
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
               os.path.join(_CSRC, name + ".cu")]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for name, out, tmp, proc in procs:
        log, _ = proc.communicate()
        BUILD_LOG[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}.cu (rc {proc.returncode}):\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    for name in names:
        if name not in _LIBS:
            _LIBS[name] = lib = ctypes.CDLL(_lib_path(name))
            _FNS.update(_bind(name, lib))
    return time.perf_counter() - t0


def _bind(name: str, lib: ctypes.CDLL) -> Dict[str, object]:
    """The C functions of library ``name`` by entry name, each with its
    signature set."""
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    sigs = {
        "fast_harris": [i, p, p, p, p, p, f, ctypes.POINTER(f), f, p],
        "fast_score": [p, i, i, p, p, f, i, i, p],
        "windows_paired": [p, p, p, i, i, i, i, i, i, p],
        "brief_sample": [p, p, p, p, i, i, i, i, p],
        "brief_rotated": [p, p, p, p, p, i, i, i, p],
        "windows": [p, p, p, i, i, i, i, i, i, i, i, p],
        "lane_gather": [p, p, p, ctypes.c_longlong, i, p],
        "preprocess": [p, i, p, p, p, p, ctypes.POINTER(f),
                       ctypes.POINTER(f), p, i, i, p],
        "remap": [p, i, i, i, i, p, i, i, i, p, p, ctypes.POINTER(f), p, i,
                  i, f, p],
        "lane_shift": [p, p, p, i, i, i, i, p],
        "shear_x": [p, p, p, i, i, i, p],
        "shear_y": [p, p, p, i, i, i, p],
    }
    fns = {}
    for entry in (name,) + _EXTRA_ENTRIES.get(name, ()):
        fn = getattr(lib, "kt_" + entry)
        fn.argtypes = sigs[entry]
        fn.restype = ctypes.c_int
        fns[entry] = fn
    return fns


# The launch path below runs on every kernel call, so it keeps to plain
# dict lookups and attribute reads: for a kernel of a few microseconds the
# wrapper's host time is most of what a caller waits (PERF.md section 6).


def _kernel(name: str, entry: str | None = None):
    """The bound C function ``kt_<entry or name>``; the first call builds
    every library."""
    fn = _FNS.get(entry or name)
    if fn is None:
        build()
        fn = _FNS[entry or name]
    return fn


def _check(t: torch.Tensor, what: str, dtype: torch.dtype, ndim: int):
    if not t.is_cuda:
        raise ValueError(f"{what}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{what}: expected {dtype}, got {t.dtype}")
    if t.ndim != ndim:
        raise ValueError(f"{what}: expected {ndim} dims, got {t.ndim}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: expected a contiguous tensor")


def _launched(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {rc}")
    LAUNCHES[name] += 1


@functools.lru_cache(maxsize=None)
def _raw_stream_fn():
    """PyTorch's current-stream handle reader of CUDA builds (device index
    → cudaStream_t as an int, no ``torch.cuda.Stream`` object made); looked
    up at the first launch, as CPU builds lack it."""
    return torch._C._cuda_getCurrentRawStream


def _stream(t: torch.Tensor) -> int:
    return _raw_stream_fn()(t.get_device())


# --------------------------------------------------------------------------
# K1: FAST score + NMS + Harris
# --------------------------------------------------------------------------

_HARRIS_K = 0.04


def _fast_harris_plain(img: torch.Tensor, threshold: float):
    """``nms_maxpool(fast_score(img, threshold))`` and the central-gradient
    Harris map, as the CPU reference runs them (fast.py:159-162,
    orb.py:465)."""
    score = _fast.nms_maxpool(_fast.fast_score(img, threshold, 9))
    hmap = harris_response(img.to(torch.float32), k=_HARRIS_K, block_size=5,
                           sigma=1.0, grad="central")
    return score, hmap


# levels one K1 launch takes (the kernel's parameter table)
FAST_HARRIS_MAX_LEVELS = 16


@functools.lru_cache(maxsize=None)
def _harris_window():
    """The five Gaussian window taps (block 5, sigma 1) as the kernel's
    ctypes argument, made once per process."""
    return (ctypes.c_float * 5)(*[float(v) for v in gaussian_kernel1d(5, 1.0)])


@functools.lru_cache(maxsize=64)
def _level_table(shapes: Tuple[Tuple[int, int], ...]):
    """The kernel's (hs, ws) ctypes arrays and the levels' element offsets
    in the flat outputs, made once per pyramid shape."""
    n = len(shapes)
    offs = np.cumsum([0] + [h * w for h, w in shapes]).tolist()
    return ((ctypes.c_int * n)(*[h for h, _ in shapes]),
            (ctypes.c_int * n)(*[w for _, w in shapes]), offs)


def fast_harris_levels(levels: Sequence[torch.Tensor], threshold: float
                       ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """FAST score + NMS and the Harris map of every (H, W) u8 level of a
    pyramid: a list of (score, Harris) pairs, each (H, W) f32. Any number
    of levels, all on one device, in ceil(n / FAST_HARRIS_MAX_LEVELS)
    kernel launches of consecutive levels (the kernel's level table holds
    16); the maps of one launch are contiguous views of one flat buffer
    (every level's score map, then every level's Harris map)."""
    levels = list(levels)
    if not levels:
        return []
    dev = levels[0].device
    if any(img.device != dev for img in levels):
        raise ValueError("fast_harris_levels: every level must be on one "
                         "device")
    for i, img in enumerate(levels):
        if img.dtype != torch.uint8 or img.ndim != 2:
            raise ValueError(f"fast_harris level {i}: expected a 2-D "
                             f"torch.uint8 tensor, got {img.ndim}-D "
                             f"{img.dtype}")
    return [m for i in range(0, len(levels), FAST_HARRIS_MAX_LEVELS)
            for m in _fast_harris_chunk(
                levels[i:i + FAST_HARRIS_MAX_LEVELS], threshold)]


def _fast_harris_chunk(levels: List[torch.Tensor], threshold: float
                       ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """At most FAST_HARRIS_MAX_LEVELS checked levels: their plain versions
    on the CPU, one kernel launch on the card."""
    if levels[0].is_cpu:
        return [_fast_harris_plain(img, threshold) for img in levels]
    for i, img in enumerate(levels):
        _check(img, f"fast_harris level {i}", torch.uint8, 2)
    shapes = tuple(tuple(img.shape) for img in levels)
    hs, ws, offs = _level_table(shapes)
    total = offs[-1]
    # one buffer: every level's score map, then every level's Harris map
    out = torch.empty(2 * total, dtype=torch.float32, device=levels[0].device)
    if total:
        n = len(levels)
        rc = _kernel("fast_harris")(
            n, (ctypes.c_void_p * n)(*[img.data_ptr() for img in levels]),
            hs, ws, out.data_ptr(), out.data_ptr() + 4 * total,
            float(threshold), _harris_window(), _HARRIS_K,
            _stream(levels[0]))
        _launched("fast_harris", rc)
    return [(out.as_strided((h, w), (w, 1), off),
             out.as_strided((h, w), (w, 1), total + off))
            for (h, w), off in zip(shapes, offs)]


def fast_harris(img: torch.Tensor, threshold: float
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(H, W) u8 → (NMS'd FAST-9 score, Harris map), both (H, W) f32: the
    one-level call of :func:`fast_harris_levels`."""
    return fast_harris_levels([img], threshold)[0]


def _fast_score_plain(img: torch.Tensor, threshold: float, nms: bool = True,
                      mask: torch.Tensor | None = None,
                      arc_length: int = 9) -> torch.Tensor:
    """``fast_score`` at ``arc_length``, times ``mask`` where given, then
    ``nms_maxpool`` where ``nms`` is set: the XLA composition of
    fast.py:158-162."""
    score = _fast.fast_score(img, threshold, arc_length)
    if mask is not None:
        score = score * mask
    return _fast.nms_maxpool(score) if nms else score


def fast_arc(arc_length: int) -> int:
    """The arc length K1 computes for ``arc_length`` (it is compiled for
    1..16): the same value, with n <= 1 taken as 1 and n >= 16 as 16, as
    the reference's log-step doubling reduces them (pallas_kernels.py:
    262-272: an arc of n <= 1 is the ring entry itself, an arc of n >= 16
    covers the whole ring)."""
    return min(max(operator.index(arc_length), 1), 16)


def fast_score(img: torch.Tensor, threshold: float, nms: bool = True,
               mask: torch.Tensor | None = None,
               arc_length: int = 9) -> torch.Tensor:
    """(H, W) u8 → (H, W) f32: the thresholded FAST-n score (n =
    ``arc_length``), 0 on the 3-px border, times the (H, W) f32 ROI
    ``mask`` where given, then 3×3 non-maximum suppression where ``nms``
    is set. K1 without its Harris phases, one launch; the plain version on
    a CPU tensor."""
    if img.is_cpu:
        return _fast_score_plain(img, threshold, nms, mask, arc_length)
    n = fast_arc(arc_length)
    _check(img, "fast_score image", torch.uint8, 2)
    if mask is not None:
        _check(mask, "fast_score mask", torch.float32, 2)
        if mask.shape != img.shape or mask.get_device() != img.get_device():
            raise ValueError(f"fast_score: mask {tuple(mask.shape)} on "
                             f"{mask.device} must be the image's "
                             f"{tuple(img.shape)} on {img.device}")
    h, w = img.shape
    out = torch.empty((h, w), dtype=torch.float32, device=img.device)
    if out.numel():
        rc = _kernel("fast_harris", "fast_score")(
            img.data_ptr(), h, w, 0 if mask is None else mask.data_ptr(),
            out.data_ptr(), float(threshold), int(bool(nms)), n,
            _stream(img))
        _launched("fast_score", rc)
    return out


# --------------------------------------------------------------------------
# K2: paired keypoint windows
# --------------------------------------------------------------------------

# The paired window layout, shared with features/orb.py: PAIR_WIN_H rows
# (rotated BRIEF taps reach at most ±19 rows from the keypoint), the
# keypoint on row PAIR_CY; each level is padded _WIN_CX columns left.
PAIR_CY = 20
PAIR_WIN_H = 40
_WIN_CX = 64


def prepare_window_canvas(frames: List[torch.Tensor],
                          win_h: int = PAIR_WIN_H, cy_off: int = PAIR_CY):
    """Edge-replicated, level-stacked float32 canvas for window extraction
    (the counterpart of pallas_kernels.py:383-398 and the level stacking of
    orb.py:315-322 / 367-374, without the TPU's alignment padding). Level i
    occupies rows [starts[i], starts[i+1]), padded ``cy_off`` rows above,
    ``win_h − cy_off`` below, 64 columns left and right, then zero-padded
    on the right to the widest level. The defaults are the paired layout
    (40 rows, keypoint on row 20); the unpaired one is (48, 24). Returns
    (canvas (Hc, Wc) f32, starts)."""
    pads = []
    for f in frames:
        h, w = f.shape
        dev = f.device
        iy = torch.clamp(torch.arange(-cy_off, h + win_h - cy_off,
                                      device=dev), 0, h - 1)
        ix = torch.clamp(torch.arange(-_WIN_CX, w + 128 - _WIN_CX,
                                      device=dev), 0, w - 1)
        pads.append(f.to(torch.float32).index_select(0, iy)
                    .index_select(1, ix))
    wmax = max(int(p.shape[1]) for p in pads)
    pads = [torch.nn.functional.pad(p, (0, wmax - int(p.shape[1])))
            for p in pads]
    starts = np.cumsum([0] + [int(p.shape[0]) for p in pads]).tolist()
    return torch.cat(pads, dim=0).contiguous(), starts


def _clip_pairs(xy: torch.Tensor, hsum: int, wimg: int) -> torch.Tensor:
    """pallas_kernels.py:473-475: clip to the canvas and pad an odd K with
    a (0, 0) keypoint."""
    hi = torch.tensor([wimg - 1, hsum - 1], device=xy.device, dtype=xy.dtype)
    xy = torch.minimum(torch.clamp(xy, min=0), hi)
    if xy.shape[0] % 2:
        xy = torch.cat([xy, torch.zeros_like(xy[:1])])
    return xy


def _windows_paired_plain(canvas: torch.Tensor, xy: torch.Tensor,
                          wimg: int) -> torch.Tensor:
    """The non-TPU branch (orb.py:382-386): one full (PAIR_WIN_H, 128)
    window per keypoint, then keypoint 2i's lanes [32, 96) beside keypoint
    2i+1's."""
    hc, wc = canvas.shape
    xy = _clip_pairs(xy.to(torch.int64), hc, wimg)
    dev = canvas.device
    rows = torch.clamp(xy[:, 1, None] + torch.arange(PAIR_WIN_H, device=dev),
                       max=hc - 1)
    cols = torch.clamp(xy[:, 0, None] + torch.arange(128, device=dev),
                       max=wc - 1)
    full = canvas[rows[:, :, None], cols[:, None, :]]   # (K, PAIR_WIN_H, 128)
    a = full[0::2, :, 32:96]
    b = full[1::2, :, 32:96]
    return torch.cat([a, b], dim=2)


def windows_paired(canvas: torch.Tensor, xy: torch.Tensor,
                   wimg: int) -> torch.Tensor:
    """(ceil(K/2), PAIR_WIN_H, 128) f32 paired windows of (K, 2) int32
    canvas keypoints (x, y) from a :func:`prepare_window_canvas` canvas."""
    if canvas.device.type == "cpu":
        return _windows_paired_plain(canvas, xy, wimg)
    _check(canvas, "windows_paired canvas", torch.float32, 2)
    _check(xy, "windows_paired xy", torch.int32, 2)
    if xy.shape[1] != 2 or xy.device != canvas.device:
        raise ValueError("windows_paired: xy must be (K, 2) on the canvas' "
                         "device")
    k = int(xy.shape[0])
    hc, wc = canvas.shape
    out = torch.empty(((k + 1) // 2, PAIR_WIN_H, 128), dtype=torch.float32,
                      device=canvas.device)
    if k == 0:
        return out
    rc = _kernel("windows_paired")(
        canvas.data_ptr(), xy.data_ptr(), out.data_ptr(), k, hc, wc, hc,
        int(wimg), PAIR_WIN_H, _stream(canvas))
    _launched("windows_paired", rc)
    return out


# --------------------------------------------------------------------------
# K3: BRIEF tap sampling
# --------------------------------------------------------------------------


def _brief_sample_plain(windows: torch.Tensor, rows: torch.Tensor,
                        cols: torch.Tensor) -> torch.Tensor:
    """take_along_axis on the flattened windows (orb.py:422-423)."""
    k, wh, ww = windows.shape
    r = torch.clamp(rows.to(torch.int64), 0, wh - 1)
    c = torch.clamp(cols.to(torch.int64), 0, ww - 1)
    base = (torch.arange(k, device=windows.device) * (wh * ww))[:, None]
    return windows.reshape(-1)[base + r * ww + c]


def brief_sample(windows: torch.Tensor, rows: torch.Tensor,
                 cols: torch.Tensor) -> torch.Tensor:
    """(K, wh, ww) f32 windows, (K, T) int32 rows/cols → (K, T) f32."""
    if windows.device.type == "cpu":
        return _brief_sample_plain(windows, rows, cols)
    _check(windows, "brief_sample windows", torch.float32, 3)
    _check(rows, "brief_sample rows", torch.int32, 2)
    _check(cols, "brief_sample cols", torch.int32, 2)
    k, wh, ww = windows.shape
    if (rows.shape != cols.shape or rows.shape[0] != k
            or rows.device != windows.device
            or cols.device != windows.device):
        raise ValueError("brief_sample: rows/cols must be (K, T) on the "
                         "windows' device")
    taps = int(rows.shape[1])
    out = torch.empty((k, taps), dtype=torch.float32, device=windows.device)
    if k == 0 or taps == 0:
        return out
    rc = _kernel("brief_sample")(
        windows.data_ptr(), rows.data_ptr(), cols.data_ptr(), out.data_ptr(),
        k, wh, ww, taps, _stream(windows))
    _launched("brief_sample", rc)
    return out


BRIEF_LAYOUTS = {"unpaired": 0, "paired": 1}
_UNPAIRED_WIN_H = 48
_UNPAIRED_CY = 24


def _brief_rotated_shape(windows, cos, sin, pattern, layout, out):
    """Checks shared by the kernel and plain routes of
    :func:`brief_rotated`; returns the keypoint count K."""
    if layout not in BRIEF_LAYOUTS:
        raise ValueError(f"brief_rotated: unknown layout {layout!r}")
    if out not in ("bits", "samples"):
        raise ValueError(f"brief_rotated: unknown output {out!r}")
    paired = layout == "paired"
    wh = PAIR_WIN_H if paired else _UNPAIRED_WIN_H
    if windows.ndim != 3 or tuple(windows.shape[1:]) != (wh, 128):
        raise ValueError(f"brief_rotated: {layout} windows must be "
                         f"(Kw, {wh}, 128), got {tuple(windows.shape)}")
    k = int(cos.shape[0])
    if cos.ndim != 1 or sin.shape != cos.shape:
        raise ValueError("brief_rotated: cos and sin must be (K,)")
    if k != int(windows.shape[0]) * (2 if paired else 1):
        raise ValueError(f"brief_rotated: {k} keypoints do not fill "
                         f"{int(windows.shape[0])} {layout} windows")
    if tuple(pattern.shape) != (256, 4):
        raise ValueError("brief_rotated: pattern must be (256, 4)")
    return k


def _brief_rotated_plain(windows: torch.Tensor, cos: torch.Tensor,
                         sin: torch.Tensor, pattern: torch.Tensor,
                         layout: str, out: str = "bits") -> torch.Tensor:
    """The kernel's contract in PyTorch ops: the tap arithmetic of
    features/orb.py::_brief_tap_coords (every product, difference and sum
    a separately rounded f32 op, round half to even, the layout's clamps),
    the gather of :func:`_brief_sample_plain`, and ``A < B``."""
    k = _brief_rotated_shape(windows, cos, sin, pattern, layout, out)
    pat = pattern.to(torch.float32)
    px = torch.cat([pat[:, 0], pat[:, 2]])
    py = torch.cat([pat[:, 1], pat[:, 3]])
    ca, sa = cos[:, None], sin[:, None]
    dx = torch.round(px[None, :] * ca - py[None, :] * sa).to(torch.int32)
    dy = torch.round(px[None, :] * sa + py[None, :] * ca).to(torch.int32)
    if layout == "paired":
        lane = torch.tensor([0, 64], dtype=torch.int32, device=cos.device)
        cols = (torch.clamp(32 + dx, 0, 63).reshape(k // 2, 2, 512)
                + lane[None, :, None]).reshape(k // 2, 1024)
        rows = torch.clamp(PAIR_CY + dy, 0, PAIR_WIN_H - 1).reshape(
            k // 2, 1024)
    else:
        cols = torch.clamp(_WIN_CX + dx, 0, 127)
        rows = torch.clamp(_UNPAIRED_CY + dy, 0, _UNPAIRED_WIN_H - 1)
    s = _brief_sample_plain(windows, rows, cols).reshape(k, 512)
    if out == "samples":
        return s
    return (s[:, :256] < s[:, 256:]).to(torch.uint8)


def brief_rotated(windows: torch.Tensor, cos: torch.Tensor,
                  sin: torch.Tensor, pattern: torch.Tensor, layout: str,
                  out: str = "bits") -> torch.Tensor:
    """Rotated BRIEF-256 straight from the blurred windows.

    ``windows``: (K/2, 40, 128) f32 for ``layout="paired"`` (keypoints 2i
    and 2i+1 share window i, centred at (20, 32) and (20, 96), each clamped
    to its 64 lanes) or (K, 48, 128) for ``"unpaired"`` (centre (24, 64));
    ``cos``/``sin``: (K,) f32 of the keypoint angles; ``pattern``: (256, 4)
    int32 (x1, y1, x2, y2) on the windows' device; both must start on a
    16-byte boundary, as every tensor that is not a slice does. Tap t of
    keypoint k sits
    at ``round(px·cos − py·sin)``, ``round(px·sin + py·cos)`` from its
    centre. ``out="bits"``: (K, 256) u8 ``A < B``; ``out="samples"``:
    (K, 512) f32 ``[A(256), B(256)]``, as :func:`brief_sample` gives them."""
    if windows.device.type == "cpu":
        return _brief_rotated_plain(windows, cos, sin, pattern, layout, out)
    _check(windows, "brief_rotated windows", torch.float32, 3)
    _check(cos, "brief_rotated cos", torch.float32, 1)
    _check(sin, "brief_rotated sin", torch.float32, 1)
    _check(pattern, "brief_rotated pattern", torch.int32, 2)
    k = _brief_rotated_shape(windows, cos, sin, pattern, layout, out)
    if not (cos.device == sin.device == pattern.device == windows.device):
        raise ValueError("brief_rotated: every input must be on the "
                         "windows' device")
    if windows.data_ptr() % 16 or pattern.data_ptr() % 16:
        raise ValueError("brief_rotated: windows and pattern must start on "
                         "a 16-byte boundary (the kernel copies them in "
                         "16-byte pieces)")
    samples = out == "samples"
    res = torch.empty((k, 512) if samples else (k, 256),
                      dtype=torch.float32 if samples else torch.uint8,
                      device=windows.device)
    if k == 0:
        return res
    rc = _kernel("brief_sample", "brief_rotated")(
        windows.data_ptr(), cos.data_ptr(), sin.data_ptr(),
        pattern.data_ptr(), res.data_ptr(), k, BRIEF_LAYOUTS[layout],
        int(samples), _stream(windows))
    _launched("brief_rotated", rc)
    return res


# --------------------------------------------------------------------------
# K4: one (win_h, 128) window per keypoint
# --------------------------------------------------------------------------


def _window_frame(src: torch.Tensor, win_h: int, cy_off: int, cx_off: int,
                  prepared):
    """(oy, ox, xmax, ymax) of the two call shapes of :func:`windows`."""
    if prepared is None:
        h, w = src.shape
        return cy_off, cx_off, w - 1, h - 1
    hsum, wimg = prepared
    return 0, 0, int(wimg) - 1, int(hsum) - 1


def _windows_plain(src: torch.Tensor, xy: torch.Tensor, win_h: int = 48,
                   cy_off: int = 24, cx_off: int = 64,
                   prepared=None) -> torch.Tensor:
    """The vmapped ``dynamic_slice`` branches (orb.py:155-162, 330-347;
    optical_flow.py:169-175, 306-323) as one advanced-indexing gather with
    clamped indices."""
    oy, ox, xmax, ymax = _window_frame(src, win_h, cy_off, cx_off, prepared)
    hs, ws = src.shape
    dev = src.device
    xy = xy.to(torch.int64)
    cx = torch.clamp(xy[:, 0], 0, xmax)
    cy = torch.clamp(xy[:, 1], 0, ymax)
    rows = torch.clamp(cy[:, None] + torch.arange(win_h, device=dev) - oy,
                       0, hs - 1)
    cols = torch.clamp(cx[:, None] + torch.arange(128, device=dev) - ox,
                       0, ws - 1)
    return src[rows[:, :, None], cols[:, None, :]]


def windows(src: torch.Tensor, xy: torch.Tensor, win_h: int = 48,
            cy_off: int = 24, cx_off: int = 64,
            prepared: Tuple[int, int] | None = None) -> torch.Tensor:
    """(K, win_h, 128) f32 edge-replicated windows at (K, 2) int32
    keypoints (x, y).

    Single frame (``prepared=None``): ``src`` is the (H, W) f32 frame and
    ``out[k, r, c] = src[clamp(y + r − cy_off), clamp(x + c − cx_off)]``
    with xy first clipped to the frame. Stacked levels: ``src`` is the
    canvas of ``prepare_window_canvas(frames, win_h, cy_off)``, xy are
    canvas coordinates and ``prepared = (canvas rows, widest level)``."""
    if src.device.type == "cpu":
        return _windows_plain(src, xy, win_h, cy_off, cx_off, prepared)
    _check(src, "windows src", torch.float32, 2)
    _check(xy, "windows xy", torch.int32, 2)
    if xy.shape[1] != 2 or xy.device != src.device:
        raise ValueError("windows: xy must be (K, 2) on the source's device")
    oy, ox, xmax, ymax = _window_frame(src, win_h, cy_off, cx_off, prepared)
    k = int(xy.shape[0])
    hs, ws = src.shape
    out = torch.empty((k, int(win_h), 128), dtype=torch.float32,
                      device=src.device)
    if out.numel() == 0:
        return out
    if hs == 0 or ws == 0:
        raise ValueError("windows: empty source")
    rc = _kernel("windows")(src.data_ptr(), xy.data_ptr(), out.data_ptr(), k,
                            hs, ws, xmax, ymax, oy, ox, int(win_h),
                            _stream(src))
    _launched("windows", rc)
    return out


# --------------------------------------------------------------------------
# K5: lane gather
# --------------------------------------------------------------------------


def _lane_gather_group(src: torch.Tensor, idx: torch.Tensor) -> int:
    """Checks shared by the kernel and plain routes of :func:`lane_gather`;
    returns g, the source rows each index row serves."""
    if src.ndim != 2 or src.shape[1] != 128:
        raise ValueError(f"lane_gather needs 128 lanes, got "
                         f"{tuple(src.shape)}")
    if idx.ndim != 2 or idx.shape[1] != 128:
        raise ValueError(f"lane_gather: idx must be (rows, 128), got "
                         f"{tuple(idx.shape)}")
    n, rows = int(src.shape[0]), int(idx.shape[0])
    if rows == n:
        return 1
    if rows == 0 or n % rows:
        raise ValueError(f"lane_gather: idx's {rows} rows do not divide the "
                         f"source's {n}")
    return n // rows


def _lane_gather_plain(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    g = _lane_gather_group(src, idx)
    return torch.gather(src, 1, torch.clamp(idx.to(torch.int64), 0,
                                            127).repeat_interleave(g, 0))


def lane_gather(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """out[i, j] = src[i, clip(idx[i // g, j], 0, 127)] for (N, 128) f32
    ``src`` and (N / g, 128) int32 ``idx``: g = 1 is the TPU kernel's
    contract; with fewer index rows each serves g consecutive source rows
    (the broadcast-index mode, which spares the caller an expanded copy)."""
    if src.is_cpu:
        return _lane_gather_plain(src, idx)
    g = _lane_gather_group(src, idx)
    _check(src, "lane_gather src", torch.float32, 2)
    _check(idx, "lane_gather idx", torch.int32, 2)
    if idx.get_device() != src.get_device():
        raise ValueError("lane_gather: idx must be on the source's device")
    out = torch.empty_like(src)
    n = src.shape[0]
    if n == 0:
        return out
    rc = _kernel("lane_gather")(src.data_ptr(), idx.data_ptr(),
                                out.data_ptr(), n, g, _stream(src))
    _launched("lane_gather", rc)
    return out


# --------------------------------------------------------------------------
# K6: fused resize + normalise + CHW
# --------------------------------------------------------------------------


@functools.lru_cache(maxsize=256)
def _resize_taps(in_size: int, out_size: int):
    """The non-zero entries of the rows of ``_resize_matrix``: ((out, 2)
    int32 indices, (out, 2) f32 weights), ascending index; a row with one
    entry (an integer position, or edge taps merged by the clamp) repeats
    its index with weight 0."""
    m = _resize_matrix(in_size, out_size)
    idx = np.zeros((out_size, 2), np.int32)
    wt = np.zeros((out_size, 2), np.float32)
    for i, row in enumerate(m):
        nz = np.nonzero(row)[0]
        if not 1 <= len(nz) <= 2:
            raise AssertionError("a bilinear row has one or two taps")
        idx[i] = nz[0], nz[-1]
        wt[i, 0] = row[nz[0]]
        wt[i, 1] = row[nz[-1]] if len(nz) == 2 else 0.0
    return idx, wt


def _norm_scale_bias(mean, std):
    """float32 (scale, bias) with ``scale = 1/(255·std)``, ``bias =
    −mean/std`` computed in Python floats first, as
    pallas_kernels.py:88-91."""
    scale = np.asarray([1.0 / (255.0 * s) for s in std], np.float32)
    bias = np.asarray([-m / s for m, s in zip(mean, std)], np.float32)
    if scale.shape != (3,) or bias.shape != (3,):
        raise ValueError("fused_preprocess: mean and std need 3 values")
    return scale, bias


def _fused_preprocess_plain(rgb_u8: torch.Tensor, out_h: int, out_w: int,
                            mean=(0.0, 0.0, 0.0), std=(1.0, 1.0, 1.0)
                            ) -> torch.Tensor:
    """The TPU kernel's body in PyTorch: two dense f32 band-matrix
    products (horizontal, then vertical), then ``· scale + bias``."""
    h, w, _ = rgb_u8.shape
    dev = rgb_u8.device
    scale, bias = _norm_scale_bias(mean, std)
    wy = torch.from_numpy(_resize_matrix(h, out_h)).to(dev)
    wx_t = torch.from_numpy(_resize_matrix(w, out_w)).to(dev).T
    src = rgb_u8.permute(2, 0, 1).to(torch.float32)          # (3, H, W)
    t = torch.matmul(src, wx_t)                              # (3, H, ow)
    out = torch.matmul(wy, t)                                # (3, oh, ow)
    return (out * torch.from_numpy(scale).to(dev)[:, None, None]
            + torch.from_numpy(bias).to(dev)[:, None, None])


def _fused_preprocess_taps(rgb_u8: torch.Tensor, out_h: int, out_w: int,
                           mean=(0.0, 0.0, 0.0), std=(1.0, 1.0, 1.0)
                           ) -> torch.Tensor:
    """The kernel's own arithmetic in PyTorch ops, each product and sum a
    separately rounded f32 op: the two-tap form of both passes. The kernel
    is bit-equal to this; :func:`_fused_preprocess_plain` differs from it
    by the rounding of its products' summation only."""
    h, w, _ = rgb_u8.shape
    dev = rgb_u8.device
    scale, bias = _norm_scale_bias(mean, std)
    yi, yw = (torch.from_numpy(a).to(dev) for a in _resize_taps(h, out_h))
    xi, xw = (torch.from_numpy(a).to(dev) for a in _resize_taps(w, out_w))
    src = rgb_u8.permute(2, 0, 1).to(torch.float32)
    xi, yi = xi.to(torch.int64), yi.to(torch.int64)
    t = (src[:, :, xi[:, 0]] * xw[:, 0] + src[:, :, xi[:, 1]] * xw[:, 1])
    out = (t[:, yi[:, 0], :] * yw[:, 0, None]
           + t[:, yi[:, 1], :] * yw[:, 1, None])
    return (out * torch.from_numpy(scale).to(dev)[:, None, None]
            + torch.from_numpy(bias).to(dev)[:, None, None])


@functools.lru_cache(maxsize=64)
def _device_taps(in_size: int, out_size: int, device: str):
    idx, wt = _resize_taps(in_size, out_size)
    return (torch.from_numpy(idx).to(device).contiguous(),
            torch.from_numpy(wt).to(device).contiguous())


def fused_preprocess(rgb_u8: torch.Tensor, out_h: int, out_w: int,
                     mean=(0.0, 0.0, 0.0), std=(1.0, 1.0, 1.0)
                     ) -> torch.Tensor:
    """(H, W, 3) u8 → (3, out_h, out_w) f32: bilinear resize (cv2
    half-pixel centres, edges replicated), ``(x/255 − mean)/std`` per
    channel and the CHW transpose in one kernel."""
    out_h, out_w = int(out_h), int(out_w)
    if rgb_u8.ndim != 3 or rgb_u8.shape[2] != 3:
        raise ValueError("fused_preprocess: expected an (H, W, 3) image")
    if rgb_u8.device.type == "cpu":
        return _fused_preprocess_plain(rgb_u8, out_h, out_w, mean, std)
    _check(rgb_u8, "fused_preprocess rgb", torch.uint8, 3)
    h, w, _ = rgb_u8.shape
    if h == 0 or w == 0:
        raise ValueError("fused_preprocess: empty image")
    scale, bias = _norm_scale_bias(mean, std)
    dev = rgb_u8.device
    out = torch.empty((3, out_h, out_w), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    yi, yw = _device_taps(h, out_h, str(dev))
    xi, xw = _device_taps(w, out_w, str(dev))
    f3 = ctypes.c_float * 3
    rc = _kernel("preprocess")(
        rgb_u8.data_ptr(), w, yi.data_ptr(), yw.data_ptr(), xi.data_ptr(),
        xw.data_ptr(), f3(*scale.tolist()), f3(*bias.tolist()),
        out.data_ptr(), out_h, out_w, _stream(rgb_u8))
    _launched("preprocess", rc)
    return out


# --------------------------------------------------------------------------
# K7: exact bilinear / nearest remap (data maps, affine, perspective)
# --------------------------------------------------------------------------

REMAP_FORMS = {"data": 0, "affine": 1, "persp": 2}
_DEN_EPS = 1e-8


def _f32(v: float, device) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32, device=device)


def _source_coords(form: str, out_hw: Tuple[int, int], coefs, map_x, map_y,
                   device):
    """(sx, sy), each (Ho, Wo) f32: the data maps, or the affine /
    perspective map of the destination pixel grid evaluated as the kernel
    does (warp_pallas.py:224-230)."""
    if form == "data":
        return map_x.to(torch.float32), map_y.to(torch.float32)
    ho, wo = out_hw
    k = coefs.to(device=device, dtype=torch.float32)
    gy, gx = torch.meshgrid(torch.arange(ho, dtype=torch.float32,
                                         device=device),
                            torch.arange(wo, dtype=torch.float32,
                                         device=device), indexing="ij")
    sx = k[0] * gx + k[1] * gy + k[2]
    sy = k[3] * gx + k[4] * gy + k[5]
    if form == "persp":
        den = k[6] * gx + k[7] * gy + k[8]
        eps = _f32(_DEN_EPS, device)
        den = torch.where(den.abs() < eps, eps, den)
        sx = sx / den
        sy = sy / den
    return sx, sy


def _remap_plain(img: torch.Tensor, out_hw: Tuple[int, int], form: str,
                 coefs=None, map_x=None, map_y=None, nearest: bool = False,
                 border: bool = False, fill: float = 0.0) -> torch.Tensor:
    """The kernel's contract in PyTorch ops, each a separately rounded f32
    op in the kernel's order (see csrc/remap.cu): (H, W, C) u8/f32 →
    (Ho, Wo, C) of the same dtype."""
    dev = img.device
    h, w, c = img.shape
    ho, wo = out_hw
    sx, sy = _source_coords(form, out_hw, coefs, map_x, map_y, dev)
    if border:
        sx = torch.clamp(sx, 0.0, float(w - 1))
        sy = torch.clamp(sy, 0.0, float(h - 1))
    if nearest:
        sx = torch.floor(sx + 0.5)
        sy = torch.floor(sy + 0.5)
    sx = torch.clamp(sx, -1.5, w + 0.5)
    sy = torch.clamp(sy, -1.5, h + 0.5)
    x0 = torch.floor(sx)
    y0 = torch.floor(sy)
    fx = sx - x0
    fy = sy - y0
    gx0 = 1.0 - fx
    gy0 = 1.0 - fy
    weights = {(0, 0): gx0 * gy0, (0, 1): fx * gy0, (1, 0): gx0 * fy,
               (1, 1): fx * fy}
    ix = x0.to(torch.int64)
    iy = y0.to(torch.int64)
    flat = img.reshape(h * w, c).to(torch.float32)
    fill_t = _f32(fill, dev)
    acc = None
    for (dy, dx), wt in weights.items():
        jy, jx = iy + dy, ix + dx
        inb = (jx >= 0) & (jx <= w - 1) & (jy >= 0) & (jy <= h - 1)
        idx = torch.clamp(jy, 0, h - 1) * w + torch.clamp(jx, 0, w - 1)
        v = flat[idx.reshape(-1)].reshape(ho, wo, c)
        term = torch.where(inb[..., None], v, fill_t) * wt[..., None]
        acc = term if acc is None else acc + term
    if img.dtype == torch.uint8:
        return torch.clamp(torch.round(acc), 0, 255).to(torch.uint8)
    return acc


def remap(img: torch.Tensor, out_hw: Tuple[int, int], form: str,
          coefs: torch.Tensor | None = None,
          map_x: torch.Tensor | None = None,
          map_y: torch.Tensor | None = None, nearest: bool = False,
          border: bool = False, fill: float = 0.0) -> torch.Tensor:
    """Sample (H, W, C) u8 or f32 ``img`` into (Ho, Wo, C) of its dtype.

    ``form`` is "data" (``map_x``/``map_y``: (Ho, Wo) f32 on the image's
    device) or "affine"/"persp" (``coefs``: the 9 f32 values of the
    destination → source map ``[c1x c2x c0x c1y c2y c0y p1 p2 p0]``, as a
    sequence, a numpy array or a tensor). Coefficients on the image's CUDA
    device stay there: the kernel reads them from device memory and the
    call does not wait for the device. Any others go by value."""
    if form not in REMAP_FORMS:
        raise ValueError(f"remap: unknown map form {form!r}")
    ho, wo = (int(v) for v in out_hw)
    if form != "data":
        coefs = torch.as_tensor(coefs, dtype=torch.float32).reshape(9)
        if coefs.device != img.device:
            coefs = coefs.cpu()
    if img.device.type == "cpu":
        return _remap_plain(img, (ho, wo), form, coefs, map_x, map_y,
                            nearest, border, fill)
    if img.dtype not in (torch.uint8, torch.float32):
        raise ValueError(f"remap img: expected uint8 or float32, got "
                         f"{img.dtype}")
    _check(img, "remap img", img.dtype, 3)
    h, w, c = img.shape
    ptrs = [None, None]
    if form == "data":
        for i, (t, nm) in enumerate(((map_x, "map_x"), (map_y, "map_y"))):
            _check(t, f"remap {nm}", torch.float32, 2)
            if tuple(t.shape) != (ho, wo) or t.device != img.device:
                raise ValueError(f"remap {nm}: expected ({ho}, {wo}) on "
                                 f"{img.device}")
            ptrs[i] = t.data_ptr()
    cvals, cdev = [0.0] * 9, None
    if form != "data":
        if coefs.device.type == "cuda":
            cdev = coefs.data_ptr()
        else:
            cvals = coefs.tolist()
    out = torch.empty((ho, wo, c), dtype=img.dtype, device=img.device)
    if out.numel() == 0:
        return out
    rc = _kernel("remap")(
        img.data_ptr(), int(img.dtype == torch.uint8), h, w, c,
        out.data_ptr(), ho, wo, REMAP_FORMS[form], ptrs[0], ptrs[1],
        (ctypes.c_float * 9)(*cvals), cdev, int(bool(nearest)),
        int(bool(border)), float(fill), _stream(img))
    _launched("remap", rc)
    return out


# --------------------------------------------------------------------------
# K8: integer row shift (the TPU pre-shear)
# --------------------------------------------------------------------------


def _lane_shift_plain(src: torch.Tensor, shifts: torch.Tensor,
                      out_w: int) -> torch.Tensor:
    """out[..., r, j] = src[..., r, j - shifts[r]], zero outside."""
    cc = src.shape[-1]
    j = torch.arange(out_w, device=src.device)
    k = j[None, :] - shifts.to(torch.int64)[:, None]        # (rr, out_w)
    ok = (k >= 0) & (k < cc)
    idx = torch.clamp(k, 0, max(cc - 1, 0)).expand(
        src.shape[:-1] + (out_w,))
    v = torch.gather(src, -1, idx)
    return torch.where(ok, v, _f32(0.0, src.device))


def lane_shift(src: torch.Tensor, shifts: torch.Tensor,
               out_w: int) -> torch.Tensor:
    """(rr, cc) or (B, rr, cc) f32, (rr,) int32 shifts → (..., rr, out_w):
    ``out[..., r, j] = src[..., r, j - shifts[r]]``, zero outside."""
    if src.is_cpu:
        return _lane_shift_plain(src, shifts, out_w)
    nd = src.ndim
    if nd not in (2, 3):
        raise ValueError("lane_shift src: expected (rr, cc) or (B, rr, cc)")
    _check(src, "lane_shift src", torch.float32, nd)
    _check(shifts, "lane_shift shifts", torch.int32, 1)
    shape = src.shape
    rr, cc = shape[-2], shape[-1]
    if shifts.shape[0] != rr or shifts.get_device() != src.get_device():
        raise ValueError("lane_shift: shifts must be (rr,) on the source's "
                         "device")
    b = shape[0] if nd == 3 else 1
    out_w = int(out_w)
    out = torch.empty(shape[:-1] + (out_w,), dtype=torch.float32,
                      device=src.device)
    if out.numel() == 0:
        return out
    rc = _kernel("lane_shift")(src.data_ptr(), shifts.data_ptr(),
                               out.data_ptr(), b, rr, cc, out_w,
                               _stream(src))
    _launched("lane_shift", rc)
    return out


# --------------------------------------------------------------------------
# K9: fractional row and column shears
# --------------------------------------------------------------------------


def shear_slack(c: int) -> int:
    """Largest |integer shift| a shear row may have (warp_shear.py:63)."""
    return c // 4 + 192


def _shear_x_plain(img: torch.Tensor, shifts: torch.Tensor) -> torch.Tensor:
    """out[..., y, x] = img[..., y, x + shifts[y]], linear in x, zero off
    the canvas and on rows whose integer shift leaves ±slack."""
    c = img.shape[-1]
    slack = shear_slack(c)
    zero = _f32(0.0, img.device)
    i0 = torch.floor(shifts)
    f = shifts - i0
    valid = (i0 > -slack) & (i0 < slack - 1)
    p = i0.to(torch.int64)[:, None] + torch.arange(c, device=img.device)

    def tap(q):
        ok = (q >= 0) & (q < c)
        v = torch.gather(img, -1, torch.clamp(q, 0, c - 1).expand(img.shape))
        return torch.where(ok, v, zero)

    out = tap(p) * (1.0 - f)[:, None] + tap(p + 1) * f[:, None]
    return torch.where(valid[:, None], out, zero)


def _shear_launch(entry: str, img: torch.Tensor,
                  shifts: torch.Tensor) -> torch.Tensor:
    """Checks and launch of one of the two modes of shear_x.cu."""
    if img.ndim not in (2, 3) or img.shape[-1] != img.shape[-2]:
        raise ValueError(f"{entry} img: expected (c, c) or (B, c, c)")
    _check(img, f"{entry} img", torch.float32, img.ndim)
    _check(shifts, f"{entry} shifts", torch.float32, 1)
    c = img.shape[-1]
    if shifts.shape[0] != c or shifts.device != img.device:
        raise ValueError(f"{entry}: shifts must be (c,) on the canvas' "
                         "device")
    b = img.shape[0] if img.ndim == 3 else 1
    if max(b, c) > 65535:
        raise ValueError(f"{entry}: the batch and the canvas side must be "
                         "at most 65535")
    out = torch.empty_like(img)
    if out.numel() == 0:
        return out
    rc = _kernel("shear_x", entry)(img.data_ptr(), shifts.data_ptr(),
                                   out.data_ptr(), b, c, shear_slack(c),
                                   _stream(img))
    _launched(entry, rc)
    return out


def shear_x(img: torch.Tensor, shifts: torch.Tensor) -> torch.Tensor:
    """(c, c) or (B, c, c) f32 canvas, (c,) f32 shifts (one per row) →
    same shape."""
    if img.device.type == "cpu":
        return _shear_x_plain(img, shifts)
    return _shear_launch("shear_x", img, shifts)


def _shear_y_plain(img: torch.Tensor, shifts: torch.Tensor) -> torch.Tensor:
    """out[..., y, x] = img[..., y + shifts[x], x]: the row shear of the
    transpose, transposed back (contiguous, as the kernel's output)."""
    return _shear_x_plain(img.transpose(-1, -2).contiguous(),
                          shifts).transpose(-1, -2).contiguous()


def shear_y(img: torch.Tensor, shifts: torch.Tensor) -> torch.Tensor:
    """Column mode of :func:`shear_x`: (c, c) or (B, c, c) f32 canvas, (c,)
    f32 shifts (one per column) → same shape, read and written in the
    canvas' own layout."""
    if img.device.type == "cpu":
        return _shear_y_plain(img, shifts)
    return _shear_launch("shear_y", img, shifts)
