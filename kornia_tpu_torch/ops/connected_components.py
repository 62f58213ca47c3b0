"""Connected-component labelling: dense scan propagation on the card and
union-find on the host (port of kornia_tpu/ops/connected_components.py).

* :func:`connected_components` — labels propagate by alternating
  segmented min-scans along rows and columns, as the reference's
  ``lax.while_loop`` of associative scans does; here each scan is one
  ``torch.cummin`` over an int64 key that keeps segments apart. The loop
  reads one flag back a sweep.
* :func:`connected_components_host` and :func:`label_classes_host` — the
  native C++ union-find (``native/ccl.cpp``). The numpy routes
  (:func:`_ccl_numpy`, :func:`_label_classes_numpy`) are separate
  functions: a failed native build raises instead of falling back.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch

from kornia_tpu_torch import entry
from kornia_tpu_torch.native import load_native_library

_BIG = 2 ** 30
_SEG = 2 ** 32   # segment offset of the scan key: above every label


def _scan_offsets(starts: torch.Tensor, dim: int,
                  reverse: bool) -> torch.Tensor:
    """The segment offsets of :func:`_segmented_min_scan` for ``starts``
    (in the flipped order when ``reverse``): ``segment · 2³²``, where a
    segment begins at each set flag."""
    if reverse:
        starts = starts.flip(dim)
    return torch.cumsum(starts, dim, dtype=torch.int64) * _SEG


def _segmented_min_scan(values: torch.Tensor, seg: torch.Tensor, dim: int,
                        reverse: bool) -> torch.Tensor:
    """Min-scan of int64 ``values`` along ``dim``, restarting at each
    segment of ``seg`` (:func:`_scan_offsets`; from the end when
    ``reverse``).

    Exact for values in [0, 2³²): the key ``value − segment·2³²`` makes
    every earlier segment's key larger than any of the current one's, so
    a plain cumulative minimum stops at the segment's start."""
    if reverse:
        values = values.flip(dim)
    out = torch.cummin(values - seg, dim).values + seg
    return out.flip(dim) if reverse else out


def _sweep_parts(fg: torch.Tensor):
    """Segment offsets of the row and column scans: every background pixel
    starts (ends) a segment of its own, and so does each run's first
    (last) foreground pixel."""
    false_col = torch.zeros_like(fg[:, :1])
    false_row = torch.zeros_like(fg[:1, :])
    row_start = fg & ~torch.cat([false_col, fg[:, :-1]], 1)
    row_end = fg & ~torch.cat([fg[:, 1:], false_col], 1)
    col_start = fg & ~torch.cat([false_row, fg[:-1, :]], 0)
    col_end = fg & ~torch.cat([fg[1:, :], false_row], 0)
    return (_scan_offsets(~fg | row_start, 1, False),
            _scan_offsets(~fg | row_end, 1, True),
            _scan_offsets(~fg | col_start, 0, False),
            _scan_offsets(~fg | col_end, 0, True))


def _labels_sweeps(mask: torch.Tensor, connectivity: int = 4,
                   max_sweeps: int = 64) -> Tuple[torch.Tensor, int]:
    """:func:`connected_components` on ``mask``'s device, and the number
    of sweeps it ran (one before the loop, then up to ``max_sweeps``
    while a sweep changes something)."""
    if mask.ndim != 2:
        raise ValueError(f"mask must be (H, W), got {tuple(mask.shape)}")
    if connectivity not in (4, 8):
        raise ValueError("connectivity must be 4 or 8")
    h, w = mask.shape
    fg = mask != 0
    idx = torch.arange(h * w, dtype=torch.int64,
                       device=mask.device).reshape(h, w)
    big = torch.full_like(idx, _BIG)
    labels = torch.where(fg, idx, big)
    seg_rs, seg_re, seg_cs, seg_ce = _sweep_parts(fg)

    def diag_pass(lab):
        """8-connectivity: the min over the 4 diagonal neighbours."""
        p = torch.nn.functional.pad(lab, (1, 1, 1, 1), value=_BIG)
        dn = torch.minimum(torch.minimum(p[:-2, :-2], p[:-2, 2:]),
                           torch.minimum(p[2:, :-2], p[2:, 2:]))
        return torch.where(fg, torch.minimum(lab, dn), big)

    def sweep(lab):
        lab = _segmented_min_scan(lab, seg_rs, 1, False)
        lab = _segmented_min_scan(lab, seg_re, 1, True)
        if connectivity == 8:
            lab = diag_pass(lab)
        lab = _segmented_min_scan(lab, seg_cs, 0, False)
        lab = _segmented_min_scan(lab, seg_ce, 0, True)
        if connectivity == 8:
            lab = diag_pass(lab)
        return lab

    labels = sweep(labels)
    sweeps = 1
    for _ in range(max_sweeps):
        new = sweep(labels)
        sweeps += 1
        changed = bool(torch.any(new != labels))   # the sweep's host read
        labels = new
        if not changed:
            break
    neg = torch.full_like(labels, -1)
    return torch.where(fg, labels, neg).to(torch.int32), sweeps


@entry
def connected_components(mask: torch.Tensor, connectivity: int = 4,
                         max_sweeps: int = 64) -> torch.Tensor:
    """Label the nonzero pixels of an (H, W) mask; background = -1.

    Returns int32 labels where connected pixels share the smallest linear
    index of their component. A mask that has not converged after
    ``1 + max_sweeps`` sweeps returns the labels of that sweep, as the
    reference's loop does."""
    return _labels_sweeps(mask, connectivity, max_sweeps)[0]


def relabel_sequential(labels) -> np.ndarray:
    """Compact sparse labels (host) to 0 = background, 1..K components."""
    if isinstance(labels, torch.Tensor):
        labels = labels.cpu().numpy()
    labels = np.asarray(labels)
    out = np.zeros_like(labels, dtype=np.int32)
    fg = labels >= 0
    _, inverse = np.unique(labels[fg], return_inverse=True)
    out[fg] = inverse.astype(np.int32) + 1
    return out


def _ccl_numpy(mask: np.ndarray, connectivity: int) -> np.ndarray:
    """The numpy route: two passes with a Python union-find (small
    inputs)."""
    h, w = mask.shape
    parent = np.arange(h * w, dtype=np.int64)

    def find(x):
        root = x
        while parent[root] != root:
            root = parent[root]
        while parent[x] != root:
            parent[x], x = root, parent[x]
        return root

    def union(a, b):
        ra, rb = find(a), find(b)
        if ra != rb:
            if ra < rb:
                parent[rb] = ra
            else:
                parent[ra] = rb

    fg = mask != 0
    for y in range(h):
        for x in range(w):
            if not fg[y, x]:
                continue
            i = y * w + x
            if x > 0 and fg[y, x - 1]:
                union(i, i - 1)
            if y > 0 and fg[y - 1, x]:
                union(i, i - w)
            if connectivity == 8 and y > 0:
                if x > 0 and fg[y - 1, x - 1]:
                    union(i, i - w - 1)
                if x + 1 < w and fg[y - 1, x + 1]:
                    union(i, i - w + 1)
    labels = np.zeros(h * w, np.int32)
    remap = {}
    nxt = 0
    flat = fg.reshape(-1)
    for i in range(h * w):
        if flat[i]:
            r = find(i)
            if r not in remap:
                nxt += 1
                remap[r] = nxt
            labels[i] = remap[r]
    return labels.reshape(h, w)


def connected_components_host(mask: np.ndarray,
                              connectivity: int = 4) -> np.ndarray:
    """Exact host CCL by the native union-find: labels 0 = background,
    1..K in raster order."""
    mask = np.ascontiguousarray(np.asarray(mask) != 0, np.uint8)
    if mask.ndim != 2:
        raise ValueError(f"mask must be (H, W), got {mask.shape}")
    if connectivity not in (4, 8):
        raise ValueError("connectivity must be 4 or 8")
    fn = load_native_library().kornia_ccl_label
    fn.restype = ctypes.c_int64
    fn.argtypes = [ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
                   ctypes.c_int64, ctypes.c_int32,
                   ctypes.POINTER(ctypes.c_int32)]
    labels = np.empty(mask.shape, np.int32)
    fn(mask.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
       mask.shape[0], mask.shape[1], connectivity,
       labels.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    return labels


def label_classes_host(img: np.ndarray, skip: int = 127) -> np.ndarray:
    """Label same-valued regions of a u8 class image by the native
    union-find: 4-connectivity, with WHITE (255) also 8-connected (the
    apriltag C library's rule, so a tag's white cells touching only at
    corners stay one component). Pixels equal to ``skip`` stay 0."""
    img = np.ascontiguousarray(img, np.uint8)
    fn = load_native_library().kornia_ccl_label_classes
    fn.restype = ctypes.c_int64
    fn.argtypes = [ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
                   ctypes.c_int64, ctypes.c_uint8,
                   ctypes.POINTER(ctypes.c_int32)]
    labels = np.empty(img.shape, np.int32)
    fn(img.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
       img.shape[0], img.shape[1], skip,
       labels.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    return labels


def _label_classes_numpy(img: np.ndarray, skip: int = 127) -> np.ndarray:
    """The numpy route of :func:`label_classes_host`: per value, the numpy
    CCL, labels offset by the values before it. The same partition as the
    native route, numbered another way."""
    img = np.ascontiguousarray(img, np.uint8)
    labels = np.zeros(img.shape, np.int32)
    offset = 0
    for v in np.unique(img):
        if v == skip:
            continue
        conn = 8 if v == 255 else 4
        sub = _ccl_numpy((img == v).astype(np.uint8), conn)
        labels[sub > 0] = sub[sub > 0] + offset
        offset = labels.max()
    return labels
