"""Contour extraction on the host (port of kornia_tpu/ops/contours.py).

Border following is sequential pointer-chasing, so it runs on the host,
as in the reference: components come from the native union-find CCL
(:func:`connected_components_host`), and each component's outer
boundary is traced with Moore-neighbour tracing (Jacob's stopping
criterion). The geometry helpers (area, perimeter, polygon
simplification) work on the traced point lists.
"""

from __future__ import annotations

from typing import List

import numpy as np

from kornia_tpu_torch.ops.connected_components import (
    connected_components_host)

# Moore neighborhood in clockwise order starting from W
_MOORE = np.array([
    (0, -1), (-1, -1), (-1, 0), (-1, 1),
    (0, 1), (1, 1), (1, 0), (1, -1),
], np.int64)


def _trace_boundary(fg: np.ndarray, start: tuple) -> np.ndarray:
    """Moore-neighbor trace of one component's outer boundary.

    `start` must be the component's raster-first pixel (its W neighbor is
    guaranteed background).
    """
    h, w = fg.shape

    def is_fg(y, x):
        return 0 <= y < h and 0 <= x < w and fg[y, x]

    boundary = [start]
    # backtrack direction: we entered `start` from the West
    prev_dir = 0
    cur = start
    first_move = None
    for _ in range(4 * h * w):  # hard bound
        found = False
        # search clockwise starting just after the backtrack position
        for k in range(1, 9):
            d = (prev_dir + k) % 8
            ny, nx = cur[0] + _MOORE[d][0], cur[1] + _MOORE[d][1]
            if is_fg(ny, nx):
                nxt = (int(ny), int(nx))
                # next search starts just after the direction pointing
                # back at cur: (d+4)%8 points back, +1 to step past it
                prev_dir = (d + 5) % 8
                move = (cur, nxt)
                if first_move is None:
                    first_move = move
                elif move == first_move:
                    return np.asarray(boundary[:-1], np.int64)
                boundary.append(nxt)
                cur = nxt
                found = True
                break
        if not found:  # isolated pixel
            return np.asarray([start], np.int64)
    return np.asarray(boundary, np.int64)


def find_contours(mask: np.ndarray, connectivity: int = 8) -> List[np.ndarray]:
    """Outer boundaries of all components, raster order.

    Returns a list of (N_i, 2) int64 arrays of (y, x) boundary pixels
    (clockwise in image coordinates).
    """
    mask = np.asarray(mask) != 0
    labels = connected_components_host(mask.astype(np.uint8), connectivity)
    n = labels.max()
    contours = []
    for lbl in range(1, n + 1):
        comp = labels == lbl
        ys, xs = np.nonzero(comp)
        if ys.size == 0:
            continue
        start = (int(ys[0]), int(xs[0]))
        contours.append(_trace_boundary(comp, start))
    return contours


def contour_area(contour: np.ndarray) -> float:
    """Shoelace area of a (N, 2) (y, x) closed contour."""
    if len(contour) < 3:
        return 0.0
    y = contour[:, 0].astype(np.float64)
    x = contour[:, 1].astype(np.float64)
    return float(abs(np.dot(x, np.roll(y, -1)) - np.dot(y, np.roll(x, -1)))
                 / 2.0)


def contour_perimeter(contour: np.ndarray, closed: bool = True) -> float:
    """Polyline length of a (N, 2) contour."""
    if len(contour) < 2:
        return 0.0
    pts = contour.astype(np.float64)
    if closed:
        pts = np.vstack([pts, pts[:1]])
    return float(np.sum(np.linalg.norm(np.diff(pts, axis=0), axis=1)))


def approx_polygon(contour: np.ndarray, epsilon: float) -> np.ndarray:
    """Ramer–Douglas–Peucker simplification of a closed contour."""
    pts = contour.astype(np.float64)
    n = len(pts)
    if n < 3:
        return contour.copy()

    # split at the two most distant points for a stable closed-curve RDP
    d = np.linalg.norm(pts - pts[0], axis=1)
    far = int(np.argmax(d))

    def rdp(p):
        if len(p) < 3:
            return p
        a, b = p[0], p[-1]
        ab = b - a
        denom = np.linalg.norm(ab)
        if denom == 0:
            dist = np.linalg.norm(p - a, axis=1)
        else:
            rel = p - a
            dist = np.abs(ab[0] * rel[:, 1] - ab[1] * rel[:, 0]) / denom
        i = int(np.argmax(dist))
        if dist[i] > epsilon:
            left = rdp(p[: i + 1])
            right = rdp(p[i:])
            return np.vstack([left[:-1], right])
        return np.vstack([a, b])

    seg1 = rdp(pts[: far + 1])
    seg2 = rdp(np.vstack([pts[far:], pts[:1]]))
    out = np.vstack([seg1[:-1], seg2[:-1]])
    return out.astype(contour.dtype)
