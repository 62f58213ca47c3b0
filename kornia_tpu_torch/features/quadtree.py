"""ORB-SLAM3 quadtree keypoint distribution, the literal algorithm (the
port's own copy of kornia_tpu/features/quadtree.py; numpy only).

ORB-SLAM3's DistributeOctTree: seed nodes across the width, repeatedly
quarter every node holding more than one keypoint until the node count
reaches the target (or no node can divide), then keep the best-response
keypoint per node. The node set grows with the observed keypoint layout,
so it runs on the host; ``features/orb.orb_detect_and_describe_quadtree``
is the pipeline that uses it, and the fixed-shape per-cell cap + global
top-k of ``orb_detect_and_describe`` stays the default.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import numpy as np


@dataclass
class _Node:
    x0: float
    y0: float
    x1: float
    y1: float
    idx: np.ndarray       # candidate indices inside this node

    @property
    def no_more(self) -> bool:
        return len(self.idx) == 1


def distribute_quadtree(xy: np.ndarray, scores: np.ndarray,
                        n_target: int, width: float, height: float
                        ) -> np.ndarray:
    """Select ≤ n_target keypoint indices with ORB-SLAM3's quadtree.

    xy: (N, 2) candidate positions; scores: (N,) responses. Returns the
    selected indices (best response per final node), sorted by
    descending response.
    """
    xy = np.asarray(xy, np.float64)
    scores = np.asarray(scores, np.float64)
    n = len(xy)
    if n == 0 or n_target <= 0:
        return np.empty(0, np.int64)
    if n <= n_target:
        return np.argsort(-scores).astype(np.int64)

    # seed nodes: round(w/h) columns spanning the width (ORB-SLAM3's
    # nIni), at least one
    n_ini = max(1, int(round(width / max(height, 1.0))))
    hx = width / n_ini
    nodes: List[_Node] = []
    for i in range(n_ini):
        x0 = i * hx
        x1 = (i + 1) * hx
        m = (xy[:, 0] >= x0) & (xy[:, 0] < x1) if i < n_ini - 1 else \
            (xy[:, 0] >= x0) & (xy[:, 0] <= x1)
        idx = np.nonzero(m)[0]
        if len(idx):
            nodes.append(_Node(x0, 0.0, x1, height, idx))

    while True:
        if len(nodes) >= n_target:
            break
        # nodes able to divide, largest population first (ORB-SLAM3
        # divides the crowded nodes when close to the target)
        divisible = [k for k, nd in enumerate(nodes) if not nd.no_more]
        if not divisible:
            break
        divisible.sort(key=lambda k: -len(nodes[k].idx))
        new_nodes: List[_Node] = []
        divided = set()
        for k in divisible:
            nd = nodes[k]
            cx = 0.5 * (nd.x0 + nd.x1)
            cy = 0.5 * (nd.y0 + nd.y1)
            px = xy[nd.idx]
            left = px[:, 0] < cx
            top = px[:, 1] < cy
            for mx, my, bx0, by0, bx1, by1 in (
                (left, top, nd.x0, nd.y0, cx, cy),
                (~left, top, cx, nd.y0, nd.x1, cy),
                (left, ~top, nd.x0, cy, cx, nd.y1),
                (~left, ~top, cx, cy, nd.x1, nd.y1),
            ):
                sel = nd.idx[mx & my]
                if len(sel):
                    new_nodes.append(_Node(bx0, by0, bx1, by1, sel))
            divided.add(k)
            if len(nodes) - len(divided) + len(new_nodes) >= n_target:
                break
        nodes = [nd for k, nd in enumerate(nodes)
                 if k not in divided] + new_nodes
        if not divided:
            break

    best = np.asarray([nd.idx[np.argmax(scores[nd.idx])]
                       for nd in nodes], np.int64)
    if len(best) > n_target:
        order = np.argsort(-scores[best])[:n_target]
        best = best[order]
    else:
        best = best[np.argsort(-scores[best])]
    return best


def occupancy(xy: np.ndarray, width: float, height: float,
              grid: int = 8) -> float:
    """Fraction of grid cells holding ≥1 keypoint: the spatial-spread
    metric the distribution contract is graded on."""
    if len(xy) == 0:
        return 0.0
    gx = np.clip((np.asarray(xy)[:, 0] / width * grid).astype(int),
                 0, grid - 1)
    gy = np.clip((np.asarray(xy)[:, 1] / height * grid).astype(int),
                 0, grid - 1)
    return len(set(zip(gx.tolist(), gy.tolist()))) / float(grid * grid)
