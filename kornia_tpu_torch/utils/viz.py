"""Host-side trajectory and map view (port of kornia_tpu/utils/viz.py).

A self-contained interactive HTML file: the trajectory, map points, ground
truth and loop edges embedded as JSON beside a small canvas orbit renderer
(drag to rotate, wheel to zoom). One file, no network. The template and
the JSON are the reference's, so both packages write the same bytes for the
same trajectory.
"""

from __future__ import annotations

import json
from typing import Optional, Sequence

import numpy as np
import torch

_TEMPLATE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>kornia_tpu trajectory</title>
<style>
 body {{ margin:0; background:#101014; color:#ddd;
        font:13px sans-serif; }}
 #hud {{ position:fixed; top:8px; left:10px; }}
 canvas {{ display:block; }}
</style></head><body>
<div id="hud">{title} — drag: rotate · wheel: zoom ·
 <span style="color:#6cf">est</span>
 <span style="color:#888">gt</span>
 <span style="color:#f80">loop</span>
 <span style="color:#4a4">points</span></div>
<canvas id="c"></canvas>
<script>
const DATA = {data};
const cv = document.getElementById("c"), ctx = cv.getContext("2d");
let rx = -0.9, ry = 0.6, zoom = 1.0, drag = null;
function fit() {{ cv.width = innerWidth; cv.height = innerHeight; }}
addEventListener("resize", () => {{ fit(); draw(); }});
cv.addEventListener("mousedown", e => drag = [e.clientX, e.clientY]);
addEventListener("mouseup", () => drag = null);
addEventListener("mousemove", e => {{
  if (!drag) return;
  ry += (e.clientX - drag[0]) * 0.008;
  rx += (e.clientY - drag[1]) * 0.008;
  drag = [e.clientX, e.clientY]; draw();
}});
cv.addEventListener("wheel", e => {{
  zoom *= Math.exp(-e.deltaY * 0.001); draw(); e.preventDefault();
}});
const all = [].concat(DATA.est || [], DATA.gt || [], DATA.points || []);
const c0 = [0,1,2].map(k => all.reduce((s,p) => s+p[k], 0) / all.length);
const span = Math.max(...all.map(
  p => Math.hypot(p[0]-c0[0], p[1]-c0[1], p[2]-c0[2]))) || 1;
function proj(p) {{
  let x = p[0]-c0[0], y = p[1]-c0[1], z = p[2]-c0[2];
  let x1 = x*Math.cos(ry) + z*Math.sin(ry);
  let z1 = -x*Math.sin(ry) + z*Math.cos(ry);
  let y1 = y*Math.cos(rx) - z1*Math.sin(rx);
  const s = 0.42 * Math.min(cv.width, cv.height) * zoom / span;
  return [cv.width/2 + x1*s, cv.height/2 + y1*s];
}}
function polyline(pts, color, w) {{
  if (!pts || pts.length < 2) return;
  ctx.strokeStyle = color; ctx.lineWidth = w; ctx.beginPath();
  pts.forEach((p, i) => {{
    const q = proj(p);
    i ? ctx.lineTo(q[0], q[1]) : ctx.moveTo(q[0], q[1]);
  }});
  ctx.stroke();
}}
function draw() {{
  ctx.fillStyle = "#101014"; ctx.fillRect(0, 0, cv.width, cv.height);
  ctx.fillStyle = "#4a4";
  (DATA.points || []).forEach(p => {{
    const q = proj(p); ctx.fillRect(q[0], q[1], 1.6, 1.6);
  }});
  polyline(DATA.gt, "#888", 1.2);
  polyline(DATA.est, "#6cf", 2.0);
  ctx.strokeStyle = "#f80"; ctx.lineWidth = 1.5;
  (DATA.loops || []).forEach(e => {{
    const a = proj(DATA.est[e[0]]), b = proj(DATA.est[e[1]]);
    ctx.beginPath(); ctx.moveTo(a[0], a[1]); ctx.lineTo(b[0], b[1]);
    ctx.stroke();
  }});
  ctx.fillStyle = "#6cf";
  (DATA.est || []).forEach(p => {{
    const q = proj(p); ctx.fillRect(q[0]-1.5, q[1]-1.5, 3, 3);
  }});
}}
fit(); draw();
</script></body></html>
"""


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float64)


def write_trajectory_html(
    path: str,
    est_centers: np.ndarray,
    gt_centers: Optional[np.ndarray] = None,
    points: Optional[np.ndarray] = None,
    loop_edges: Optional[Sequence] = None,
    title: str = "kornia_tpu trajectory",
    max_points: int = 20000,
) -> None:
    """Write a self-contained interactive 3-D trajectory view.

    est_centers: (N, 3) camera centers; gt_centers: optional (M, 3);
    points: optional (P, 3) map points (subsampled to ``max_points``);
    loop_edges: optional [(i, j), ...] indices into est_centers.
    """
    est = _host(est_centers)
    data = {"est": est.round(5).tolist()}
    if gt_centers is not None:
        data["gt"] = _host(gt_centers).round(5).tolist()
    if points is not None:
        pts = _host(points)
        if len(pts) > max_points:
            sel = np.linspace(0, len(pts) - 1, max_points).astype(int)
            pts = pts[sel]
        data["points"] = pts.round(4).tolist()
    if loop_edges:
        data["loops"] = [[int(a), int(b)] for a, b in loop_edges]
    html = _TEMPLATE.format(title=title, data=json.dumps(data))
    with open(path, "w") as f:
        f.write(html)


def slam_viz(path: str, slam_system, gt_centers=None,
             title: str = "kornia_tpu SLAM") -> None:
    """Dump a MonocularSlam system's keyframe trajectory and map to HTML:
    the camera centres (the translation of each inverted float32 pose),
    the valid map points and the loop edges (weight above 1)."""
    from kornia_tpu_torch.geometry import liegroup as lg

    kfs = slam_system.map.keyframes
    est = np.stack([
        lg.se3_inverse(torch.as_tensor(np.asarray(kf.pose),
                                       dtype=torch.float32))[4:7].numpy()
        for kf in kfs])
    kf_ids = {kf.kf_id: i for i, kf in enumerate(kfs)}
    loops = []
    for edge in getattr(slam_system.map, "edges", []):
        a, b, *rest = edge
        w = rest[-1] if rest else 1.0
        if isinstance(w, (int, float)) and w > 1.0 \
                and a in kf_ids and b in kf_ids:
            loops.append((kf_ids[a], kf_ids[b]))
    m = slam_system.map
    pts = m.point_xyz[m.point_valid] if m.n_points else None
    write_trajectory_html(path, est, gt_centers=gt_centers, points=pts,
                          loop_edges=loops, title=title)
