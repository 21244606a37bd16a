"""Self-contained HTML map viewer — the rviz session equivalent (C16).

The reference's operator experience is an rviz window subscribed to
/laser_cloud_surround and the odometry paths (rviz/test_0420.rviz,
LM.cpp:744-777).  There is no display server on a GPU node, so the
equivalent here is a single ``viewer.html`` the CLI writes next to its
outputs: the full map cloud + the estimated trajectory embedded as JSON,
rendered by a dependency-free canvas orbiter (drag to orbit, wheel to
zoom, shift-drag to pan).  Open it in any browser — no server, no
install, works over a copied file.
"""

from __future__ import annotations

import json

import numpy as np

_TEMPLATE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>{title}</title>
<style>
 body {{ margin:0; background:#111; color:#ccc; font:13px monospace; }}
 #hud {{ position:fixed; top:8px; left:10px; pointer-events:none; }}
 canvas {{ display:block; }}
</style></head><body>
<div id="hud">{title}<br>{n_pts} map points &middot; {n_poses} poses<br>
drag: orbit &middot; wheel: zoom &middot; shift-drag: pan</div>
<canvas id="c"></canvas>
<script>
const PTS = {pts_json};
const TRAJ = {traj_json};
const cv = document.getElementById('c'), ctx = cv.getContext('2d');
let yaw = -0.7, pitch = 0.5, dist = {dist}, cx = {cx}, cy = {cy}, cz = {cz};
let panX = 0, panY = 0;
function resize() {{ cv.width = innerWidth; cv.height = innerHeight; draw(); }}
addEventListener('resize', resize);
let zmin = Infinity, zmax = -Infinity;
for (const p of PTS) {{ if (p[2] < zmin) zmin = p[2]; if (p[2] > zmax) zmax = p[2]; }}
const zspan = Math.max(zmax - zmin, 1e-6);
function color(z) {{
  const t = (z - zmin) / zspan;                       // viridis-ish ramp
  const r = Math.round(255 * Math.min(1, Math.max(0, 2.5 * t - 0.9)));
  const g = Math.round(255 * Math.min(1, 0.2 + 1.2 * t));
  const b = Math.round(255 * Math.max(0, 1.0 - 1.6 * t));
  return `rgb(${{r}},${{g}},${{b}})`;
}}
function project(x, y, z) {{
  x -= cx; y -= cy; z -= cz;
  const cyaw = Math.cos(yaw), syaw = Math.sin(yaw);
  const cp = Math.cos(pitch), sp = Math.sin(pitch);
  const x1 = cyaw * x + syaw * y, y1 = -syaw * x + cyaw * y;
  const y2 = cp * y1 - sp * z,    z2 = sp * y1 + cp * z;
  const d = dist / (dist + y2 + dist * 0.001);
  return [cv.width / 2 + (x1 * d) * (cv.height / dist) + panX,
          cv.height / 2 - (z2 * d) * (cv.height / dist) + panY, d];
}}
function draw() {{
  ctx.fillStyle = '#111'; ctx.fillRect(0, 0, cv.width, cv.height);
  for (const p of PTS) {{
    const q = project(p[0], p[1], p[2]);
    if (q[2] > 0) {{ ctx.fillStyle = color(p[2]);
                     ctx.fillRect(q[0], q[1], 2, 2); }}
  }}
  ctx.strokeStyle = '#fff'; ctx.lineWidth = 2; ctx.beginPath();
  TRAJ.forEach((p, i) => {{
    const q = project(p[0], p[1], p[2]);
    i ? ctx.lineTo(q[0], q[1]) : ctx.moveTo(q[0], q[1]);
  }});
  ctx.stroke();
  if (TRAJ.length) {{
    const q = project(...TRAJ[TRAJ.length - 1]);
    ctx.fillStyle = '#f44'; ctx.beginPath();
    ctx.arc(q[0], q[1], 5, 0, 7); ctx.fill();
  }}
}}
let drag = null;
cv.onmousedown = e => drag = [e.clientX, e.clientY, e.shiftKey];
onmouseup = () => drag = null;
onmousemove = e => {{
  if (!drag) return;
  const dx = e.clientX - drag[0], dy = e.clientY - drag[1];
  if (drag[2]) {{ panX += dx; panY += dy; }}
  else {{ yaw += dx * 0.01;
          pitch = Math.max(-1.5, Math.min(1.5, pitch + dy * 0.01)); }}
  drag = [e.clientX, e.clientY, drag[2]]; draw();
}};
cv.onwheel = e => {{ dist *= Math.exp(e.deltaY * 0.001); draw();
                     e.preventDefault(); }};
resize();
</script></body></html>
"""


def write_html_viewer(path: str, trajectory: np.ndarray,
                      map_points: np.ndarray, title: str = "alego_tpu_torch map",
                      max_points: int = 120_000) -> None:
    """Write a standalone interactive viewer.

    trajectory: [N, 4, 4] poses (or [N, 3] positions); map_points: [M, 3].
    Clouds above ``max_points`` are uniformly subsampled to keep the HTML
    small (120k points ~= 6 MB).
    """
    traj = np.asarray(trajectory)
    if traj.ndim == 3:
        traj = traj[:, :3, 3]
    pts = np.asarray(map_points, np.float32).reshape(-1, 3)
    if len(pts) > max_points:
        pts = pts[:: int(np.ceil(len(pts) / max_points))]
    center = pts.mean(0) if len(pts) else np.zeros(3)
    span = float(np.abs(pts - center).max()) if len(pts) else 10.0
    html = _TEMPLATE.format(
        title=title, n_pts=len(pts), n_poses=len(traj),
        pts_json=json.dumps(np.round(pts, 2).tolist()),
        traj_json=json.dumps(np.round(traj, 2).tolist()),
        dist=round(max(2.0 * span, 1.0), 1),
        cx=round(float(center[0]), 2), cy=round(float(center[1]), 2),
        cz=round(float(center[2]), 2))
    with open(path, "w") as f:
        f.write(html)
