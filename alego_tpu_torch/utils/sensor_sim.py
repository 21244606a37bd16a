"""Independent realistic LiDAR sensor simulation (validation data source #2),
a copy of the reference package's numpy simulator on the port's config.

A data source that is NOT the unit-test raycaster (utils/synthetic.py): a
second implementation with a deliberately different scene family and a
much more realistic sensor model, exercising the real-data behaviours the
test raycaster avoids:

* **urban-block scene**: rotated building facades, parked-car boxes, lamp
  posts, tree trunks + canopies (spheres), curbs — not the random
  boxes-on-a-plain of synthetic.py;
* **beam divergence**: each return is the nearest of 3 jittered subrays;
* **range quantization** (1 cm) and additive range noise;
* **incidence-angle + range dropout**: grazing hits and distant weak
  returns vanish, producing the ragged dropout-heavy range images a real
  sensor yields (the test raycaster returns every geometric hit);
* **spurious returns** (dust/multi-path): a fraction of rays return a
  random short range;
* **azimuth jitter** around the bin centre (the test raycaster fires
  exactly at centres — PARITY.md root-cause #1 made it do so);
* **intra-sweep motion** (rolling shutter) with per-column-block poses.

Everything is NumPy host code; points are emitted in firing order, as a
real sensor streams them, ready for rosbag writing (utils/rosbag.write_bag_pointclouds)
and CLI replay.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from ..config import PipelineConfig, LaserType


@dataclasses.dataclass
class UrbanScene:
    boxes: np.ndarray       # [B, 7] cx cy cz hx hy hz yaw (rotated boxes)
    cylinders: np.ndarray   # [C, 4] cx cy radius top_z
    spheres: np.ndarray     # [S, 4] cx cy cz radius
    ground_z: float


def make_urban_scene(seed: int = 0, half: float = 46.0,
                     street: float = 12.0) -> UrbanScene:
    """A city block: the sensor drives the rectangular street ring between
    an inner block of buildings and an outer wall of facades, passing
    parked cars, lamp posts and trees."""
    rng = np.random.default_rng(seed)
    gz = -1.6
    boxes = []

    def add_box(cx, cy, hx, hy, h, yaw=0.0, z0=None):
        z0 = gz if z0 is None else z0
        boxes.append([cx, cy, z0 + h / 2, hx, hy, h / 2, yaw])

    inner = half - street            # inner building block edge
    # inner block: 4 buildings with jittered footprints + yaw
    for sx in (-1, 1):
        for sy in (-1, 1):
            w, d = rng.uniform(9, inner - 3, 2)
            add_box(sx * (inner - w / 2 - rng.uniform(0, 2)),
                    sy * (inner - d / 2 - rng.uniform(0, 2)),
                    w / 2, d / 2, rng.uniform(6, 14),
                    yaw=rng.uniform(-0.12, 0.12))
    # outer facades: segmented walls with gaps (doorways/alleys)
    for side in range(4):
        along = np.arange(-half + 4, half - 4, 8.0)
        for a in along:
            if rng.random() < 0.15:
                continue                      # alley gap
            L = rng.uniform(3.0, 4.0)
            h = rng.uniform(4, 10)
            off = half + rng.uniform(0.0, 0.8)
            if side == 0:
                add_box(a, off, L, 0.3, h)
            elif side == 1:
                add_box(a, -off, L, 0.3, h)
            elif side == 2:
                add_box(off, a, 0.3, L, h)
            else:
                add_box(-off, a, 0.3, L, h)
    # parked cars along the street edges
    ring_r = half - street / 2      # street centreline offset
    for _ in range(14):
        side = rng.integers(4)
        a = rng.uniform(-half + 6, half - 6)
        edge = inner + 1.6 if rng.random() < 0.5 else half - 1.6
        cx, cy = (a, edge) if side == 0 else (a, -edge) if side == 1 \
            else (edge, a) if side == 2 else (-edge, a)
        yaw = 0.0 if side < 2 else np.pi / 2
        add_box(cx, cy, 2.2, 0.9, rng.uniform(1.4, 1.8),
                yaw=yaw + rng.normal(0, 0.05))
    cyls, sphs = [], []
    for _ in range(16):              # lamp posts + tree trunks
        side = rng.integers(4)
        a = rng.uniform(-half + 5, half - 5)
        edge = inner + 0.8
        cx, cy = (a, edge) if side == 0 else (a, -edge) if side == 1 \
            else (edge, a) if side == 2 else (-edge, a)
        if rng.random() < 0.5:
            cyls.append([cx, cy, 0.12, gz + rng.uniform(4, 6)])    # lamp
        else:
            h = rng.uniform(2.5, 4)
            cyls.append([cx, cy, rng.uniform(0.15, 0.3), gz + h])  # trunk
            sphs.append([cx, cy, gz + h + 1.2, rng.uniform(1.2, 2.2)])
    return UrbanScene(np.asarray(boxes, np.float64),
                      np.asarray(cyls, np.float64),
                      np.asarray(sphs, np.float64), gz)


def street_circuit(n_frames: int, half: float = 46.0, street: float = 12.0,
                   speed: float = 1.4) -> np.ndarray:
    """Rounded-rectangle street trajectory [N, 4, 4] (sweep-start poses).

    Constant arc-length speed (m/frame); corners are quarter-circles of
    radius street/2 so heading stays tangent."""
    r = street / 2
    c = half - street / 2            # centreline half-extent
    L = c - r                        # straight half-length
    seg = 2 * L                      # one straight edge length
    quarter = np.pi * r / 2
    total = 4 * (seg + quarter)
    s = (np.arange(n_frames) * speed) % total
    poses = np.zeros((n_frames, 4, 4))
    for k, sk in enumerate(s):
        # walk the circuit: +x edge, corner, +y edge, corner, ...
        rem = sk
        for side in range(4):
            if rem < seg:
                t = rem - L
                if side == 0:
                    x, y, yaw = t, -c, 0.0
                elif side == 1:
                    x, y, yaw = c, t, np.pi / 2
                elif side == 2:
                    x, y, yaw = -t, c, np.pi
                else:
                    x, y, yaw = -c, -t, -np.pi / 2
                break
            rem -= seg
            if rem < quarter:
                a = rem / r
                base = side * np.pi / 2
                ccx = (L if side == 0 else c - r if side == 1 else
                       -L if side == 2 else -(c - r))
                # corner centres, picked so the arc joins the straights
                if side == 0:
                    ccx, ccy = L, -c + r
                elif side == 1:
                    ccx, ccy = c - r, L
                elif side == 2:
                    ccx, ccy = -L, c - r
                else:
                    ccx, ccy = -(c - r), -L
                x = ccx + r * np.cos(base - np.pi / 2 + a)
                y = ccy + r * np.sin(base - np.pi / 2 + a)
                yaw = base + a
                break
            rem -= quarter
        T = np.eye(4)
        cy_, sy_ = np.cos(yaw), np.sin(yaw)
        T[:2, :2] = [[cy_, -sy_], [sy_, cy_]]
        T[:3, 3] = [x, y, 0.0]
        poses[k] = T
    return poses


# ---------------------------------------------------------------------------
# ray casting (independent implementation)
# ---------------------------------------------------------------------------

def _hit_ground(o, d, gz):
    t = np.where(d[..., 2] < -1e-9, (gz - o[..., 2]) / d[..., 2], np.inf)
    nrm = np.zeros(d.shape)
    nrm[..., 2] = 1.0
    return np.where(t > 0, t, np.inf), nrm


def _hit_rot_boxes(o, d, boxes):
    """Rotated-box intersection by transforming rays into box frames."""
    t_best = np.full(d.shape[:-1], np.inf)
    n_best = np.zeros(d.shape)
    for b in boxes:
        cx, cy, cz, hx, hy, hz, yaw = b
        cyw, syw = np.cos(-yaw), np.sin(-yaw)
        R = np.array([[cyw, -syw, 0], [syw, cyw, 0], [0, 0, 1.0]])
        ob = (o - [cx, cy, cz]) @ R.T
        db = d @ R.T
        inv = 1.0 / np.where(np.abs(db) < 1e-12, 1e-12, db)
        lo = (np.array([-hx, -hy, -hz]) - ob) * inv
        hi = (np.array([hx, hy, hz]) - ob) * inv
        tnear = np.minimum(lo, hi)
        tfar = np.maximum(lo, hi).min(-1)
        ax = tnear.argmax(-1)
        tmin = tnear.max(-1)
        ok = (tfar >= tmin) & (tfar > 0) & (tmin > 0)
        t = np.where(ok, tmin, np.inf)
        better = t < t_best
        if not better.any():
            continue
        # face normal in box frame along the entry axis
        nb = np.zeros(d.shape)
        for a_i in range(3):
            sel = better & (ax == a_i)
            if sel.any():
                sgn = -np.sign(db[sel][..., a_i])
                v = np.zeros((sel.sum(), 3))
                v[:, a_i] = sgn
                nb[sel] = v @ R
        t_best = np.where(better, t, t_best)
        n_best = np.where(better[..., None], nb, n_best)
    return t_best, n_best


def _hit_cyls(o, d, cyls, gz):
    t_best = np.full(d.shape[:-1], np.inf)
    n_best = np.zeros(d.shape)
    for c in cyls:
        cx, cy, r, top = c
        ox, oy = o[..., 0] - cx, o[..., 1] - cy
        dx, dy = d[..., 0], d[..., 1]
        a = dx * dx + dy * dy
        bq = 2 * (ox * dx + oy * dy)
        cc = ox * ox + oy * oy - r * r
        disc = bq * bq - 4 * a * cc
        ok = (disc > 0) & (a > 1e-12)
        t = (-bq - np.sqrt(np.maximum(disc, 0))) / np.where(a == 0, 1, 2 * a)
        z = o[..., 2] + t * d[..., 2]
        ok &= (t > 0) & (z > gz) & (z < top)
        better = ok & (t < t_best)
        px = ox + t * dx
        py = oy + t * dy
        nn = np.stack([px, py, np.zeros_like(px)], -1)
        nn /= np.maximum(np.linalg.norm(nn, axis=-1, keepdims=True), 1e-9)
        t_best = np.where(better, t, t_best)
        n_best = np.where(better[..., None], nn, n_best)
    return t_best, n_best


def _hit_spheres(o, d, sphs):
    t_best = np.full(d.shape[:-1], np.inf)
    n_best = np.zeros(d.shape)
    for s in sphs:
        c, r = s[:3], s[3]
        oc = o - c
        bq = 2 * np.sum(oc * d, -1)
        cc = np.sum(oc * oc, -1) - r * r
        disc = bq * bq - 4 * cc
        t = (-bq - np.sqrt(np.maximum(disc, 0))) / 2
        ok = (disc > 0) & (t > 0)
        better = ok & (t < t_best)
        p = o + t[..., None] * d
        nn = (p - c) / r
        t_best = np.where(better, t, t_best)
        n_best = np.where(better[..., None], nn, n_best)
    return t_best, n_best


def _cast(scene: UrbanScene, o, d):
    """Min-range hit over all primitives; returns (t, normal)."""
    t, n = _hit_ground(o, d, scene.ground_z)
    for tt, nn in (_hit_rot_boxes(o, d, scene.boxes),
                   _hit_cyls(o, d, scene.cylinders, scene.ground_z),
                   _hit_spheres(o, d, scene.spheres)):
        better = tt < t
        t = np.where(better, tt, t)
        n = np.where(better[..., None], nn, n)
    return t, n


RFANS_ELEV_DEG = np.array([-15.0, -12.0, -9.5, -8.0, -6.0, -5.0, -4.0,
                           -3.0, -2.0, -1.0, 0.0, 1.0, 3.0, 5.0, 8.0, 11.0])


def simulate_scan(scene: UrbanScene, pose0: np.ndarray, pose1: np.ndarray,
                  cfg: PipelineConfig, rng: np.random.Generator,
                  groups: int = 24, max_range: float = 90.0,
                  range_sigma: float = 0.015, quant: float = 0.01,
                  divergence_mrad: float = 1.5,
                  spurious_frac: float = 0.002) -> np.ndarray:
    """One realistic sweep pose0 -> pose1; returns [R*H, 3] sensor-frame
    points in FIRING order (NaN where no return)."""
    R_, H = cfg.n_scan, cfg.horizon_scan
    if cfg.laser_type == LaserType.RFANS_16M:
        elev = np.radians(RFANS_ELEV_DEG)
    else:
        elev = np.radians(np.arange(R_) * cfg.ang_res_y_deg
                          - cfg.ang_bottom_deg)
    out = np.full((R_, H, 3), np.nan)
    bounds = np.linspace(0, H, groups + 1).astype(int)
    y0a = np.arctan2(pose0[1, 0], pose0[0, 0])
    y1a = np.arctan2(pose1[1, 0], pose1[0, 0])
    dy = np.arctan2(np.sin(y1a - y0a), np.cos(y1a - y0a))
    for g in range(groups):
        c0, c1 = bounds[g], bounds[g + 1]
        cols = np.arange(c0, c1)
        frac = (0.5 * (c0 + c1)) / H
        yaw = y0a + frac * dy
        tr = (1 - frac) * pose0[:3, 3] + frac * pose1[:3, 3]
        cyw, syw = np.cos(yaw), np.sin(yaw)
        Rw = np.array([[cyw, -syw, 0], [syw, cyw, 0], [0, 0, 1.0]])
        # azimuth with per-column jitter
        az = -(cols + 0.5) * cfg.ang_res_x \
            + rng.normal(0, 2e-4, cols.shape)
        ce, se = np.cos(elev)[:, None], np.sin(elev)[:, None]
        ca, sa = np.cos(az)[None, :], np.sin(az)[None, :]
        dirs = np.stack([ce * ca, ce * sa,
                         np.broadcast_to(se, (R_, len(cols)))], -1)
        # beam divergence: 3 jittered subrays, keep the NEAREST return
        t_min = np.full((R_, len(cols)), np.inf)
        n_at = np.zeros((R_, len(cols), 3))
        for _ in range(3):
            jit = rng.normal(0, divergence_mrad * 1e-3, dirs.shape)
            dj = dirs + jit
            dj /= np.linalg.norm(dj, axis=-1, keepdims=True)
            t, n = _cast(scene, tr, dj @ Rw.T)
            better = t < t_min
            t_min = np.where(better, t, t_min)
            n_at = np.where(better[..., None], n, n_at)
        # incidence + range dropout
        cosi = np.abs(np.sum((dirs @ Rw.T) * n_at, -1))
        p_keep = np.clip(1.15 * cosi ** 0.35, 0, 1) \
            * np.clip(1.6 - t_min / max_range, 0, 1) ** 0.25
        keep = (rng.random(t_min.shape) < p_keep) & np.isfinite(t_min) \
            & (t_min < max_range) & (t_min > cfg.min_range)
        # noise + quantization
        t_q = np.round((t_min + rng.normal(0, range_sigma, t_min.shape))
                       / quant) * quant
        # spurious short returns
        spur = rng.random(t_min.shape) < spurious_frac
        t_q = np.where(spur, rng.uniform(cfg.min_range, 12.0, t_min.shape),
                       t_q)
        keep = keep | spur
        pts = dirs * np.where(keep, t_q, np.nan)[..., None]
        out[:, c0:c1] = pts
    return out.transpose(1, 0, 2).reshape(-1, 3).astype(np.float32)


def simulate_sequence(scene: UrbanScene, poses: np.ndarray,
                      cfg: PipelineConfig, seed: int = 0, **kw):
    """All frames; returns (points [N, cap, 3], mask [N, cap])."""
    rng = np.random.default_rng(seed)
    cap = cfg.max_raw_points
    n = poses.shape[0]
    out = np.zeros((n, cap, 3), np.float32)
    msk = np.zeros((n, cap), bool)
    for k in range(n):
        p1 = poses[min(k + 1, n - 1)]
        pts = simulate_scan(scene, poses[k], p1, cfg, rng, **kw)
        good = np.isfinite(pts).all(-1)
        sel = pts[good][:cap]
        out[k, : len(sel)] = sel
        msk[k, : len(sel)] = True
    return out, msk
