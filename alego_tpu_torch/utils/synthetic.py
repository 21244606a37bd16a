"""Synthetic 16-beam LiDAR world + raycaster (host-side, NumPy).

The reference was validated only by replaying two private rosbags and
eyeballing rviz (README.md:27-54); no fixture data ships with it.  This module
is the test strategy the reference lacks: a procedural world (ground plane,
walls/boxes for planar "surf" structure, poles/box edges for "corner"
structure) plus an exact raycaster producing scans with known ground-truth
poses, so every pipeline stage and the end-to-end ATE can be checked against
truth.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from ..config import PipelineConfig, LaserType


@dataclasses.dataclass
class World:
    """Axis-aligned boxes + vertical cylinders + ground plane at z."""

    boxes: np.ndarray       # [B, 6] xmin ymin zmin xmax ymax zmax
    cylinders: np.ndarray   # [C, 4] cx cy radius height(top z from ground)
    ground_z: float = -1.5


def make_world(seed: int = 0, n_boxes: int = 14, n_cyl: int = 12,
               extent: float = 60.0, ground_z: float = -1.5,
               clear_path: Optional[np.ndarray] = None,
               clear_margin: float = 6.0) -> World:
    """Random world; primitives are pushed away from ``clear_path`` (xy
    positions the sensor will visit) so trajectories never enter geometry."""
    rng = np.random.default_rng(seed)
    if clear_path is None:
        clear_path = np.zeros((1, 2))

    def clear(cx, cy, half_size):
        d = np.hypot(clear_path[:, 0] - cx, clear_path[:, 1] - cy).min()
        need = clear_margin + half_size
        if d < need:
            # push radially away from the nearest path point
            k = np.argmin(np.hypot(clear_path[:, 0] - cx, clear_path[:, 1] - cy))
            vx, vy = cx - clear_path[k, 0], cy - clear_path[k, 1]
            n = np.hypot(vx, vy) or 1.0
            cx += vx / n * (need - d + 1.0)
            cy += vy / n * (need - d + 1.0)
        return cx, cy

    boxes = []
    for _ in range(n_boxes):
        cx, cy = rng.uniform(-extent, extent, 2)
        w, d = rng.uniform(2.0, 10.0, 2)
        cx, cy = clear(cx, cy, max(w, d) / 2)
        h = rng.uniform(2.0, 6.0)
        boxes.append([cx - w / 2, cy - d / 2, ground_z, cx + w / 2, cy + d / 2, ground_z + h])
    cyls = []
    for _ in range(n_cyl):
        cx, cy = rng.uniform(-extent, extent, 2)
        cx, cy = clear(cx, cy, 0.5)
        r = rng.uniform(0.1, 0.4)
        h = rng.uniform(3.0, 7.0)
        cyls.append([cx, cy, r, ground_z + h])
    # perimeter walls (thin boxes) give long planar structure for surf features
    E = extent + 8.0
    t = 0.5
    walls = [
        [-E, -E, ground_z, E, -E + t, ground_z + 4.0],
        [-E, E - t, ground_z, E, E, ground_z + 4.0],
        [-E, -E, ground_z, -E + t, E, ground_z + 4.0],
        [E - t, -E, ground_z, E, E, ground_z + 4.0],
    ]
    return World(boxes=np.array(boxes + walls, np.float64),
                 cylinders=np.array(cyls, np.float64), ground_z=ground_z)


def _rpy_to_rot(rpy: np.ndarray) -> np.ndarray:
    r, p, y = rpy
    sr, cr, sp, cp, sy, cy = np.sin(r), np.cos(r), np.sin(p), np.cos(p), np.sin(y), np.cos(y)
    return np.array([
        [cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr],
        [sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr],
        [-sp, cp * sr, cp * cr]])


def loop_trajectory(n_frames: int, radius: float = 25.0, speed: float = 0.6,
                    closed: bool = True) -> np.ndarray:
    """Ground-truth poses [N, 4, 4]: a circular loop with tangent heading.

    ``speed`` is metres per frame along the arc; with default radius and 5 Hz
    framing this is ~3 m/s.  A closed loop revisits its start, exercising
    loop-closure detection (>30 s gap, LM.cpp:934).
    """
    total_angle = 2 * np.pi if closed else (speed * n_frames) / radius
    s = np.linspace(0, total_angle, n_frames, endpoint=closed)
    poses = np.zeros((n_frames, 4, 4))
    for k, a in enumerate(s):
        x, y = radius * np.sin(a), radius * (1 - np.cos(a))
        yaw = a
        T = np.eye(4)
        T[:3, :3] = _rpy_to_rot(np.array([0.0, 0.0, yaw]))
        T[:3, 3] = [x, y, 0.0]
        poses[k] = T
    return poses


def ray_directions(cfg: PipelineConfig) -> np.ndarray:
    """[R, H, 3] unit ray directions in the sensor frame.

    Elevations follow the sensor model so that re-projection recovers the ring:
    uniform 2 deg spacing for LSLIDAR_C16 (IP.cpp:140) or the RFANS_16M band
    centres (inverse of the piecewise table at IP.cpp:144-171).
    """
    if cfg.laser_type == LaserType.RFANS_16M:
        # band centres inverting IP.cpp:144-171: rings 0-3 fixed, 4-10 at 1 deg,
        # 11-12 at 2 deg, 13-15 at 3 deg spacing
        elev_deg = np.array([-15.0, -12.0, -9.5, -8.0,
                             -6.0, -5.0, -4.0, -3.0, -2.0, -1.0, 0.0,
                             1.0, 3.0, 5.0, 8.0, 11.0], np.float64)
        assert elev_deg.shape[0] == cfg.n_scan
    else:
        elev_deg = np.arange(cfg.n_scan) * cfg.ang_res_y_deg - cfg.ang_bottom_deg
    elev = np.radians(elev_deg)
    # bin CENTRES (c + 0.5): rays exactly on bin boundaries would make the
    # projector's floor() a coin flip per point (f32 vs f64, and frame to
    # frame), destabilising the whole downstream pipeline
    az = -(np.arange(cfg.horizon_scan) + 0.5) * np.radians(cfg.ang_res_x_deg)
    ce, se = np.cos(elev)[:, None], np.sin(elev)[:, None]
    ca, sa = np.cos(az)[None, :], np.sin(az)[None, :]
    dirs = np.stack([ce * ca, ce * sa, np.broadcast_to(se, ce * ca * 0 + se.shape
                     if False else (cfg.n_scan, cfg.horizon_scan))], -1)
    return dirs


def _ray_ground(origin, dirs, ground_z):
    dz = dirs[..., 2]
    t = np.where(dz < -1e-9, (ground_z - origin[2]) / np.where(dz == 0, 1, dz), np.inf)
    return np.where(t > 0, t, np.inf)


def _ray_boxes(origin, dirs, boxes):
    """Slab-method AABB intersection; returns min positive t over boxes."""
    t_best = np.full(dirs.shape[:-1], np.inf)
    inv = 1.0 / np.where(np.abs(dirs) < 1e-12, 1e-12, dirs)
    for b in boxes:
        lo = (b[:3] - origin) * inv
        hi = (b[3:] - origin) * inv
        tmin = np.minimum(lo, hi).max(-1)
        tmax = np.maximum(lo, hi).min(-1)
        t = np.where((tmax >= tmin) & (tmax > 0), np.where(tmin > 0, tmin, np.inf), np.inf)
        t_best = np.minimum(t_best, t)
    return t_best


def _ray_cylinders(origin, dirs, cyls, ground_z):
    t_best = np.full(dirs.shape[:-1], np.inf)
    for c in cyls:
        cx, cy, r, top = c
        ox, oy = origin[0] - cx, origin[1] - cy
        dx, dy = dirs[..., 0], dirs[..., 1]
        a = dx * dx + dy * dy
        b = 2 * (ox * dx + oy * dy)
        cc = ox * ox + oy * oy - r * r
        disc = b * b - 4 * a * cc
        ok = (disc > 0) & (a > 1e-12)
        sq = np.sqrt(np.maximum(disc, 0))
        t = (-b - sq) / np.where(a == 0, 1, 2 * a)
        z = origin[2] + t * dirs[..., 2]
        ok &= (t > 0) & (z > ground_z) & (z < top)
        t_best = np.minimum(t_best, np.where(ok, t, np.inf))
    return t_best


def render_scan(world: World, pose: np.ndarray, cfg: PipelineConfig,
                noise: float = 0.0, max_range: float = 120.0,
                rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """Raycast one scan; returns points [R*H, 3] in the *sensor* frame.

    Missed rays are NaN (the reference drops NaNs at IP.cpp:116).
    """
    dirs_s = ray_directions(cfg)
    R3 = pose[:3, :3]
    origin = pose[:3, 3]
    dirs_w = dirs_s @ R3.T
    t = _ray_ground(origin, dirs_w, world.ground_z)
    t = np.minimum(t, _ray_boxes(origin, dirs_w, world.boxes))
    t = np.minimum(t, _ray_cylinders(origin, dirs_w, world.cylinders, world.ground_z))
    if noise > 0:
        if rng is None:
            rng = np.random.default_rng(0)
        t = t + rng.normal(0, noise, t.shape)
    hit = np.isfinite(t) & (t < max_range) & (t > cfg.min_range)
    pts_sensor = dirs_s * np.where(hit, t, 0.0)[..., None]
    pts_sensor = np.where(hit[..., None], pts_sensor, np.nan)
    # FIRING order (column-major: all rings of col 0, then col 1, ...) — a
    # real spinning sensor emits this order, and the projector derives the
    # sweep orientation span from the first/last point in arrival order
    # (IP.cpp:120-130); ring-major order fed it a bogus span
    return pts_sensor.transpose(1, 0, 2).reshape(-1, 3).astype(np.float32)


def _interp_pose(T0: np.ndarray, T1: np.ndarray, a: float) -> np.ndarray:
    """Planar pose interpolation (translation lerp + yaw slerp)."""
    y0 = np.arctan2(T0[1, 0], T0[0, 0])
    y1 = np.arctan2(T1[1, 0], T1[0, 0])
    dy = np.arctan2(np.sin(y1 - y0), np.cos(y1 - y0))
    T = np.eye(4)
    T[:3, :3] = _rpy_to_rot(np.array([0.0, 0.0, y0 + a * dy]))
    T[:3, 3] = (1 - a) * T0[:3, 3] + a * T1[:3, 3]
    return T


def render_scan_skewed(world: World, pose0: np.ndarray, pose1: np.ndarray,
                       cfg: PipelineConfig, noise: float = 0.0,
                       rng: Optional[np.random.Generator] = None,
                       groups: int = 32, max_range: float = 120.0) -> np.ndarray:
    """Raycast one scan WITH intra-sweep motion (rolling-shutter skew).

    A real spinning LiDAR fires each azimuth column at a different time while
    the platform moves; the raw cloud mixes per-firing-time frames — the
    distortion ``adjustDistortion`` (LO.cpp:636-805) exists to undo.  The
    plain :func:`render_scan` renders from ONE pose and therefore can never
    exercise de-skew.  Here the sweep [pose0 -> pose1] is split into
    ``groups`` column blocks; block g's rays are cast from the interpolated
    pose at its firing time, and the returned point is expressed in the
    sensor frame AT FIRING TIME (``dir * range``), exactly as a driver
    assembles raw returns.
    """
    dirs_s = ray_directions(cfg)                      # [R, H, 3]
    H = cfg.horizon_scan
    out = np.full((cfg.n_scan, H, 3), np.nan)
    bounds = np.linspace(0, H, groups + 1).astype(int)
    for g in range(groups):
        c0, c1 = bounds[g], bounds[g + 1]
        if c0 == c1:
            continue
        a = (0.5 * (c0 + c1)) / H
        T = _interp_pose(pose0, pose1, a)
        d = dirs_s[:, c0:c1]
        dirs_w = d @ T[:3, :3].T
        origin = T[:3, 3]
        t = _ray_ground(origin, dirs_w, world.ground_z)
        t = np.minimum(t, _ray_boxes(origin, dirs_w, world.boxes))
        t = np.minimum(t, _ray_cylinders(origin, dirs_w, world.cylinders,
                                         world.ground_z))
        if noise > 0:
            if rng is None:
                rng = np.random.default_rng(0)
            t = t + rng.normal(0, noise, t.shape)
        hit = np.isfinite(t) & (t < max_range) & (t > cfg.min_range)
        pts = d * np.where(hit, t, 0.0)[..., None]
        out[:, c0:c1] = np.where(hit[..., None], pts, np.nan)
    # firing order, as in render_scan
    return out.transpose(1, 0, 2).reshape(-1, 3).astype(np.float32)


def render_sequence_skewed(world: World, poses: np.ndarray,
                           cfg: PipelineConfig, noise: float = 0.0,
                           seed: int = 0, groups: int = 32):
    """Render all frames with intra-sweep motion; frame k sweeps from
    poses[k] to poses[k+1] (the last frame holds).  Returns (points, mask)
    padded like :func:`render_sequence`."""
    rng = np.random.default_rng(seed)
    cap = cfg.max_raw_points
    n = poses.shape[0]
    out = np.zeros((n, cap, 3), np.float32)
    msk = np.zeros((n, cap), bool)
    for k in range(n):
        p1 = poses[min(k + 1, n - 1)]
        pts = render_scan_skewed(world, poses[k], p1, cfg, noise=noise,
                                 rng=rng, groups=groups)
        good = np.isfinite(pts).all(-1)
        pts = pts[good][:cap]
        out[k, : len(pts)] = pts
        msk[k, : len(pts)] = True
    return out, msk


def imu_stream(poses: np.ndarray, scan_period: float, hz: float = 40.0,
               rpy_noise: float = 0.0, acc_noise: float = 0.0, seed: int = 0):
    """An IMU stream along ``poses`` (frame k at ``k * scan_period``) as a
    body-mounted unit records it, after benchmarks/validate_simlidar.py's
    ``synth_imu``: orientation (roll, pitch, yaw; yaw wrapped to (-pi, pi]
    as a quaternion source gives it) and body-frame specific force including
    gravity, plus Gaussian noise of the given sigmas (rad, m/s^2) from
    ``seed``.  Between frames the pose is interpolated as
    :func:`render_scan_skewed` sweeps it (translation lerp, yaw slerp), and
    the stream runs to the end of the last frame's sweep (which holds the
    last pose).  Returns [(t, rpy [3], acc [3]), ...]."""
    n = poses.shape[0]
    dt = 1.0 / hz
    t = np.arange(int(round(n * scan_period * hz)) + 1) * dt
    pos = np.zeros((len(t), 3))
    yaw = np.zeros(len(t))
    for i, ti in enumerate(t):
        k = min(int(np.floor(ti / scan_period + 1e-9)), n - 1)
        a = min(ti / scan_period - k, 1.0)
        T = _interp_pose(poses[k], poses[min(k + 1, n - 1)], a)
        pos[i] = T[:3, 3]
        yaw[i] = np.arctan2(T[1, 0], T[0, 0])
    yaw = np.unwrap(yaw)
    acc_w = np.gradient(np.gradient(pos, dt, axis=0), dt, axis=0)
    rng = np.random.default_rng(seed)
    out = []
    for i in range(len(t)):
        cy, sy = np.cos(yaw[i]), np.sin(yaw[i])
        Rz = np.array([[cy, -sy, 0.0], [sy, cy, 0.0], [0.0, 0.0, 1.0]])
        acc_b = Rz.T @ acc_w[i] + [0.0, 0.0, 9.81] + rng.normal(0, acc_noise, 3)
        rpy = np.array([0.0, 0.0, yaw[i]]) + rng.normal(0, rpy_noise, 3)
        rpy[2] = (rpy[2] + np.pi) % (2 * np.pi) - np.pi
        out.append((float(t[i]), rpy, acc_b))
    return out


def render_sequence(world: World, poses: np.ndarray, cfg: PipelineConfig,
                    noise: float = 0.0, seed: int = 0):
    """Render all frames; returns (points [N, P, 3], mask [N, P]) padded arrays."""
    rng = np.random.default_rng(seed)
    cap = cfg.max_raw_points
    n = poses.shape[0]
    out = np.zeros((n, cap, 3), np.float32)
    msk = np.zeros((n, cap), bool)
    for k in range(n):
        pts = render_scan(world, poses[k], cfg, noise=noise, rng=rng)
        good = np.isfinite(pts).all(-1)
        pts = pts[good][:cap]
        out[k, : len(pts)] = pts
        msk[k, : len(pts)] = True
    return out, msk


def circuit_graph(N: int, count: int, n_loops: int, loop_cap: int, seed: int = 0,
                  noise: float = 0.01, loop_stride: int = 7):
    """A noisy multi-lap circuit pose graph (tests/test_schur.py's
    ``_make_graph``): ``count`` poses of capacity ``N`` on a circle of
    count // 3 unit steps, chain measurements perturbed by uniform noise in
    [-noise, noise] on each twist coordinate and chained into drifting
    estimates, and ``n_loops`` exact loop factors (weight 25) one lap apart.
    Returns (the port's ``PoseGraph`` on the CPU, ground-truth poses
    [count, 4, 4])."""
    import torch
    from ..models import pose_graph as pg
    from ..ops import se3

    rng = np.random.default_rng(seed)
    lap = max(count // 3, 4)
    step = se3.params_to_mat(torch.tensor([1.0, 0, 0, 0, 0, 2 * np.pi / lap])).numpy()
    truth = np.zeros((count, 4, 4), np.float32)
    cur = np.eye(4, dtype=np.float32)
    for k in range(count):
        truth[k] = cur
        cur = (cur @ step).astype(np.float32)
    rels, noisy = np.zeros_like(truth), truth.copy()
    rels[0] = truth[0]
    cur = truth[0]
    for k in range(1, count):
        d = torch.from_numpy(rng.uniform(-noise, noise, 6).astype(np.float32))
        rels[k] = (step @ se3.se3_exp(d).numpy()).astype(np.float32)
        cur = (cur @ rels[k]).astype(np.float32)
        noisy[k] = cur
    g = pg.init_graph(N, loop_cap, "cpu")
    g.poses[:count] = torch.from_numpy(noisy)
    g.chain_rel[:count] = torch.from_numpy(rels)
    g = g._replace(count=torch.tensor(count, dtype=torch.int32))
    for l in range(n_loops):
        i = lap + (l * loop_stride) % max(count - lap - 1, 1)
        rel = np.linalg.inv(truth[i]) @ truth[i - lap]
        g = pg.add_loop_factor(g, torch.tensor(i, dtype=torch.int32),
                               torch.tensor(i - lap, dtype=torch.int32),
                               torch.from_numpy(rel.astype(np.float32)), torch.tensor(25.0))
    return g, truth
