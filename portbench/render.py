"""The benchmark's scans, rendered on the device: a torch copy of the
port's synthetic world and raycaster (``alego_tpu_torch/utils/synthetic.py``),
so a run's set-up does not raycast on the host.

The world (a ground plane, axis-aligned boxes, vertical cylinders) is made
on the host from a NumPy generator, as the original makes it: it is a few
dozen numbers.  The trajectories are closed circuits and open arcs.  The
raycast runs in float64 on the device in batches of frames; the range noise
comes from a ``torch.Generator`` on the device.  Each scan leaves as the
original's: the hits in firing order (column-major), float32, front-packed
into ``max_raw_points`` rows with a validity mask.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch


@dataclasses.dataclass
class World:
    boxes: np.ndarray       # [B, 6] xmin ymin zmin xmax ymax zmax
    cylinders: np.ndarray   # [C, 4] cx cy radius top-z
    ground_z: float = -1.5


def _pusher(clear_path: np.ndarray, margin: float):
    def clear(cx, cy, half_size):
        dist = np.hypot(clear_path[:, 0] - cx, clear_path[:, 1] - cy)
        d, need = dist.min(), margin + half_size
        if d < need:
            k = np.argmin(dist)
            vx, vy = cx - clear_path[k, 0], cy - clear_path[k, 1]
            n = np.hypot(vx, vy) or 1.0
            cx += vx / n * (need - d + 1.0)
            cy += vy / n * (need - d + 1.0)
        return cx, cy
    return clear


def make_world(seed: int = 0, n_boxes: int = 14, n_cyl: int = 12,
               extent: float = 60.0, ground_z: float = -1.5,
               clear_path: Optional[np.ndarray] = None,
               clear_margin: float = 6.0) -> World:
    """The original's square world: primitives uniform over
    [-extent, extent]^2, pushed off ``clear_path``, four perimeter walls."""
    rng = np.random.default_rng(seed)
    clear = _pusher(np.zeros((1, 2)) if clear_path is None else clear_path, clear_margin)
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
        cyls.append([cx, cy, rng.uniform(0.1, 0.4), ground_z + rng.uniform(3.0, 7.0)])
    E, t = extent + 8.0, 0.5
    walls = [[-E, -E, ground_z, E, -E + t, ground_z + 4.0],
             [-E, E - t, ground_z, E, E, ground_z + 4.0],
             [-E, -E, ground_z, -E + t, E, ground_z + 4.0],
             [E - t, -E, ground_z, E, E, ground_z + 4.0]]
    return World(np.array(boxes + walls, np.float64), np.array(cyls, np.float64), ground_z)


def make_corridor_world(path_xy: np.ndarray, seed: int, n_boxes: int, n_cyl: int,
                        half_width: float, ground_z: float = -1.5,
                        clear_margin: float = 6.0) -> World:
    """Boxes and cylinders of the square world's sizes scattered along a
    path: each at a uniform point of the path, offset sideways uniformly in
    [-half_width, half_width], then pushed off the path.  No walls."""
    rng = np.random.default_rng(seed)
    clear = _pusher(path_xy, clear_margin)

    def spot():
        k = rng.integers(0, len(path_xy))
        j = min(k + 1, len(path_xy) - 1)
        tx, ty = path_xy[j] - path_xy[max(j - 1, 0)]
        n = np.hypot(tx, ty) or 1.0
        off = rng.uniform(-half_width, half_width)
        return path_xy[k, 0] - ty / n * off, path_xy[k, 1] + tx / n * off

    boxes = []
    for _ in range(n_boxes):
        cx, cy = spot()
        w, d = rng.uniform(2.0, 10.0, 2)
        cx, cy = clear(cx, cy, max(w, d) / 2)
        h = rng.uniform(2.0, 6.0)
        boxes.append([cx - w / 2, cy - d / 2, ground_z, cx + w / 2, cy + d / 2, ground_z + h])
    cyls = []
    for _ in range(n_cyl):
        cx, cy = spot()
        cx, cy = clear(cx, cy, 0.5)
        cyls.append([cx, cy, rng.uniform(0.1, 0.4), ground_z + rng.uniform(3.0, 7.0)])
    return World(np.array(boxes, np.float64).reshape(-1, 6),
                 np.array(cyls, np.float64).reshape(-1, 4), ground_z)


def _rot_z(yaw: np.ndarray) -> np.ndarray:
    c, s = np.cos(yaw), np.sin(yaw)
    R = np.zeros(yaw.shape + (3, 3))
    R[..., 0, 0], R[..., 0, 1], R[..., 1, 0], R[..., 1, 1] = c, -s, s, c
    R[..., 2, 2] = 1.0
    return R


def circuit(radius: float, frames_per_lap: int, laps: int) -> np.ndarray:
    """Ground-truth poses of ``laps`` laps of the closed circle of the
    original's ``loop_trajectory`` (frames_per_lap poses, the last on the
    first): each later lap skips its repeated start.  [n, 4, 4]."""
    a = np.linspace(0, 2 * np.pi, frames_per_lap, endpoint=True)
    a = np.concatenate([a] + [a[1:]] * (laps - 1))
    return _arc_poses(radius, a)


def arc(radius: float, frames: int, step_m: float) -> np.ndarray:
    """An open arc of the circle, ``step_m`` metres a frame (the original's
    ``loop_trajectory(closed=False)``).  [n, 4, 4]."""
    a = np.linspace(0, step_m * frames / radius, frames, endpoint=False)
    return _arc_poses(radius, a)


def _arc_poses(radius: float, a: np.ndarray) -> np.ndarray:
    T = np.tile(np.eye(4), (len(a), 1, 1))
    T[:, :3, :3] = _rot_z(a)
    T[:, 0, 3] = radius * np.sin(a)
    T[:, 1, 3] = radius * (1 - np.cos(a))
    return T


def ray_directions(cfg) -> np.ndarray:
    """[R, H, 3] unit rays in the sensor frame, at ring elevations the
    projector inverts and column centres (the original's)."""
    if int(cfg.laser_type) == 1:    # RFANS_16M band centres
        elev_deg = np.array([-15.0, -12.0, -9.5, -8.0, -6.0, -5.0, -4.0, -3.0, -2.0,
                             -1.0, 0.0, 1.0, 3.0, 5.0, 8.0, 11.0], np.float64)
        if elev_deg.shape[0] != cfg.n_scan:
            raise ValueError("RFANS_16M has 16 rings")
    else:
        elev_deg = np.arange(cfg.n_scan) * cfg.ang_res_y_deg - cfg.ang_bottom_deg
    elev = np.radians(elev_deg)
    az = -(np.arange(cfg.horizon_scan) + 0.5) * np.radians(cfg.ang_res_x_deg)
    ce, se = np.cos(elev)[:, None], np.sin(elev)[:, None]
    ca, sa = np.cos(az)[None, :], np.sin(az)[None, :]
    return np.stack([ce * ca, ce * sa, np.broadcast_to(se, (cfg.n_scan, cfg.horizon_scan))], -1)


def _ranges(world: World, origin: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """Nearest positive hit per ray [F, R, H] (inf for none): ground,
    boxes by slabs, cylinders by the quadratic, as the original."""
    dz = dirs[..., 2]
    oz = origin[:, 2, None, None]
    t = torch.where(dz < -1e-9, (world.ground_z - oz) / torch.where(dz == 0, 1.0, dz), torch.inf)
    t = torch.where(t > 0, t, torch.inf)
    inv = 1.0 / torch.where(torch.abs(dirs) < 1e-12, 1e-12, dirs)
    o = origin[:, None, None, :]
    for b in torch.as_tensor(world.boxes, device=dirs.device):
        lo, hi = (b[:3] - o) * inv, (b[3:] - o) * inv
        tmin = torch.minimum(lo, hi).amax(-1)
        tmax = torch.maximum(lo, hi).amin(-1)
        hit = (tmax >= tmin) & (tmax > 0)
        t = torch.minimum(t, torch.where(hit, torch.where(tmin > 0, tmin, torch.inf), torch.inf))
    dx, dy = dirs[..., 0], dirs[..., 1]
    a = dx * dx + dy * dy
    for c in torch.as_tensor(world.cylinders, device=dirs.device):
        ox = origin[:, 0, None, None] - c[0]
        oy = origin[:, 1, None, None] - c[1]
        b = 2 * (ox * dx + oy * dy)
        cc = ox * ox + oy * oy - c[2] * c[2]
        disc = b * b - 4 * a * cc
        ok = (disc > 0) & (a > 1e-12)
        sq = torch.sqrt(torch.clamp(disc, min=0))
        tc = (-b - sq) / torch.where(a == 0, 1.0, 2 * a)
        z = oz + tc * dirs[..., 2]
        ok &= (tc > 0) & (z > world.ground_z) & (z < c[3])
        t = torch.minimum(t, torch.where(ok, tc, torch.inf))
    return t


def render(world: World, poses: np.ndarray, cfg, noise: float, seed: int,
           device, batch: int = 32, max_range: float = 120.0):
    """All frames of ``poses`` on ``device``: (points [n, P, 3] float32,
    mask [n, P] bool) as NumPy arrays on the host, P = cfg.max_raw_points."""
    dev = torch.device(device)
    dirs_s = torch.as_tensor(ray_directions(cfg), device=dev)
    R, H = dirs_s.shape[:2]
    cap, n = cfg.max_raw_points, poses.shape[0]
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed % 2 ** 63)
    out_pts = np.zeros((n, cap, 3), np.float32)
    out_msk = np.zeros((n, cap), bool)
    P = torch.as_tensor(poses, device=dev)
    for f0 in range(0, n, batch):
        T = P[f0:f0 + batch]
        F = T.shape[0]
        Rw = T[:, :3, :3]
        dirs_w = torch.einsum("rhj,fij->frhi", dirs_s, Rw)
        t = _ranges(world, T[:, :3, 3], dirs_w)
        if noise > 0:
            t = t + noise * torch.randn(t.shape, generator=gen, device=dev, dtype=t.dtype)
        hit = torch.isfinite(t) & (t < max_range) & (t > cfg.min_range)
        pts = (dirs_s[None] * torch.where(hit, t, 0.0)[..., None]).to(torch.float32)
        # firing order: all rings of column 0, then column 1, ...
        pts = pts.transpose(1, 2).reshape(F, H * R, 3)
        hit = hit.transpose(1, 2).reshape(F, H * R)
        slot = torch.cumsum(hit, 1) - 1
        keep = hit & (slot < cap)
        rows = torch.arange(F, device=dev)[:, None].expand(F, H * R)
        packed = torch.zeros((F, cap, 3), dtype=torch.float32, device=dev)
        packed[rows[keep], slot[keep]] = pts[keep]
        valid = torch.zeros((F, cap), dtype=torch.bool, device=dev)
        valid[rows[keep], slot[keep]] = True
        out_pts[f0:f0 + F] = packed.cpu().numpy()
        out_msk[f0:f0 + F] = valid.cpu().numpy()
    return out_pts, out_msk
