# Frozen copy of alego_tpu_torch/ops/projection.py for the benchmark's reference: plain
# PyTorch only, its imports made local; see portbench/reference/__init__.py.
"""Range-image projection and ground removal (stage-1 front half), the port
of ``alego_tpu.ops.projection``.

The scan is a fixed-capacity masked point array; row/column binning is
vectorised (including the RFANS-16M piecewise vertical-angle table,
IP.cpp:138-177), and the scatter into the 16 x 4000 range image keeps the
LAST point in arrival order that lands on a pixel, the reference's rule
(IP.cpp:196-200).  CUDA's ``index_put_`` with duplicate indices has no
defined winner, so the winner is made explicit: a ``scatter_reduce("amax")``
of the arrival index picks it, and one gather reads its range and xyz.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .config import PipelineConfig, LaserType
from .device import at, const

RAD2DEG = 180.0 / math.pi
INVALID_RANGE = 1e9  # stands in for the reference's DBL_MAX empty-pixel marker


class RangeImage(NamedTuple):
    """Dense per-pixel scan representation, shapes [n_scan, horizon_scan]."""

    points: torch.Tensor   # [R, H, 3]
    ranges: torch.Tensor   # [R, H]; INVALID_RANGE where empty
    valid: torch.Tensor    # [R, H] bool
    ground: torch.Tensor   # [R, H] bool
    orient_start: torch.Tensor   # sweep start orientation (scalar)
    orient_diff: torch.Tensor    # end - start, (pi, 3pi]


def rfans_row_id(vert_deg: torch.Tensor) -> torch.Tensor:
    """Piecewise nonuniform vertical angle -> ring for RFANS_16M (IP.cpp:144-171)."""
    r_hi = torch.floor(13 + (vert_deg - 5.0) / const(3.0, vert_deg) + 0.5)
    r_mid = torch.floor(11 + (vert_deg - 1.0) / const(2.0, vert_deg) + 0.5)
    r_low = torch.floor(10.5 + vert_deg)
    c = torch.full_like
    row = torch.where(
        vert_deg > 4.5, r_hi,
        torch.where(
            vert_deg > 0.5, r_mid,
            torch.where(
                vert_deg > -7.0, r_low,
                torch.where(vert_deg > -8.5, c(vert_deg, 3.0),
                            torch.where(vert_deg > -10.5, c(vert_deg, 2.0),
                                        torch.where(vert_deg > -13.5,
                                                    c(vert_deg, 1.0),
                                                    c(vert_deg, 0.0)))))))
    return row.to(torch.int32)


def uniform_row_id(vert_deg: torch.Tensor, cfg: PipelineConfig) -> torch.Tensor:
    """Uniform ring formula for LSLIDAR_C16 (IP.cpp:140)."""
    return torch.floor((vert_deg + cfg.ang_bottom_deg)
                       / const(cfg.ang_res_y_deg, vert_deg) + 0.5).to(torch.int32)


def project_scan(points: torch.Tensor, mask: torch.Tensor,
                 cfg: PipelineConfig) -> RangeImage:
    """Project a masked point set [N, 3] onto the dense range image
    (IP.cpp:134-201, with the close-point filter of IP.cpp:117 as a mask)."""
    R, H = cfg.n_scan, cfg.horizon_scan
    dev = points.device
    x, y, z = points[..., 0], points[..., 1], points[..., 2]
    rng = torch.sqrt(x * x + y * y + z * z)
    mask = mask & (rng >= cfg.min_range) & torch.isfinite(rng)

    vert_deg = torch.atan2(z, torch.hypot(x, y)) * RAD2DEG
    if cfg.laser_type == LaserType.RFANS_16M:
        row = rfans_row_id(vert_deg)
    else:
        row = uniform_row_id(vert_deg, cfg)

    horizon_deg = (-torch.atan2(y, x) + 2 * math.pi) * RAD2DEG
    col = torch.floor(horizon_deg / const(cfg.ang_res_x_deg, horizon_deg)).to(torch.int32)
    col = torch.where(col >= H, col - H, col)

    ok = mask & (row >= 0) & (row < R) & (col >= 0) & (col < H)
    flat_idx = torch.where(ok, row * H + col, R * H).long()

    # sweep start/end orientation from the first/last point in ARRIVAL order
    # (IP.cpp:120-130)
    n = mask.shape[0]
    mask_i = mask.to(torch.int32)
    first = torch.argmax(mask_i)
    last = n - 1 - torch.argmax(mask_i.flip(0))
    start_ori = -torch.atan2(at(y, first), at(x, first))
    end_ori = -torch.atan2(at(y, last), at(x, last)) + 2 * math.pi
    d = end_ori - start_ori
    end_ori = torch.where(d > 3 * math.pi, end_ori - 2 * math.pi,
                          torch.where(d < math.pi, end_ori + 2 * math.pi, end_ori))
    any_pt = mask.any()
    orient_start = torch.where(any_pt, start_ori, torch.zeros_like(start_ori))
    orient_diff = torch.where(any_pt, end_ori - start_ori,
                              torch.full_like(start_ori, 2 * math.pi))

    # last-write-wins with an explicit winner: the largest arrival index per
    # pixel (the extra bin R*H collects the dropped points)
    arrival = torch.arange(n, device=dev)
    winner = torch.full((R * H + 1,), -1, dtype=torch.int64, device=dev)
    winner = winner.scatter_reduce(0, flat_idx, arrival, "amax")[: R * H]
    hit = winner >= 0
    w = winner.clamp(min=0)
    ranges_img = torch.where(hit, rng[w], INVALID_RANGE).reshape(R, H)
    valid = ranges_img < INVALID_RANGE * 0.5
    pts_img = torch.where(hit[:, None], points[w], 0.0).reshape(R, H, 3)

    ground = ground_mask(pts_img, valid, cfg)
    return RangeImage(points=pts_img, ranges=ranges_img, valid=valid,
                      ground=ground, orient_start=orient_start,
                      orient_diff=orient_diff)


def ground_mask(pts: torch.Tensor, valid: torch.Tensor,
                cfg: PipelineConfig) -> torch.Tensor:
    """Inter-ring slope test over the bottom rings (IP.cpp:203-228): pixels
    (i, j) and (i+1, j), i < ground_scan_id, are both ground when both are
    occupied and their difference vector is within 10 deg of the mount
    angle."""
    g = cfg.ground_scan_id
    ok = valid[:g] & valid[1: g + 1]
    d = pts[1: g + 1] - pts[:g]
    ang = torch.atan2(d[..., 2], torch.hypot(d[..., 0], d[..., 1])) * RAD2DEG
    hit = ok & (torch.abs(ang - cfg.sensor_mount_ang_deg) < cfg.ground_angle_thresh_deg)

    ground = torch.zeros_like(valid)
    ground[:g] = hit
    ground[1: g + 1] |= hit
    return ground & valid
