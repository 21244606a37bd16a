"""Scan-to-scan odometry (stage-2 back half), the port of
``alego_tpu.models.laser_odometry``.

The reference's two-step structure (LO.cpp:387-625): surf residuals solve z
first, then corners are associated at the updated pose and solved jointly
with the surf blocks (x, y, z, yaw); the whole two-step runs
``odom_outer_iters`` times with re-association; pose integration is
yaw-only (LO.cpp:579-583).  The nearest-neighbour searches are the fused
1-NN (the CUDA kernel on the GPU).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import PipelineConfig
from ..ops import se3
from ..ops.features import FeatureClouds
from ..ops.knn import nn1_best as nn1, masked_argmin_dist
from ..ops.residuals import LINE, PLANE_3PT, correspondence_rows, join_correspondences
from ..ops.gauss_newton import (solve_correspondences, dims, SURF_DIMS, STEP_B_DIMS,
                                CORNER_DIMS)


class OdometryState(NamedTuple):
    params: torch.Tensor         # [6] frame-to-frame warm start (LO.cpp:64)
    t_w: torch.Tensor            # [3] world position
    R_w: torch.Tensor            # [3, 3] world rotation
    initialized: torch.Tensor    # bool scalar
    surf_pts: torch.Tensor       # [MLF, 3] previous less-flat
    surf_valid: torch.Tensor
    surf_ring: torch.Tensor
    corner_pts: torch.Tensor     # [MLS, 3] previous less-sharp
    corner_valid: torch.Tensor
    corner_ring: torch.Tensor


def init_state(cfg: PipelineConfig, device, dtype=torch.float32) -> OdometryState:
    def z(*shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=device)
    return OdometryState(
        params=z(6), t_w=z(3),
        R_w=torch.eye(3, dtype=dtype, device=device),
        initialized=z(dt=torch.bool),
        surf_pts=z(cfg.max_less_flat, 3),
        surf_valid=z(cfg.max_less_flat, dt=torch.bool),
        surf_ring=z(cfg.max_less_flat, dt=torch.int32),
        corner_pts=z(cfg.max_less_sharp, 3),
        corner_valid=z(cfg.max_less_sharp, dt=torch.bool),
        corner_ring=z(cfg.max_less_sharp, dt=torch.int32),
    )


def _associate_surf(params, fc: FeatureClouds, st: OdometryState,
                    cfg: PipelineConfig):
    """Surf correspondences (LO.cpp:408-478): nearest + same-ring second +
    nearby-ring third point, all within sqrt(25) m."""
    sel = se3.transform_points(params, fc.flat_pts)
    d1, i1 = nn1(sel, fc.flat_valid, st.surf_pts, st.surf_valid)
    i1 = i1.long()
    ok1 = fc.flat_valid & (d1 < cfg.nearest_feature_dist_sq)
    cs = st.surf_ring[i1][:, None]                     # closest ring per query

    ring = st.surf_ring[None, :]
    validN = st.surf_valid[None, :]
    cols = torch.arange(st.surf_pts.shape[0], device=sel.device)
    not_closest = cols[None, :] != i1[:, None]
    same_ring = validN & (ring == cs) & not_closest
    near_ring = validN & (ring != cs) & (torch.abs(ring - cs) <= cfg.ring_search_span)

    d2, i2 = masked_argmin_dist(sel, st.surf_pts, same_ring)
    d3, i3 = masked_argmin_dist(sel, st.surf_pts, near_ring)
    ok = (ok1 & (d2 < cfg.nearest_feature_dist_sq)
          & (d3 < cfg.nearest_feature_dist_sq))
    return (fc.flat_pts, st.surf_pts[i1], st.surf_pts[i2.long()],
            st.surf_pts[i3.long()], ok.to(sel.dtype))


def _associate_corner(params, fc: FeatureClouds, st: OdometryState,
                      cfg: PipelineConfig):
    """Corner correspondences (LO.cpp:498-552): nearest + best point on a
    different nearby ring (the edge must span rings)."""
    if cfg.odom_dense_corners:
        q_pts, q_valid = fc.less_sharp_pts, fc.less_sharp_valid
    else:
        q_pts, q_valid = fc.sharp_pts, fc.sharp_valid
    sel = se3.transform_points(params, q_pts)
    d1, i1 = nn1(sel, q_valid, st.corner_pts, st.corner_valid)
    i1 = i1.long()
    ok1 = q_valid & (d1 < cfg.nearest_feature_dist_sq)
    cs = st.corner_ring[i1][:, None]
    ring = st.corner_ring[None, :]
    diff_ring = st.corner_valid[None, :] & (ring != cs) & (
        torch.abs(ring - cs) <= cfg.ring_search_span)
    d2, i2 = masked_argmin_dist(sel, st.corner_pts, diff_ring)
    ok = ok1 & (d2 < cfg.nearest_feature_dist_sq)
    return q_pts, st.corner_pts[i1], st.corner_pts[i2.long()], ok.to(sel.dtype)


def odometry_step(st: OdometryState, fc: FeatureClouds, cfg: PipelineConfig):
    """One odometry frame. Returns (new_state, pose 4x4 world).  Each of the
    ``2 * odom_outer_iters`` solves is one :func:`solve_correspondences`
    (one ``gn`` kernel launch on the GPU)."""
    surf_dims = dims(SURF_DIMS, st.params)
    step_b_dims = dims(STEP_B_DIMS, st.params)
    # step B's column masks by row kind: corner rows x, y, yaw; surf rows z
    # (utility.h:162-167, 224-232); no kind-2 rows
    kind_cols = torch.stack([dims(CORNER_DIMS, st.params), surf_dims,
                             surf_dims]).to(st.params.dtype)
    solve = dict(min_count=cfg.min_correspondences, eig_floor=cfg.odom_eig_floor,
                 prior_weight=cfg.odom_prior_weight)

    def two_step(params):
        # step A: surf association + z-only solve (LO.cpp:408-492)
        s_cp, s_pj, s_pl, s_pm, s_w = _associate_surf(params, fc, st, cfg)
        surf = correspondence_rows(PLANE_3PT, s_cp, s_w, pj=s_pj, pl=s_pl, pm=s_pm)
        params_a = solve_correspondences(join_correspondences(surf), params,
                                         cfg.odom_surf_iters, surf_dims,
                                         cfg.huber_delta, **solve)

        # step B: corner association at the updated pose + joint solve, the
        # surf rows then the corner rows
        c_cp, c_pj, c_pl, c_w = _associate_corner(params_a, fc, st, cfg)
        enough_corners = torch.sum(c_w > 0) >= cfg.min_correspondences
        corner = correspondence_rows(LINE, c_cp, c_w * enough_corners.to(c_w.dtype),
                                     pj=c_pj, pl=c_pl)
        params_b = solve_correspondences(join_correspondences(surf, corner), params_a,
                                         cfg.odom_corner_iters, step_b_dims,
                                         cfg.huber_delta, kind_cols=kind_cols, **solve)
        # too few corners: the reference skips the second solve (LO.cpp:556-574)
        return torch.where(enough_corners, params_b, params_a)

    params_b = st.params
    for _ in range(max(cfg.odom_outer_iters, 1)):
        params_b = two_step(params_b)

    # first frame: no previous features -> keep params
    params_new = torch.where(st.initialized, params_b, st.params)

    # pose integration: yaw-only rotation (LO.cpp:579-583)
    R_delta = se3.yaw_to_rot(params_new[5])
    t_w = torch.where(st.initialized, st.t_w + st.R_w @ params_new[:3], st.t_w)
    R_w = torch.where(st.initialized, st.R_w @ R_delta, st.R_w)

    pose = torch.eye(4, dtype=t_w.dtype, device=t_w.device)
    pose[:3, :3] = R_w
    pose[:3, 3] = t_w

    new_state = OdometryState(
        params=params_new, t_w=t_w, R_w=R_w,
        initialized=torch.ones_like(st.initialized),
        surf_pts=fc.less_flat_pts, surf_valid=fc.less_flat_valid,
        surf_ring=fc.less_flat_ring,
        corner_pts=fc.less_sharp_pts, corner_valid=fc.less_sharp_valid,
        corner_ring=fc.less_sharp_ring,
    )
    return new_state, pose
