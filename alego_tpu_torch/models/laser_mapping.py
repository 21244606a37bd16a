"""Scan-to-map matching and keyframe management, the part of
``alego_tpu.models.laser_mapping`` that the frame step runs.

* the local map is the voxel-merged window of the last
  ``recent_keyframe_search_num`` keyframes (LM.cpp:351-388, the
  loop-closure mode), rebuilt only when a keyframe was added;
* scan2MapOptimization (LM.cpp:493-624): 2 outer association passes, 5-NN
  (the fused k-NN kernel on the GPU) with the 1 m gate, PCA line test
  (l2 > 3 l1), plane fit with 0.2 m validity, then full-6DoF GN with
  Huber(0.1) and the degeneracy projector;
* keyframe saves (LM.cpp:636-704) are masked in-place row writes into the
  preallocated store: the ~100 MiB keyframe arrays are never copied.  The
  state passed in is therefore updated in place.

Not ported yet: loop closure and keyframe compaction, and the
radius-mode local map used when ``loop_closure_enabled=False``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import PipelineConfig
from ..ops import se3
from ..ops.knn import knn_best as knn
from ..ops.voxel import voxel_downsample, voxel_downsample_exact
from ..ops.eig3 import pca_line_fit, plane_fit
from ..ops.residuals import point_to_line, point_to_plane_fitted
from ..ops.gauss_newton import solve_gn, dims, FULL_DIMS
from . import pose_graph as pg


class MappingState(NamedTuple):
    graph: pg.PoseGraph
    kf_times: torch.Tensor        # [MAX_KF]
    kf_corner: torch.Tensor       # [MAX_KF, KC, 3] (laser frame)
    kf_corner_valid: torch.Tensor
    kf_surf: torch.Tensor         # [MAX_KF, KS, 3]
    kf_surf_valid: torch.Tensor
    kf_outlier: torch.Tensor      # [MAX_KF, KO, 3]
    kf_outlier_valid: torch.Tensor
    T_map2odom: torch.Tensor      # [4, 4]
    T_map2laser: torch.Tensor     # [4, 4]
    last_loop_kf: torch.Tensor    # int32 (loop closure, not ported yet)
    loop_attempts: torch.Tensor   # int32
    loop_best_fitness: torch.Tensor
    loop_best_inlier: torch.Tensor
    map_corner: torch.Tensor      # [map_corner_cap, 3] cached local map
    map_corner_valid: torch.Tensor
    map_surf: torch.Tensor        # [map_surf_cap, 3]
    map_surf_valid: torch.Tensor
    map_dirty: torch.Tensor       # bool


def init_state(cfg: PipelineConfig, device, dtype=torch.float32) -> MappingState:
    M = cfg.max_keyframes
    assert M >= cfg.recent_keyframe_search_num, (
        "max_keyframes must cover the recent-keyframe window "
        f"({M} < {cfg.recent_keyframe_search_num})")

    def z(*shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=device)

    eye = torch.eye(4, dtype=dtype, device=device)
    return MappingState(
        graph=pg.init_graph(M, cfg.max_loop_factors, device, dtype),
        kf_times=z(M),
        kf_corner=z(M, cfg.kf_corner_cap, 3),
        kf_corner_valid=z(M, cfg.kf_corner_cap, dt=torch.bool),
        kf_surf=z(M, cfg.kf_surf_cap, 3),
        kf_surf_valid=z(M, cfg.kf_surf_cap, dt=torch.bool),
        kf_outlier=z(M, cfg.kf_outlier_cap, 3),
        kf_outlier_valid=z(M, cfg.kf_outlier_cap, dt=torch.bool),
        T_map2odom=eye.clone(), T_map2laser=eye.clone(),
        last_loop_kf=torch.full((), -1, dtype=torch.int32, device=device),
        loop_attempts=z(dt=torch.int32),
        loop_best_fitness=torch.full((), float("inf"), dtype=dtype, device=device),
        loop_best_inlier=z(),
        map_corner=z(cfg.map_corner_cap, 3),
        map_corner_valid=z(cfg.map_corner_cap, dt=torch.bool),
        map_surf=z(cfg.map_surf_cap, 3),
        map_surf_valid=z(cfg.map_surf_cap, dt=torch.bool),
        map_dirty=z(dt=torch.bool),
    )


def _transform_kf_clouds(poses, pts, valid):
    """Batch-transform [K, cap, 3] clouds by [K, 4, 4] poses."""
    out = torch.einsum("kij,kpj->kpi", poses[:, :3, :3], pts) + poses[:, None, :3, 3]
    return torch.where(valid[..., None], out, 0.0)


def _build_local_map(ms: MappingState, cfg: PipelineConfig):
    """Local feature map of the last ``recent_keyframe_search_num``
    keyframes, voxel-merged (LM.cpp:351-388).  The window's start lives on
    the device, so its rows are gathered by index (a slice would need the
    start on the host)."""
    if not cfg.loop_closure_enabled:
        raise NotImplementedError(
            "the radius-mode local map (loop_closure_enabled=False) is not "
            "ported yet")
    K = cfg.recent_keyframe_search_num
    count = ms.graph.count.long()
    start = torch.clamp(count - K, 0, cfg.max_keyframes - K)
    raw_idx = torch.arange(K, device=count.device) + start
    kf_ok = (raw_idx < count) & (count > 0)

    poses = ms.graph.poses[raw_idx]
    c_valid = ms.kf_corner_valid[raw_idx] & kf_ok[:, None]
    s_valid = ms.kf_surf_valid[raw_idx] & kf_ok[:, None]
    o_valid = ms.kf_outlier_valid[raw_idx] & kf_ok[:, None]
    c_pts = _transform_kf_clouds(poses, ms.kf_corner[raw_idx], c_valid)
    s_pts = _transform_kf_clouds(poses, ms.kf_surf[raw_idx], s_valid)
    o_pts = _transform_kf_clouds(poses, ms.kf_outlier[raw_idx], o_valid)

    map_corner, map_corner_valid = voxel_downsample(
        c_pts.reshape(-1, 3), c_valid.reshape(-1), cfg.corner_leaf,
        cfg.map_corner_cap)
    # the surf map includes the outliers (LM.cpp:385-387)
    surf_all = torch.cat([s_pts.reshape(-1, 3), o_pts.reshape(-1, 3)], 0)
    surf_all_valid = torch.cat([s_valid.reshape(-1), o_valid.reshape(-1)], 0)
    map_surf, map_surf_valid = voxel_downsample(
        surf_all, surf_all_valid, cfg.surf_leaf, cfg.map_surf_cap)
    return map_corner, map_corner_valid, map_surf, map_surf_valid


def _downsample_scan(corner_pts, corner_valid, surf_pts, surf_valid,
                     outlier_pts, outlier_valid, cfg: PipelineConfig):
    """downsampleCurrentScan (LM.cpp:470-491)."""
    c_ds, c_ok = voxel_downsample_exact(corner_pts, corner_valid,
                                        cfg.corner_leaf, cfg.kf_corner_cap)
    s_ds, s_ok = voxel_downsample_exact(surf_pts, surf_valid, cfg.surf_leaf,
                                        cfg.kf_surf_cap)
    o_ds, o_ok = voxel_downsample_exact(outlier_pts, outlier_valid,
                                        cfg.outlier_leaf, cfg.kf_outlier_cap)
    st_ds, st_ok = voxel_downsample_exact(
        torch.cat([s_ds, o_ds], 0), torch.cat([s_ok, o_ok], 0),
        cfg.surf_leaf, cfg.kf_surf_cap + cfg.kf_outlier_cap)
    return c_ds, c_ok, s_ds, s_ok, o_ds, o_ok, st_ds, st_ok


def _scan_to_map(params0, c_ds, c_ok, st_ds, st_ok,
                 map_c, map_c_ok, map_s, map_s_ok, cfg: PipelineConfig):
    """scan2MapOptimization (LM.cpp:493-624): association + full-6DoF GN."""
    K = cfg.map_knn
    enough = ((torch.sum(c_ok) >= cfg.min_corner_for_map)
              & (torch.sum(st_ok) >= cfg.min_surf_for_map)
              & (torch.sum(map_c_ok) >= cfg.min_corner_for_map))
    full = dims(FULL_DIMS, params0)
    params = params0
    for _ in range(cfg.map_outer_iters):
        # corner: 5-NN + PCA line test (LM.cpp:516-562)
        sel_c = se3.transform_points(params, c_ds)
        d_c, i_c = knn(sel_c, c_ok, map_c, map_c_ok, K)
        nbrs = map_c[i_c.long()]
        near_c = c_ok & (d_c[:, K - 1] < cfg.map_nn_max_dist_sq)
        center, direction, ev = pca_line_fit(nbrs, torch.ones_like(d_c, dtype=torch.bool))
        is_line = ev[:, 2] > cfg.line_eig_ratio * ev[:, 1]
        pj = center + 0.1 * direction
        pl = center - 0.1 * direction
        w_line = (near_c & is_line).to(params.dtype)

        # surf: 5-NN + plane fit (LM.cpp:564-607)
        sel_s = se3.transform_points(params, st_ds)
        d_s, i_s = knn(sel_s, st_ok, map_s, map_s_ok, K)
        nbrs_s = map_s[i_s.long()]
        near_s = st_ok & (d_s[:, K - 1] < cfg.map_nn_max_dist_sq)
        unit_n, d0, plane_ok = plane_fit(nbrs_s, torch.ones_like(d_s, dtype=torch.bool),
                                         cfg.plane_fit_tol)
        w_plane = (near_s & plane_ok).to(params.dtype)

        def res_fn(p, pj=pj, pl=pl, unit_n=unit_n, d0=d0,
                   w=torch.cat([w_line, w_plane])):
            r_c, J_c = point_to_line(p, c_ds, pj, pl)
            r_s, J_s = point_to_plane_fitted(p, st_ds, unit_n, d0)
            return torch.cat([r_c, r_s]), torch.cat([J_c, J_s]), w

        params = solve_gn(res_fn, params, cfg.map_gn_iters, full,
                          cfg.huber_delta, param_tol=cfg.map_gn_tol,
                          eig_floor=cfg.map_eig_floor)
    return torch.where(enough, params, params0)


def _write_row(store: torch.Tensor, k: torch.Tensor, write: torch.Tensor,
               value: torch.Tensor):
    """store[k] = value where ``write``, else store[k] (in place)."""
    store.index_copy_(0, k, torch.where(write, value, store[k][0])[None])


def mapping_step(ms: MappingState, T_odom2laser: torch.Tensor,
                 corner_pts, corner_valid, surf_pts, surf_valid,
                 outlier_pts, outlier_valid, time: torch.Tensor,
                 cfg: PipelineConfig):
    """One mapping frame. Returns (new_state, T_map2laser).  The keyframe
    store of ``ms`` is written in place."""
    T_pred = ms.T_map2odom @ T_odom2laser

    # the cached local map is rebuilt only after a keyframe was added: one
    # flag read per mapping frame decides it on the host
    if bool(ms.map_dirty):
        mc, mco, msf, msfo = _build_local_map(ms, cfg)
        ms = ms._replace(map_corner=mc, map_corner_valid=mco,
                         map_surf=msf, map_surf_valid=msfo)
    ms = ms._replace(map_dirty=torch.zeros_like(ms.map_dirty))
    c_ds, c_ok, s_ds, s_ok, o_ds, o_ok, st_ds, st_ok = _downsample_scan(
        corner_pts, corner_valid, surf_pts, surf_valid,
        outlier_pts, outlier_valid, cfg)

    params0 = se3.mat_to_params(T_pred)
    params = torch.where(
        ms.graph.count > 0,
        _scan_to_map(params0, c_ds, c_ok, st_ds, st_ok, ms.map_corner,
                     ms.map_corner_valid, ms.map_surf, ms.map_surf_valid, cfg),
        params0)
    T_new = se3.params_to_mat(params)

    # saveKeyFramesAndFactor (LM.cpp:636-704); squared-distance gate quirk kept
    count = ms.graph.count
    last_t = ms.graph.poses[torch.clamp(count - 1, min=0).long()][:3, 3]
    moved = torch.sum((T_new[:3, 3] - last_t) ** 2) >= cfg.min_keyframe_dist_sq
    is_kf = (count == 0) | moved
    write = is_kf & ~(count >= cfg.max_keyframes)
    k = torch.clamp(count, max=cfg.max_keyframes - 1).long().reshape(1)

    _write_row(ms.kf_times, k, write, time.to(ms.kf_times.dtype))
    _write_row(ms.kf_corner, k, write, c_ds)
    _write_row(ms.kf_corner_valid, k, write, c_ok)
    _write_row(ms.kf_surf, k, write, s_ds)
    _write_row(ms.kf_surf_valid, k, write, s_ok)
    _write_row(ms.kf_outlier, k, write, o_ds)
    _write_row(ms.kf_outlier_valid, k, write, o_ok)
    ms = ms._replace(graph=pg.add_keyframe(ms.graph, T_new, do=is_kf),
                     map_dirty=ms.map_dirty | write)

    # transformUpdate (LM.cpp:626-634)
    T_map2odom = T_new @ se3.inv_mat(T_odom2laser)
    return ms._replace(T_map2odom=T_map2odom, T_map2laser=T_new), T_new
