"""Scan-to-map matching, keyframe management and loop closure, the port of
``alego_tpu.models.laser_mapping``.

* the local map is the voxel-merged window of the last
  ``recent_keyframe_search_num`` keyframes (LM.cpp:351-388, the
  loop-closure mode), replaced only when a keyframe was added (built on
  every mapping frame and selected on the device); with
  ``loop_closure_enabled=False`` it is the K nearest keyframes within
  ``surround_keyframe_search_radius`` of the predicted pose (LM.cpp:390-458,
  the radius mode), rebuilt on every mapping frame;
* scan2MapOptimization (LM.cpp:493-624): 2 outer association passes, 5-NN
  (the fused k-NN kernel on the GPU) with the 1 m gate, PCA line test
  (l2 > 3 l1), plane fit with 0.2 m validity, then full-6DoF GN with
  Huber(0.1) and the degeneracy projector;
* keyframe saves (LM.cpp:636-704) are masked in-place row writes into the
  preallocated store: the ~100 MiB keyframe arrays are never copied.  The
  state passed in is therefore updated in place;
* loop closure (LM.cpp:779-975): drift-aware candidate search, ICP on the
  1-NN kernel from identity and, when that fails the gate, from a
  bird's-eye-view alignment, the structure-inlier acceptance gate on the
  k = 1 k-NN kernel, two consistency gates, and the factored pose-graph
  solve from two initialisations; ``compact_keyframes`` thins old keyframes
  near capacity.  The reference's ``lax.cond``s inside an attempt (the
  rescue, the solve) are predicated selects here: both branches run and
  the device picks, so an attempt reads nothing on the host and can be
  captured in a CUDA graph (``loop_graph``).  Only the attempt's own gate
  is read (``loop_closure_step``): a gated-off call launches nothing.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..config import PipelineConfig
from ..device import at, const, fixed_loop
from ..ops import se3
from ..ops.knn import knn_best as knn
from ..ops.voxel import voxel_downsample, voxel_downsample_exact, compact_masked
from ..ops.eig3 import pca_line_fit, plane_fit
from ..ops.residuals import LINE, PLANE_FITTED, correspondence_rows, join_correspondences
from ..ops.gauss_newton import solve_correspondences, dims, FULL_DIMS
from ..ops.icp import icp_point_to_point, ICPResult
from ..ops.bev_align import bev_align, _ground_z
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
    last_loop_kf: torch.Tensor    # int32 keyframe of the last loop attempt
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


def _build_local_map(ms: MappingState, cfg: PipelineConfig,
                     T_pred: torch.Tensor | None = None):
    """Local feature map, voxel-merged (LM.cpp:339-468).

    Loop-closure mode (default): the last ``recent_keyframe_search_num``
    keyframes (LM.cpp:351-388); the window's start lives on the device, so
    its rows are gathered by index (a slice would need the start on the
    host).  Radius mode (``loop_closure_enabled=False`` and ``T_pred``
    given): the K nearest keyframes within
    ``surround_keyframe_search_radius`` of the predicted pose
    (LM.cpp:390-458).  The reference selects them with ``lax.top_k``, which
    puts the lower index first on ties; a stable descending sort does the
    same (``torch.topk`` promises no order), and the voxel merge sees the
    keyframes in that order."""
    K = cfg.recent_keyframe_search_num
    count = ms.graph.count.long()
    if cfg.loop_closure_enabled or T_pred is None:
        start = torch.clamp(count - K, 0, cfg.max_keyframes - K)
        sel = torch.arange(K, device=count.device) + start
        kf_ok = (sel < count) & (count > 0)
    else:
        kp = ms.graph.poses[:, :3, 3]
        act = torch.arange(cfg.max_keyframes, device=count.device) < count
        d2 = torch.sum((kp - T_pred[:3, 3]) ** 2, -1)
        elig = act & (d2 < cfg.surround_keyframe_search_radius ** 2)
        score = torch.where(elig, -d2, -1e30)
        sel = torch.sort(score, descending=True, stable=True)[1][:K]
        kf_ok = elig[sel]

    poses = ms.graph.poses[sel]
    c_valid = ms.kf_corner_valid[sel] & kf_ok[:, None]
    s_valid = ms.kf_surf_valid[sel] & kf_ok[:, None]
    o_valid = ms.kf_outlier_valid[sel] & kf_ok[:, None]
    c_pts = _transform_kf_clouds(poses, ms.kf_corner[sel], c_valid)
    s_pts = _transform_kf_clouds(poses, ms.kf_surf[sel], s_valid)
    o_pts = _transform_kf_clouds(poses, ms.kf_outlier[sel], o_valid)

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


def _local_assoc(sel, ok, map_pts, map_ok, k: int):
    """The single-device 5-NN association: (d2 [Q, k], neighbours [Q, k, 3])
    from the k-NN kernel and a gather of the local map."""
    d, i = knn(sel, ok, map_pts, map_ok, k)
    return d, map_pts[i.long()]


def _scan_to_map(params0, c_ds, c_ok, st_ds, st_ok,
                 map_c, map_c_ok, map_s, map_s_ok, cfg: PipelineConfig,
                 assoc=None):
    """scan2MapOptimization (LM.cpp:493-624): association + full-6DoF GN.

    ``assoc(sel, ok, map_pts, map_ok) -> (d2 [Q, k], nbrs [Q, k, 3])``
    replaces the single-device search: ``parallel/sharded_mapping`` passes
    the search over the rank's row shard of the map, whose candidates come
    back with their coordinates."""
    K = cfg.map_knn
    if assoc is None:
        def assoc(sel, ok, map_pts, map_ok):
            return _local_assoc(sel, ok, map_pts, map_ok, K)
    enough = ((torch.sum(c_ok) >= cfg.min_corner_for_map)
              & (torch.sum(st_ok) >= cfg.min_surf_for_map)
              & (torch.sum(map_c_ok) >= cfg.min_corner_for_map))
    full = dims(FULL_DIMS, params0)
    params = params0
    for _ in range(cfg.map_outer_iters):
        # corner: 5-NN + PCA line test (LM.cpp:516-562)
        sel_c = se3.transform_points(params, c_ds)
        d_c, nbrs = assoc(sel_c, c_ok, map_c, map_c_ok)
        near_c = c_ok & (d_c[:, K - 1] < cfg.map_nn_max_dist_sq)
        center, direction, ev = pca_line_fit(nbrs, torch.ones_like(d_c, dtype=torch.bool))
        is_line = ev[:, 2] > cfg.line_eig_ratio * ev[:, 1]
        pj = center + 0.1 * direction
        pl = center - 0.1 * direction
        w_line = (near_c & is_line).to(params.dtype)

        # surf: 5-NN + plane fit (LM.cpp:564-607)
        sel_s = se3.transform_points(params, st_ds)
        d_s, nbrs_s = assoc(sel_s, st_ok, map_s, map_s_ok)
        near_s = st_ok & (d_s[:, K - 1] < cfg.map_nn_max_dist_sq)
        unit_n, d0, plane_ok = plane_fit(nbrs_s, torch.ones_like(d_s, dtype=torch.bool),
                                         cfg.plane_fit_tol)
        w_plane = (near_s & plane_ok).to(params.dtype)

        # the corner rows then the surf rows: one gn kernel launch on the GPU
        corr = join_correspondences(
            correspondence_rows(LINE, c_ds, w_line, pj=pj, pl=pl),
            correspondence_rows(PLANE_FITTED, st_ds, w_plane, pj=unit_n, scalar=d0))
        params = solve_correspondences(corr, params, cfg.map_gn_iters, full,
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
                 cfg: PipelineConfig, assoc=None):
    """One mapping frame. Returns (new_state, T_map2laser).  The keyframe
    store of ``ms`` is written in place.  Nothing is read on the host.

    ``assoc``: the 5-NN association (see :func:`_scan_to_map`)."""
    T_pred = ms.T_map2odom @ T_odom2laser

    # loop-closure mode: the cached local map is replaced only after a
    # keyframe was added (the reference's lax.cond on map_dirty): the map is
    # built on every mapping frame and selected on the device; it does not
    # depend on T_pred, so the selection is the rebuild, bit for bit.
    # Radius mode: the surround set follows the predicted pose, so the map
    # is rebuilt on every mapping frame (LM.cpp:452-457)
    mc, mco, msf, msfo = _build_local_map(ms, cfg, T_pred)
    if cfg.loop_closure_enabled:
        d = ms.map_dirty
        mc, msf = torch.where(d, mc, ms.map_corner), torch.where(d, msf, ms.map_surf)
        mco = torch.where(d, mco, ms.map_corner_valid)
        msfo = torch.where(d, msfo, ms.map_surf_valid)
    ms = ms._replace(map_corner=mc, map_corner_valid=mco, map_surf=msf,
                     map_surf_valid=msfo, map_dirty=torch.zeros_like(ms.map_dirty))
    c_ds, c_ok, s_ds, s_ok, o_ds, o_ok, st_ds, st_ok = _downsample_scan(
        corner_pts, corner_valid, surf_pts, surf_valid,
        outlier_pts, outlier_valid, cfg)

    params0 = se3.mat_to_params(T_pred)
    params = torch.where(
        ms.graph.count > 0,
        _scan_to_map(params0, c_ds, c_ok, st_ds, st_ok, ms.map_corner,
                     ms.map_corner_valid, ms.map_surf, ms.map_surf_valid, cfg,
                     assoc),
        params0)
    T_new = se3.params_to_mat(params)

    # saveKeyFramesAndFactor (LM.cpp:636-704); squared-distance gate quirk kept
    count = ms.graph.count
    last_t = at(ms.graph.poses, torch.clamp(count - 1, min=0))[:3, 3]
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


def compact_keyframes(ms: MappingState, cfg: PipelineConfig) -> MappingState:
    """Keyframe decimation at capacity (the keep-mapping-forever policy):
    drop every 2nd keyframe outside the recent window.

    Kept: node 0 (the prior), the recent window (the local map's), and every
    endpoint of an accepted loop factor (stored loop constraints stay
    exact); chain links are re-derived between surviving neighbours from
    the current estimates.  Run by ``SlamPipeline`` near capacity."""
    g = ms.graph
    M = cfg.max_keyframes
    dtype, dev = g.poses.dtype, g.poses.device
    idx = torch.arange(M, device=dev)
    count = g.count
    active = idx < count
    keep = active & ((idx >= count - cfg.recent_keyframe_search_num) | (idx % 2 == 0))
    # pin loop-factor endpoints (a scatter-max of the active-slot flags)
    l_act = torch.arange(g.loop_w.shape[0], device=dev) < g.loop_count
    keep_i = keep.to(torch.int32)
    keep_i.scatter_reduce_(0, g.loop_i.long(), l_act.to(torch.int32), reduce="amax")
    keep_i.scatter_reduce_(0, g.loop_j.long(), l_act.to(torch.int32), reduce="amax")
    keep = keep_i.bool() & active

    new_count = torch.sum(keep).to(torch.int32)
    rank = torch.cumsum(keep.to(torch.int32), 0, dtype=torch.int32) - 1
    # compaction permutation: kept rows ascending, dropped after (unique keys)
    perm = torch.argsort(torch.where(keep, idx, M + idx), stable=True)
    row_ok = idx < new_count
    eye = torch.eye(4, dtype=dtype, device=dev)

    poses = torch.where(row_ok[:, None, None], g.poses[perm], eye)
    prev = torch.where(row_ok[:, None, None], poses[torch.clamp(idx - 1, min=0)], eye)
    chain_rel = torch.where((idx > 0)[:, None, None], se3.inv_mat(prev) @ poses, poses)

    def gath(a):
        mask = row_ok.reshape((M,) + (1,) * (a.ndim - 1))
        return torch.where(mask, a[perm], torch.zeros((), dtype=a.dtype, device=dev))

    def remap(i):
        return torch.where(l_act, rank[i.long()], i)

    graph = g._replace(poses=poses, chain_rel=chain_rel, loop_i=remap(g.loop_i),
                       loop_j=remap(g.loop_j), count=new_count)
    last = ms.last_loop_kf
    return ms._replace(
        graph=graph, kf_times=gath(ms.kf_times),
        kf_corner=gath(ms.kf_corner), kf_corner_valid=gath(ms.kf_corner_valid),
        kf_surf=gath(ms.kf_surf), kf_surf_valid=gath(ms.kf_surf_valid),
        kf_outlier=gath(ms.kf_outlier), kf_outlier_valid=gath(ms.kf_outlier_valid),
        last_loop_kf=torch.where(last >= 0, at(rank, torch.clamp(last, min=0)), last),
        map_dirty=torch.ones_like(ms.map_dirty))


# ---------------------------------------------------------------------------
# loop closure (LM.cpp:779-975)
# ---------------------------------------------------------------------------

def _loop_acceptance(res: ICPResult, src, src_ok, tgt, tgt_ok, cfg: PipelineConfig):
    """(accept, factor_weight, inlier_frac) for an ICP result.

    Reference mode (``loop_min_inlier_frac == 0``): the raw
    ``getFitnessScore() < history_fitness_score`` (LM.cpp:842).  Default:
    structure points only (more than 0.4 m above their cloud's ground
    level), matched structure to structure by the k = 1 k-NN; a fraction >=
    ``loop_min_inlier_frac`` must lie within ``loop_inlier_radius`` of the
    history cloud and their RMS must beat ``loop_inlier_rmse``."""
    if cfg.loop_min_inlier_frac <= 0.0:
        accept = res.converged & (res.fitness < cfg.history_fitness_score)
        weight = 1.0 / torch.clamp(res.fitness, min=1e-3)
        return accept, weight, torch.zeros((), dtype=src.dtype, device=src.device)

    moved = src @ res.transform[:3, :3].T + res.transform[:3, 3]
    tgt_struct = tgt_ok & (tgt[:, 2] - _ground_z(tgt, tgt_ok) > 0.4)
    d2 = knn(moved, src_ok, tgt, tgt_struct, 1)[0][:, 0]
    struct = src_ok & (src[:, 2] - _ground_z(src, src_ok) > 0.4)
    inl = struct & (d2 < cfg.loop_inlier_radius ** 2)
    n_struct = torch.sum(struct)
    n_inl = torch.sum(inl)
    frac = n_inl.to(src.dtype) / torch.clamp(n_struct, min=1).to(src.dtype)
    ms_inl = (torch.sum(torch.where(inl, d2, 0.0))
              / torch.clamp(n_inl, min=1).to(src.dtype))
    # a cloud with (almost) no structure cannot be verified: reject
    accept = (res.converged & (n_struct >= 32)
              & (frac >= cfg.loop_min_inlier_frac)
              & (ms_inl <= cfg.loop_inlier_rmse ** 2))
    return accept, 1.0 / torch.clamp(ms_inl, min=1e-3), frac


def _keyframe_cloud(ms: MappingState, k, pose, cap):
    """All three feature clouds of keyframe k, transformed by ``pose`` and
    front-compacted into ``cap`` slots."""
    pts = torch.cat([at(ms.kf_corner, k), at(ms.kf_surf, k), at(ms.kf_outlier, k)], 0)
    val = torch.cat([at(ms.kf_corner_valid, k), at(ms.kf_surf_valid, k),
                     at(ms.kf_outlier_valid, k)], 0)
    return compact_masked(pts @ pose[:3, :3].T + pose[:3, 3], val, cap)


def _chain_cumsum(g: pg.PoseGraph) -> torch.Tensor:
    """Cumulative path length along the odometry chain (chain_rel[0] is the
    node-0 prior, not a step)."""
    idx = torch.arange(g.poses.shape[0], device=g.poses.device)
    step = torch.linalg.vector_norm(g.chain_rel[:, :3, 3], dim=-1)
    return torch.cumsum(torch.where((idx > 0) & (idx < g.count), step, 0.0), 0)


def _chain_path_to_latest(ms: MappingState, latest):
    """Path length along the chain from each keyframe to the latest one."""
    cum = _chain_cumsum(ms.graph)
    return torch.clamp(at(cum, torch.clamp(latest, min=0)) - cum, min=0.0)


def detect_loop(ms: MappingState, cfg: PipelineConfig):
    """Drift-aware candidate search: (found, closest, latest), all on the
    device.  The search radius grows with the path to the latest keyframe,
    ``history_search_radius + loop_drift_radius_frac * path``; candidates
    rank by d2 / r_eff^2, the first index on ties; the 30 s age gate is the
    reference's (LM.cpp:934)."""
    latest = ms.graph.count - 1
    kp = ms.graph.poses[:, :3, 3]
    cur_t = at(kp, torch.clamp(latest, min=0))
    idx = torch.arange(cfg.max_keyframes, device=kp.device)
    act = (idx < latest) & (latest >= 0)
    d2 = torch.sum((kp - cur_t) ** 2, -1)
    old_enough = (at(ms.kf_times, torch.clamp(latest, min=0)) - ms.kf_times) > cfg.loop_time_gap
    r_eff = (cfg.history_search_radius
             + cfg.loop_drift_radius_frac * _chain_path_to_latest(ms, latest))
    score = d2 / (r_eff * r_eff)
    elig = act & old_enough & (score < 1.0)
    closest = torch.argmin(torch.where(elig, score, 1e30)).to(torch.int32)
    return elig.any(), closest, latest


def _history_cloud(ms: MappingState, closest, latest, cfg: PipelineConfig):
    """The voxelised map-frame cloud of the keyframes within
    ``history_search_num`` of the candidate (before the latest one)."""
    hs = cfg.history_search_num
    span = 2 * hs + 1
    start = torch.clamp(closest - hs, 0, max(cfg.max_keyframes - span, 0))
    rows = start.long() + torch.arange(span, device=start.device)
    ok_j = (torch.abs(rows - closest) <= hs) & (rows >= 0) & (rows < latest)
    poses_j = ms.graph.poses[rows]
    clouds = [(ms.kf_corner, ms.kf_corner_valid), (ms.kf_surf, ms.kf_surf_valid),
              (ms.kf_outlier, ms.kf_outlier_valid)]
    pts, val = [], []
    for a, v in clouds:
        ok = v[rows] & ok_j[:, None]
        pts.append(_transform_kf_clouds(poses_j, a[rows], ok).reshape(-1, 3))
        val.append(ok.reshape(-1))
    return voxel_downsample(torch.cat(pts), torch.cat(val), cfg.history_leaf, cfg.loop_hist_cap)


def _pick(cond, a, b):
    """Leaf-wise ``where(cond, a, b)`` over two NamedTuples of tensors."""
    return type(a)(*(torch.where(cond, x, y) for x, y in zip(a, b)))


def _smear(g: pg.PoseGraph, correction, closest, latest):
    """Anchor-hinged smear: every node k gets the left correction
    A exp(f_k d_A) A^-1 with A the candidate's pose and f_k the path
    fraction from the candidate to the latest keyframe (0 before the anchor,
    1 from the latest on): the rotational chain bend that GN cannot find
    from the drifted poses, which it then polishes."""
    A = at(g.poses, closest)
    A_inv = se3.inv_mat(A)
    d_A = se3.se3_log(A_inv @ correction @ A)
    cum = _chain_cumsum(g)
    c_cl = at(cum, closest)
    denom = torch.clamp(at(cum, latest) - c_cl, min=1e-6)
    f = torch.clamp((cum - c_cl) / denom, 0.0, 1.0)
    D = A @ se3.se3_exp(d_A * f[:, None]) @ A_inv
    return torch.einsum("nij,njk->nik", D, g.poses)


def _close(ms: MappingState, res: ICPResult, weight, closest, latest, accept,
           cfg: PipelineConfig, solve, energy):
    """Add the loop factor and solve (LM.cpp:862-882), taken where
    ``accept``.  Returns (state, committed) with committed a device bool:
    the reference's ``lax.cond(accept, close, ...)`` and its post-solve
    chain bend gate are both selects on the device, no host read."""
    g = ms.graph
    pose_latest = at(g.poses, latest)
    rel = se3.inv_mat(res.transform @ pose_latest) @ at(g.poses, closest)
    g_raw = pg.add_loop_factor(g, latest, closest, rel, weight)
    act = (torch.arange(cfg.max_keyframes, device=g.poses.device) < g.count)[:, None, None]
    g_sm = g_raw._replace(poses=torch.where(
        act, _smear(g, res.transform, closest, latest), g_raw.poses))

    # both initialisations, keep the lower-energy solution: the smear suits
    # drift accumulated along the path, the raw poses a discrepancy near
    # the latest node
    g0, g1 = solve(g_raw), solve(g_sm)
    g_new = _pick(energy(g1) < energy(g0), g1, g0)
    # correctPoses map2odom rebase (LM.cpp:725-726); the local map is stale
    new = dict(T_map2odom=res.transform @ ms.T_map2odom,
               T_map2laser=at(g_new.poses, latest),
               map_dirty=torch.ones_like(ms.map_dirty))
    committed = accept
    if cfg.loop_chain_bend_max > 0:
        # no chain link may bend beyond its odometry's plausible range, in
        # translation or rotation; a factor the chain refuses is rolled back
        idx = torch.arange(cfg.max_keyframes, device=g.poses.device)
        prev = g_new.poses[torch.clamp(idx - 1, min=0)]
        E = se3.inv_mat(g_new.chain_rel) @ se3.inv_mat(prev) @ g_new.poses
        link = (idx > 0) & (idx < g_new.count)
        bend_t = torch.linalg.vector_norm(E[:, :3, 3], dim=-1)
        cos_r = (torch.diagonal(E[:, :3, :3], dim1=-2, dim2=-1).sum(-1) - 1.0) * 0.5
        bend_r = torch.acos(torch.clamp(cos_r, -1.0, 1.0))
        rot_max = (torch.full((), cfg.loop_chain_bend_max_rot_deg, dtype=bend_r.dtype,
                              device=bend_r.device) * const(math.pi / 180, bend_r))
        committed = (accept
                     & (torch.max(torch.where(link, bend_t, 0.0)) <= cfg.loop_chain_bend_max)
                     & (torch.max(torch.where(link, bend_r, 0.0)) <= rot_max))
    return ms._replace(graph=_pick(committed, g_new, g),
                       **{k: torch.where(committed, v, getattr(ms, k))
                          for k, v in new.items()}), committed


def _attempt(ms: MappingState, closest, latest, cfg: PipelineConfig, solve, energy, loop):
    """One loop attempt against candidate ``closest``: (state, closed,
    fitness, inlier_frac), with no host read.  The rescue (with
    ``loop_coarse_align``) and the close always run; the device takes the
    rescue's result where the identity attempt failed the gate, and the
    close's state where the attempt is accepted, as the reference's
    ``lax.cond``s pick.  ``loop`` runs both ICPs' iterations."""
    pose_latest = at(ms.graph.poses, latest)
    # raw (unfiltered) source cloud: getFitnessScore averages over raw
    # source points, and the gate is calibrated on them
    src, src_ok = _keyframe_cloud(ms, latest, pose_latest, cfg.loop_latest_cap)
    # ICP iterates on a decimated source (made contiguous once for the
    # kernel); the acceptance gate scores the full one
    d = max(1, cfg.loop_icp_decimate)
    src_i, src_i_ok = src[::d].contiguous(), src_ok[::d].contiguous()
    tgt, tgt_ok = _history_cloud(ms, closest, latest, cfg)

    res = icp_point_to_point(src_i, src_i_ok, tgt, tgt_ok, cfg.icp_iters,
                             cfg.icp_max_corr_dist, cfg.icp_translation_eps, loop=loop)
    accept, weight, inlier_frac = _loop_acceptance(res, src, src_ok, tgt, tgt_ok, cfg)
    if cfg.loop_coarse_align:
        # wide-basin rescue: a bird's-eye structure correlation recovers
        # (yaw, dx, dy, dz) globally, then a short ICP refines; its result
        # counts only where the identity attempt failed the gate
        ba = bev_align(src, src_ok, tgt, tgt_ok, pose_latest[:2, 3],
                       at(ms.graph.poses, closest)[:2, 3], grid=cfg.loop_bev_grid,
                       res=cfg.loop_bev_res, n_yaw=cfg.loop_bev_yaws)
        res_b = icp_point_to_point(src_i, src_i_ok, tgt, tgt_ok,
                                   min(cfg.icp_iters, cfg.loop_rescue_icp_iters),
                                   cfg.icp_max_corr_dist, cfg.icp_translation_eps,
                                   T0=ba.transform, loop=loop)
        res = _pick(~accept & res_b.converged & (res_b.fitness < res.fitness), res_b, res)
        accept, weight, inlier_frac = _loop_acceptance(res, src, src_ok, tgt, tgt_ok, cfg)

    # consistency gate 1 (pre-solve): the correction may move the latest pose
    # by at most the plausible accumulated drift
    if cfg.loop_max_correction_abs > 0:
        path_cl = at(_chain_path_to_latest(ms, latest), closest)
        disp = torch.linalg.vector_norm((res.transform @ pose_latest)[:3, 3] - pose_latest[:3, 3])
        accept = accept & (disp <= cfg.loop_max_correction_abs
                           + cfg.loop_max_correction_frac * path_cl)
    ms, closed = _close(ms, res, weight, closest, latest, accept, cfg, solve, energy)
    return ms, closed, res.fitness, inlier_frac


def loop_gate(ms: MappingState, cfg: PipelineConfig):
    """(do, closest, latest) on the device: an attempt runs when a
    candidate exists, the latest keyframe was not tried yet, and the graph
    has two nodes (the reference's ``lax.cond(do, attempt, skip)``)."""
    found, closest, latest = detect_loop(ms, cfg)
    return found & (latest != ms.last_loop_kf) & (ms.graph.count > 1), closest, latest


def loop_attempt(ms: MappingState, closest, latest, cfg: PipelineConfig,
                 graph_optimizer=None, graph_energy_fn=None, loop=fixed_loop):
    """The attempt of :func:`loop_closure_step` past its gate, against the
    candidate of :func:`loop_gate`, with the attempt counters: returns
    (new_state, closed, fitness) and reads nothing on the host (the body
    that ``loop_graph.LoopAttemptGraph`` captures).  The optimiser hooks
    are :func:`loop_closure_step`'s; ``loop`` runs the ICPs' iterations
    and the default optimiser's GN iterations (``device.fixed_loop``'s
    contract; ``LoopAttemptGraph`` passes its own)."""
    sigma = cfg.pose_graph_chain_sigma
    if graph_optimizer is None:
        def graph_optimizer(g):
            return pg.optimize(g, sigma, iters=cfg.pose_graph_gn_iters, loop=loop)
    if graph_energy_fn is None:
        def graph_energy_fn(g):
            return pg.graph_energy(g, sigma)
    ms, closed, fitness, inlier = _attempt(ms, closest, latest, cfg, graph_optimizer,
                                           graph_energy_fn, loop)
    ms = ms._replace(
        last_loop_kf=latest.to(torch.int32),
        loop_attempts=ms.loop_attempts + 1,
        loop_best_fitness=torch.minimum(ms.loop_best_fitness, fitness),
        loop_best_inlier=torch.maximum(ms.loop_best_inlier, inlier))
    return ms, closed, fitness


def loop_closure_step(ms: MappingState, cfg: PipelineConfig, graph_optimizer=None,
                      graph_energy_fn=None, read=bool):
    """performLoopClosure: returns (new_state, closed, fitness).

    One host read, ``read(do)``, decides whether an attempt runs
    (:func:`loop_gate`); a gated-off call launches nothing.  The attempt
    itself (:func:`loop_attempt`) reads nothing.

    ``graph_optimizer(graph) -> graph`` replaces the single-device solve
    (``parallel/sharded_mapping`` passes the distributed Schur solver);
    ``graph_energy_fn(graph) -> scalar`` is the objective that picks
    between the two initialisations, by default the single-device one at
    ``cfg.pose_graph_chain_sigma``, which the Schur solver minimises too.
    ``read(flag) -> bool`` is how the host reads the gate (``Comm.read`` on
    several ranks)."""
    do, closest, latest = loop_gate(ms, cfg)
    if not read(do):
        return (ms, torch.zeros_like(do),
                torch.full((), 1e9, dtype=ms.T_map2odom.dtype, device=do.device))
    return loop_attempt(ms, closest, latest, cfg, graph_optimizer, graph_energy_fn)
