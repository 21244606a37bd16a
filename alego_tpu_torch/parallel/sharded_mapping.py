"""One map, one pose graph, D ranks: the distributed single-map mapping
step and loop closure, the port of ``alego_tpu.parallel.sharded_mapping``.

The mapping step's 5-NN association runs on the rank's row shard of the
local map (``parallel/map_shard``: candidates and their coordinates merged
with O(D * Q * k) traffic), and loop closure's pose-graph solve is the
distributed Schur solver (``parallel/schur``).  The keyframe store, the
local map's build and the rest of the step stay replicated: the
association's distance work is what scales with the map, and each rank
does 1/D of it.  Every host branch goes through ``Comm.read``, so the ranks
take each one alike.
"""

from __future__ import annotations

from ..config import PipelineConfig
from ..models import laser_mapping as lm
from .comm import Comm
from .map_shard import make_sharded_map_knn
from .schur import make_schur_solver


def make_sharded_assoc(cfg: PipelineConfig, comm: Comm):
    """``mapping_step``'s ``assoc`` over the rank's shard of the local map
    (the map capacities must divide by the group size)."""
    D = comm.size
    if cfg.map_corner_cap % D or cfg.map_surf_cap % D:
        raise ValueError(f"map capacities ({cfg.map_corner_cap}, {cfg.map_surf_cap}) "
                         f"must divide by the group size {D}")
    knn = make_sharded_map_knn(comm, cfg.map_knn)

    def assoc(sel, ok, map_pts, map_ok):
        nb = map_pts.shape[0] // D
        lo = comm.rank * nb
        d, _, coords = knn(sel, ok, map_pts[lo:lo + nb], map_ok[lo:lo + nb])
        return d, coords

    return assoc


def make_schur_graph_optimizer(cfg: PipelineConfig, comm: Comm):
    """``loop_closure_step``'s ``graph_optimizer``: the Schur solver at the
    configuration's capacities, sigma and GN iterations."""
    return make_schur_solver(comm, cfg.max_keyframes, cfg.max_loop_factors,
                             cfg.pose_graph_chain_sigma, iters=cfg.pose_graph_gn_iters)


def make_sharded_mapping_step(cfg: PipelineConfig, comm: Comm):
    """fn with ``mapping_step``'s signature (less ``cfg``): the 5-NN
    association sharded over the group."""
    assoc = make_sharded_assoc(cfg, comm)

    def step(ms, T_odom2laser, corner_pts, corner_valid, surf_pts, surf_valid,
             outlier_pts, outlier_valid, time):
        return lm.mapping_step(ms, T_odom2laser, corner_pts, corner_valid, surf_pts,
                               surf_valid, outlier_pts, outlier_valid, time, cfg,
                               assoc=assoc)

    return step


def make_sharded_loop_closure_step(cfg: PipelineConfig, comm: Comm):
    """fn(ms) -> (ms, closed, fitness): ``loop_closure_step`` with the
    pose-graph solve distributed over the group."""
    solver = make_schur_graph_optimizer(cfg, comm)

    def step(ms):
        return lm.loop_closure_step(ms, cfg, graph_optimizer=solver, read=comm.read)

    return step
