"""Multi-device scale-out, the port of ``alego_tpu.parallel.multichip``: the
frame-parallel front end, the distributed pose-graph solve, and B
independent SLAM lanes, one per rank.

The reference's ``make_mesh`` is :class:`~.comm.Comm` here (the group is
made by ``parallel.launch``), and its ``make_batched_slam`` (one unbatched
``slam_step`` per device under ``shard_map``) is a whole ``SlamPipeline``
per rank: :class:`ShardedSlamPipeline`.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import PipelineConfig
from ..models import pose_graph as pg
from ..models.image_projection import image_projection
from ..models.pipeline import SlamPipeline
from ..ops.features import FeatureClouds, extract_features
from .comm import Comm
from .schur import make_schur_solver


def make_sharded_frontend(cfg: PipelineConfig, comm: Comm):
    """fn(points [B, N, 3], mask [B, N]) -> FeatureClouds batched over B, the
    same on every rank: rank r runs projection, segmentation and features on
    frames r * B/D .. (r + 1) * B/D - 1, and the clouds are all-gathered.
    B must divide by the group size."""
    D = comm.size

    def run(points, mask):
        B = points.shape[0]
        if B % D:
            raise ValueError(f"batch {B} must divide by the group size {D}")
        per = B // D
        mine = [extract_features(image_projection(points[i], mask[i], cfg), cfg)
                for i in range(comm.rank * per, (comm.rank + 1) * per)]
        stacked = [torch.stack(leaves) for leaves in zip(*mine)]
        return FeatureClouds(*(comm.all_gather(x).reshape((B,) + x.shape[1:])
                               for x in stacked))

    return run


def make_distributed_pose_graph_solver(comm: Comm, max_kf: int, chain_sigma,
                                       iters: int = 5, max_loops: int = 8):
    """fn(poses [N, 4, 4], chain_rel [N, 4, 4], active [N]) -> optimised poses
    [N, 4, 4], through the Schur solver (``parallel/schur``).

    ``active`` must be a prefix mask (keyframes are appended, never
    deleted): anything after its first False is inactive (the leading run
    is the count), since the chain solver indexes factors by position."""
    solver = make_schur_solver(comm, max_kf, max_loops, chain_sigma, iters=iters)

    def solve(poses, chain_rel, active):
        g = pg.init_graph(max_kf, max_loops, poses.device, poses.dtype)
        count = torch.sum(torch.cumprod(active.to(torch.int32), 0)).to(torch.int32)
        return solver(g._replace(poses=poses, chain_rel=chain_rel, count=count)).poses

    return solve


def make_multichip_step(cfg: PipelineConfig, comm: Comm, max_kf: int, max_loops: int = 8):
    """One combined step: the sharded front end over a frame batch and two
    GN iterations of the distributed pose-graph solve."""
    frontend = make_sharded_frontend(cfg, comm)
    solver = make_distributed_pose_graph_solver(comm, max_kf, cfg.pose_graph_chain_sigma,
                                                iters=2, max_loops=max_loops)

    def step(points, mask, poses, chain_rel, active):
        return frontend(points, mask), solver(poses, chain_rel, active)

    return step


class ShardedSlamPipeline:
    """B concurrent SLAM sequences, one lane per rank (multi-log mapping
    runs): rank b runs a whole ``SlamPipeline`` over sequence b, and no
    collective touches the math; the poses are gathered when asked for.
    Inputs and outputs carry the reference's leading batch axis."""

    def __init__(self, cfg: PipelineConfig, comm: Comm, device=None):
        self.cfg = cfg
        self.comm = comm
        self.batch = comm.size
        self.pipe = SlamPipeline(cfg, device=comm.device if device is None else device)

    def process(self, points, mask, time=None):
        """points [B, N, 3], mask [B, N]: this rank's lane takes row
        ``rank``; returns the lane's map-frame pose [4, 4] on the device."""
        r = self.comm.rank
        return self.pipe.process(points[r], mask[r], None if time is None else time[r])

    def run(self, points_seq, mask_seq) -> np.ndarray:
        """points_seq [T, B, N, 3] -> trajectories [T, B, 4, 4] (every rank)."""
        for k in range(points_seq.shape[0]):
            self.process(points_seq[k], mask_seq[k])
        return self.trajectories()

    def trajectories(self) -> np.ndarray:
        """Every lane's poses so far, [T, B, 4, 4] as numpy (one gather)."""
        mine = torch.stack(self.pipe.poses)
        return self.comm.all_gather(mine).transpose(0, 1).cpu().numpy()

    def lane_counts(self) -> np.ndarray:
        """[B, 2]: each lane's keyframes and loop factors (one gather)."""
        g = self.pipe.state.mapping.graph
        return self.comm.all_gather(torch.stack([g.count, g.loop_count])).cpu().numpy()


def lane_state(tree, lane: int):
    """Lane ``lane`` of a batched reference state (the reference's
    ``ShardedSlamPipeline.state``, numpy leaves with a leading B axis), for
    ``models.pipeline.state_from_reference``."""
    if hasattr(tree, "_fields"):
        return type(tree)(*(lane_state(sub, lane) for sub in tree))
    return np.asarray(tree)[lane]
