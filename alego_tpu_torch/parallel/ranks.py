"""Per-rank entry points for ``parallel.launch``: host (numpy) inputs in,
rank 0's host outputs back.  The CLI's ``--mesh``, ``chip_smoke.py`` and the
tests start their ranks on these, so a rank imports only this package.

Frames go to the ranks through a directory (:func:`save_frames`), read with
copy-on-write memory maps, not through pickling.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from .. import kernels
from ..models import laser_mapping as lm, pose_graph as pg
from ..models.pipeline import tree_from_reference
from .comm import Comm
from .distributed import DistributedSlamPipeline
from .map_shard import make_sharded_map_knn, shard_map_points
from .multichip import ShardedSlamPipeline, make_multichip_step
from .schur import make_schur_solver
from .sharded_mapping import make_sharded_loop_closure_step, make_sharded_mapping_step


def save_frames(path: str, points: np.ndarray, mask: np.ndarray) -> str:
    """Write frames ([T, ...] points and masks) for :func:`load_frames`."""
    os.makedirs(path, exist_ok=True)
    np.save(os.path.join(path, "points.npy"), np.asarray(points, np.float32))
    np.save(os.path.join(path, "mask.npy"), np.asarray(mask, bool))
    return path


def load_frames(path: str):
    return (np.load(os.path.join(path, "points.npy"), mmap_mode="c"),
            np.load(os.path.join(path, "mask.npy"), mmap_mode="c"))


def _numpy(tree):
    if hasattr(tree, "_fields"):
        return type(tree)(*(_numpy(sub) for sub in tree))
    return tree.cpu().numpy()


def _tensor(comm: Comm, a) -> torch.Tensor:
    return torch.from_numpy(np.array(a)).to(comm.device)


def _sync(comm: Comm):
    if comm.device.type == "cuda":
        torch.cuda.synchronize(comm.device)


def run_jobs(comm: Comm, jobs):
    """``[(fn, args), ...]``: each ``fn(comm, *args)`` in order, in one
    group; returns their results."""
    return [fn(comm, *args) for fn, args in jobs]


def sharded_knn(comm: Comm, k: int, query, qmask, map_pts, map_ok):
    """(d2, idx, coords) of the row-sharded k-NN over a [N, 3] map (padded to
    a multiple of the group size)."""
    mp, mok = shard_map_points(comm, _tensor(comm, map_pts), _tensor(comm, map_ok))
    knn = make_sharded_map_knn(comm, k)
    return tuple(x.cpu().numpy() for x in knn(_tensor(comm, query), _tensor(comm, qmask),
                                             mp, mok))


def schur_solve(comm: Comm, graph, chain_sigma, iters: int, max_step: float = pg.MAX_STEP):
    """The Schur solve of a pose graph (a NamedTuple of numpy leaves with
    ``PoseGraph``'s fields): its poses, and the solve's host seconds
    (synchronised)."""
    g = tree_from_reference(pg.PoseGraph, graph, comm.device)
    solver = make_schur_solver(comm, g.poses.shape[0], g.loop_w.shape[0], chain_sigma,
                               iters=iters, max_step=max_step)
    _sync(comm)
    t0, c0 = time.perf_counter(), comm.seconds
    out = solver(g).poses
    _sync(comm)
    return dict(poses=out.cpu().numpy(), seconds=time.perf_counter() - t0,
                collective_seconds=comm.seconds - c0)


def multichip_step(comm: Comm, cfg, points, mask, poses, chain_rel, active, max_loops=8):
    """``make_multichip_step``: the frame-parallel front end over a
    [B, N, 3] batch and two GN iterations of the distributed pose-graph
    solve of a chain (poses, chain_rel, active prefix mask), as numpy."""
    step = make_multichip_step(cfg, comm, poses.shape[0], max_loops)
    fc, out = step(_tensor(comm, points), _tensor(comm, mask).bool(), _tensor(comm, poses),
                   _tensor(comm, chain_rel), _tensor(comm, active).bool())
    return _numpy(fc), out.cpu().numpy()


def mapping_step(comm: Comm, cfg, ms, args):
    """One sharded mapping step from a mapping state and ``mapping_step``'s
    inputs (numpy): (state, T_map2laser) as numpy."""
    ms = tree_from_reference(lm.MappingState, ms, comm.device)
    out, T = make_sharded_mapping_step(cfg, comm)(ms, *(_tensor(comm, a) for a in args))
    return _numpy(out), T.cpu().numpy()


def loop_closure_step(comm: Comm, cfg, ms):
    """One sharded loop-closure step: (state, closed, fitness) as numpy."""
    ms = tree_from_reference(lm.MappingState, ms, comm.device)
    out, closed, fitness = make_sharded_loop_closure_step(cfg, comm)(ms)
    return _numpy(out), bool(closed), float(fitness)


def _checksum(t: torch.Tensor) -> float:
    """The sum of ``t``'s 32-bit words: any one-bit change of an element
    changes it, and it is exact in a float64 (< 2 ** 53 for < 2 ** 21
    words)."""
    return float(t.contiguous().view(torch.int32).to(torch.int64).sum())


def _gathered_stats(comm: Comm, pipe: DistributedSlamPipeline, est: torch.Tensor):
    """Every rank's kernel launches, collective costs and peak memory, read
    before the gather that collects them, and what shows whether the ranks'
    replicated states stayed equal: the graph's keyframe and loop counts and
    checksums of the streamed poses and of the keyframe poses."""
    peak = (torch.cuda.max_memory_allocated(comm.device) / 2 ** 20
            if comm.device.type == "cuda" else 0.0)
    g = pipe.state.mapping.graph
    state = [g.count, g.loop_count, _checksum(est), _checksum(g.poses[:int(g.count)])]
    row = [kernels.LAUNCHES["ccl"], kernels.LAUNCHES["nn1"], kernels.LAUNCHES["knn"],
           comm.seconds, comm.calls, comm.max_gather_bytes, peak] + [float(x) for x in state]
    rows = comm.all_gather(torch.tensor(row, dtype=torch.float64, device=comm.device))
    keys = ("ccl", "nn1", "knn", "collective_seconds", "collective_calls",
            "max_gather_bytes", "peak_mib", "keyframes", "loops", "poses_checksum",
            "kf_poses_checksum")
    return [dict(zip(keys, r)) for r in rows.cpu().tolist()]


def ranks_agree(stats) -> bool:
    """Whether every rank ended with rank 0's keyframe and loop counts and
    bit for bit its poses (:func:`_gathered_stats`' checksums)."""
    keys = ("keyframes", "loops", "poses_checksum", "kf_poses_checksum")
    return all(r[k] == stats[0][k] for r in stats for k in keys)


def _reset_counts(comm: Comm):
    _sync(comm)
    kernels.LAUNCHES.clear()
    comm.reset()
    if comm.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(comm.device)


def distributed_run(comm: Comm, cfg, frames: str, warmup: int = 0):
    """``DistributedSlamPipeline`` over the frames in ``frames`` (every rank
    reads them all), counted (counts set to 0 just before) and timed on the
    host clock with one synchronise at the end; ``warmup`` frames run first
    and the pipeline is reset.  Returns the poses, the graph's keyframes and
    loop factors, and every rank's launches, collective costs and state
    checksums (:func:`ranks_agree`)."""
    pts, mask = load_frames(frames)
    pipe = DistributedSlamPipeline(cfg, comm)
    if warmup:
        pipe.run(pts[:warmup], mask[:warmup])
        pipe.reset()
    _reset_counts(comm)
    t0 = time.perf_counter()
    for k in range(pts.shape[0]):
        pipe.process(pts[k], mask[k])
    est = torch.stack(pipe.poses)
    est_np = est.cpu().numpy()
    seconds = time.perf_counter() - t0
    ms = pipe.state.mapping
    g = ms.graph
    n_kf, n_loops = int(g.count), int(g.loop_count)
    return dict(
        poses=est_np, seconds=seconds, keyframes=n_kf, loops=n_loops,
        loop_pairs=[(int(i), int(j)) for i, j in zip(g.loop_i[:n_loops].tolist(),
                                                    g.loop_j[:n_loops].tolist())],
        attempts=int(ms.loop_attempts), overflow=int(g.overflow),
        loop_overflow=int(g.loop_overflow), compactions=pipe.compactions,
        kf_poses=g.poses[:n_kf].cpu().numpy(), kf_times=ms.kf_times[:n_kf].cpu().numpy(),
        ranks=_gathered_stats(comm, pipe, est), staged=comm.staged, backend=comm.backend)


def lanes_run(comm: Comm, cfg, frames: str):
    """``ShardedSlamPipeline`` over B sequences in ``frames`` ([T, B, ...]),
    one lane per rank: the trajectories [T, B, 4, 4], each lane's
    keyframes and loops, and the host seconds of the run (its poses
    gathered at the end)."""
    pts, mask = load_frames(frames)
    spipe = ShardedSlamPipeline(cfg, comm)
    _sync(comm)
    t0 = time.perf_counter()
    traj = spipe.run(pts, mask)
    seconds = time.perf_counter() - t0
    counts = spipe.lane_counts()
    return dict(trajectories=traj, keyframes=counts[:, 0], loops=counts[:, 1],
                seconds=seconds)


def fail_on(comm: Comm, rank: int):
    """A probe of ``launch``'s failure handling: rank ``rank`` raises while
    the others wait in a collective."""
    if comm.rank == rank:
        raise RuntimeError(f"rank {rank} fails on purpose")
    comm.all_gather(torch.zeros(1, device=comm.device))


def stall(comm: Comm, seconds: float):
    """A probe of ``launch``'s timeout: every rank sleeps."""
    time.sleep(seconds)
