"""Keyframe pose graph state, the part of ``alego_tpu.models.pose_graph``
that the frame step uses: the fixed-capacity factor-graph arrays and
keyframe insertion.  The graph solve belongs to loop closure, which this
port does not carry yet.

At capacity a keyframe is rejected and counted in ``overflow``, never
overwriting the stored chain.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops import se3


class PoseGraph(NamedTuple):
    poses: torch.Tensor          # [N, 4, 4] current estimates (active: [:count])
    chain_rel: torch.Tensor      # [N, 4, 4] X_{i-1}^-1 X_i at insertion
    loop_i: torch.Tensor         # [L] loop factor endpoints
    loop_j: torch.Tensor
    loop_rel: torch.Tensor       # [L, 4, 4]
    loop_w: torch.Tensor         # [L] (0 = empty slot)
    count: torch.Tensor          # int32 active poses
    loop_count: torch.Tensor     # int32 active loop factors
    overflow: torch.Tensor       # int32 keyframes rejected at capacity
    loop_overflow: torch.Tensor  # int32 loop factors rejected at capacity


def init_graph(max_kf: int, max_loops: int, device,
               dtype=torch.float32) -> PoseGraph:
    eye = torch.eye(4, dtype=dtype, device=device)

    def i32():
        return torch.zeros((), dtype=torch.int32, device=device)

    return PoseGraph(
        poses=eye.repeat(max_kf, 1, 1), chain_rel=eye.repeat(max_kf, 1, 1),
        loop_i=torch.zeros(max_loops, dtype=torch.int32, device=device),
        loop_j=torch.zeros(max_loops, dtype=torch.int32, device=device),
        loop_rel=eye.repeat(max_loops, 1, 1),
        loop_w=torch.zeros(max_loops, dtype=dtype, device=device),
        count=i32(), loop_count=i32(), overflow=i32(), loop_overflow=i32(),
    )


def add_keyframe(g: PoseGraph, pose: torch.Tensor, do: torch.Tensor) -> PoseGraph:
    """Append a pose; the measured between is prev^-1 @ pose (LM.cpp:655-658).

    ``do`` (bool tensor): when False the call is a value-level no-op.  The
    row is written in place (``index_copy_``) with its old value where the
    save is off, so no buffer is copied and nothing waits on the device."""
    cap = g.poses.shape[0]
    at_cap = g.count >= cap
    write = do & ~at_cap
    k = torch.clamp(g.count, max=cap - 1).long().reshape(1)
    prev = g.poses[torch.clamp(k - 1, min=0)][0]
    rel = torch.where(k == 0, pose, se3.inv_mat(prev) @ pose)
    g.poses.index_copy_(0, k, torch.where(write, pose, g.poses[k][0])[None])
    g.chain_rel.index_copy_(0, k, torch.where(write, rel, g.chain_rel[k][0])[None])
    return g._replace(count=g.count + write.to(torch.int32),
                      overflow=g.overflow + (do & at_cap).to(torch.int32))
