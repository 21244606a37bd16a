"""Batched point-to-point ICP (the ``pcl::IterativeClosestPoint`` of loop
closure), the port of ``alego_tpu.ops.icp``.

Each iteration is one exact 1-NN search (``knn.nn1_best``: the
``csrc/nn1.cu`` kernel for tensors on the GPU) and a masked closed-form
Kabsch update, with the reference's epsilon early stop (LM.cpp:818-840).
The reference stops inside ``lax.while_loop``; here the loop always runs
its ``iters`` iterations on the device and an iteration past the stop
keeps the old transform, count and correspondences (``torch.where``), the
way ``gauss_newton.solve_gn`` runs its fixed loop.  Nothing is read on the
host, and the transform, fitness, ``converged`` and the iteration count
equal the reference's.  The iterations run through a ``loop`` hook
(``device.fixed_loop`` by default): ``loop_graph`` passes one that
captures a single iteration in a CUDA graph and replays it ``iters``
times, as XLA compiles the ``while_loop``'s body once.  Fitness is
``getFitnessScore()``: the mean squared NN distance over the valid source
points.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..device import fixed_loop
from .eig3 import rotation_from_covariance
from .knn import nn1_best as _nn1


class ICPResult(NamedTuple):
    transform: torch.Tensor   # [4, 4] source -> target
    fitness: torch.Tensor     # scalar mean squared distance
    converged: torch.Tensor   # bool: criterion-based (PCL hasConverged)
    iters: torch.Tensor       # int32 iterations executed


def _rigid_from_correspondences(src, tgt, w):
    """Weighted Kabsch: the best R, t aligning src -> tgt."""
    wsum = torch.clamp(torch.sum(w), min=1e-6)
    mu_s = torch.sum(src * w[:, None], 0) / wsum
    mu_t = torch.sum(tgt * w[:, None], 0) / wsum
    S = ((src - mu_s) * w[:, None]).T @ (tgt - mu_t)
    R = rotation_from_covariance(S)
    return R, mu_t - R @ mu_s


def _moved(src, T):
    return src @ T[:3, :3].T + T[:3, 3]


def icp_point_to_point(src: torch.Tensor, src_valid: torch.Tensor,
                       tgt: torch.Tensor, tgt_valid: torch.Tensor,
                       iters: int, max_corr_dist: float,
                       translation_eps: float = 1e-6,
                       T0: Optional[torch.Tensor] = None, loop=fixed_loop) -> ICPResult:
    """Align the masked source cloud to the masked target cloud from ``T0``.

    ``converged`` follows PCL's ``DefaultConvergenceCriteria``: true when
    the loop stops on the epsilon criterion (incremental translation^2 <=
    eps and incremental rotation within 1 - eps of identity) and, as PCL's
    default has it, also when the budget runs out.  False when no
    correspondence fell inside ``max_corr_dist`` or the fitness is not
    finite.  ``src`` and ``tgt`` must be contiguous on the GPU (the kernel's
    contract).  Every one of the ``iters`` iterations runs its search;
    ``iters`` of the result counts those the reference's ``while_loop``
    runs.  ``loop(body, carry, iters)`` runs the iterations
    (``device.fixed_loop``'s contract)."""
    dtype, dev = src.dtype, src.device
    I4 = torch.eye(4, dtype=dtype, device=dev)
    max_d2 = max_corr_dist * max_corr_dist

    def iteration(carry):
        T, n_corr, it, done = carry
        moved = _moved(src, T)
        d2, idx = _nn1(moved, src_valid, tgt, tgt_valid)
        w = (src_valid & (d2 < max_d2)).to(dtype)
        R, t = _rigid_from_correspondences(moved, tgt[idx.long()], w)
        dT = torch.cat([torch.cat([R, t[:, None]], 1), I4[3:]], 0)
        # the reference's loop condition: an iteration after the stop is a
        # no-op
        live = ~done
        T = torch.where(live, dT @ T, T)
        n_corr = torch.where(live, w.sum(), n_corr)
        it = it + live.to(torch.int32)
        # PCL's epsilon criteria on the incremental transform: translation^2
        # and cos(rotation angle) = (trace(R) - 1) / 2
        trans_small = torch.sum(t * t) <= translation_eps
        rot_small = (torch.trace(R) - 1.0) * 0.5 >= (1.0 - translation_eps)
        done = done | (trans_small & rot_small)
        return T, n_corr, it, done

    T, n_corr, it, _ = loop(iteration, (
        I4 if T0 is None else T0, torch.zeros((), dtype=dtype, device=dev),
        torch.zeros((), dtype=torch.int32, device=dev),
        torch.zeros((), dtype=torch.bool, device=dev)), iters)
    d2, _ = _nn1(_moved(src, T), src_valid, tgt, tgt_valid)
    nsrc = torch.clamp(torch.sum(src_valid), min=1)
    fitness = torch.sum(torch.where(src_valid, d2, 0.0)) / nsrc
    converged = (n_corr > 0) & torch.isfinite(fitness)
    return ICPResult(transform=T, fitness=fitness, converged=converged, iters=it)
