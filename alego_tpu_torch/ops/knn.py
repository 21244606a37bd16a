"""Correspondence search dispatch (the KD-tree replacement), the port of
``alego_tpu.ops.knn``.

``nn1_best`` / ``knn_best`` run the exact fused search of ``ops/nn.py``: the
CUDA kernel for tensors on the GPU, its plain version for tensors on the
CPU.  ``masked_argmin_dist`` stays plain tensor code, as in the reference
(a small masked matmul outside any kernel).
"""

from __future__ import annotations

import torch

from . import nn

BIG = nn.BIG


def knn_best(query, qmask, ref, rmask, k: int):
    """k nearest refs per query: (d2 [Q, k] ascending, idx [Q, k] int32)."""
    if query.device.type == "cpu":
        return nn.knn_plain(query, qmask, ref, rmask, k)
    return nn.knn_cuda(query, qmask, ref, rmask, k)


def nn1_best(query, qmask, ref, rmask):
    """Nearest ref per query: (d2 [Q], idx [Q] int32)."""
    if query.device.type == "cpu":
        return nn.nn1_plain(query, qmask, ref, rmask)
    return nn.nn1_cuda(query, qmask, ref, rmask)


def masked_argmin_dist(query: torch.Tensor, ref: torch.Tensor,
                       ref_ok: torch.Tensor):
    """Per-query argmin over a small ref set with a per-query mask
    [Q, N] (the ring-constrained 2nd/3rd point searches, LO.cpp:419-466)."""
    q_sq = torch.sum(query * query, -1, keepdim=True)
    r_sq = torch.sum(ref * ref, -1)[None, :]
    d2 = q_sq - 2.0 * (query @ ref.T) + r_sq
    d2 = torch.where(ref_ok, d2, BIG)
    idx = torch.argmin(d2, dim=1)
    d = torch.gather(d2, 1, idx[:, None])[:, 0]
    return torch.clamp(d, min=0.0), idx.to(torch.int32)
