"""Correspondence search dispatch (the KD-tree replacement), the port of
``alego_tpu.ops.knn``.

``nn1_best`` / ``knn_best`` run the exact fused search of ``ops/nn.py``: the
CUDA kernel for tensors on the GPU, its plain version for tensors on the
CPU.  ``masked_argmin_dist`` stays plain tensor code, as in the reference
(a small masked matmul outside any kernel).  ``knn``, ``nn1`` and
``radius_count`` are the reference's searches by the expansion
``|q|^2 - 2 q.r + |r|^2`` over chunks of refs (plain tensor code; the
frame step does not call them).
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


def knn(query, qmask, ref, rmask, k: int, chunk: int = 4096):
    """k nearest refs per query by the expansion formula, refs in chunks
    with a running best: (d2 [Q, k] ascending, idx [Q, k] int32); invalid
    refs never win, invalid queries get BIG.  Ties go to the lower index
    (a stable sort, as the reference's ``lax.top_k``).  The reference skips
    trailing chunks without a valid ref; their candidates are all BIG and
    lose every tie to the running best, so visiting them changes nothing;
    nor does the padding of the last chunk, for the same reason."""
    Q, N = query.shape[0], ref.shape[0]
    q_sq = torch.sum(query * query, -1, keepdim=True)
    best_d = torch.full((Q, k), BIG, dtype=query.dtype, device=query.device)
    best_i = torch.zeros((Q, k), dtype=torch.int64, device=query.device)
    for c0 in range(0, N, chunk):
        rc, mc = ref[c0:c0 + chunk], rmask[c0:c0 + chunk]
        d2 = q_sq - 2.0 * (query @ rc.T) + torch.sum(rc * rc, -1)[None, :]
        d2 = torch.where(mc[None, :], d2, BIG)
        cand_d, pos = torch.sort(d2, dim=1, stable=True)
        cat_d = torch.cat([best_d, cand_d[:, :k]], 1)
        cat_i = torch.cat([best_i, pos[:, :k] + c0], 1)
        cat_d, order = torch.sort(cat_d, dim=1, stable=True)
        best_d, best_i = cat_d[:, :k], torch.gather(cat_i, 1, order[:, :k])
    best_d = torch.where(qmask[:, None], best_d, BIG)
    return torch.clamp(best_d, min=0.0), best_i.to(torch.int32)


def nn1(query, qmask, ref, rmask, chunk: int = 4096):
    """The 1-NN specialisation of :func:`knn`: per chunk the minimum and
    the first index holding it, kept where strictly better than the
    running best.  (d2 [Q], idx [Q] int32)."""
    Q, N = query.shape[0], ref.shape[0]
    q_sq = torch.sum(query * query, -1, keepdim=True)
    best_d = torch.full((Q,), BIG, dtype=query.dtype, device=query.device)
    best_i = torch.zeros(Q, dtype=torch.int64, device=query.device)
    for c0 in range(0, N, chunk):
        rc, mc = ref[c0:c0 + chunk], rmask[c0:c0 + chunk]
        d2 = q_sq - 2.0 * (query @ rc.T) + torch.sum(rc * rc, -1)[None, :]
        d2 = torch.where(mc[None, :], d2, BIG)
        idx = torch.argmin(d2, dim=1)
        m = torch.gather(d2, 1, idx[:, None])[:, 0]
        better = m < best_d
        best_d = torch.where(better, m, best_d)
        best_i = torch.where(better, idx + c0, best_i)
    best_d = torch.where(qmask, best_d, BIG)
    return torch.clamp(best_d, min=0.0), best_i.to(torch.int32)


def radius_count(query: torch.Tensor, ref: torch.Tensor, rmask: torch.Tensor,
                 radius: float) -> torch.Tensor:
    """Number of valid refs within ``radius`` of each query [Q] int32."""
    q_sq = torch.sum(query * query, -1, keepdim=True)
    r_sq = torch.sum(ref * ref, -1)[None, :]
    d2 = q_sq - 2.0 * (query @ ref.T) + r_sq
    return torch.sum((d2 <= radius * radius) & rmask[None, :], dim=1).to(torch.int32)
