"""Exact nearest-neighbour searches for the reference: squared distances by
direct difference-squares in float32, +1e30 on invalid refs, 1e30 and index 0
for invalid queries, ties to the lower ref index (the contract the program's
``nn1`` / ``knn`` kernels keep).  The refs are streamed in chunks as large as
a [Q, chunk] buffer of 2**26 entries allows."""

from __future__ import annotations

import torch

BIG = 1e30
_BUFFER = 2 ** 26


def _chunk(Q: int, N: int, device: torch.device) -> int:
    if device.type == "cpu":
        return 1024
    return max(1024, min(N, _BUFFER // max(Q, 1)))


def knn_best(query, qmask, ref, rmask, k: int):
    """k nearest refs per query: (d2 [Q, k] ascending, idx [Q, k] int32)."""
    Q, N = query.shape[0], ref.shape[0]
    pen = torch.where(rmask, 0.0, BIG).to(query.dtype)
    if N < k:
        ref = torch.cat([ref, ref.new_zeros((k - N, 3))])
        pen = torch.cat([pen, pen.new_full((k - N,), BIG)])
    best_d = query.new_empty((Q, 0))
    best_i = torch.empty((Q, 0), dtype=torch.int64, device=query.device)
    width = min(_chunk(Q, ref.shape[0], query.device), ref.shape[0])
    for c0 in range(0, ref.shape[0], width):
        rc = ref[c0:c0 + width]
        d = ((query[:, None, 0] - rc[None, :, 0]) ** 2
             + (query[:, None, 1] - rc[None, :, 1]) ** 2
             + (query[:, None, 2] - rc[None, :, 2]) ** 2) + pen[None, c0:c0 + width]
        loc_d, loc_i = [], []
        for j in range(min(k, rc.shape[0])):
            if j:
                d.scatter_(1, a, float("inf"))
            a = torch.argmin(d, dim=1, keepdim=True)
            loc_d.append(torch.gather(d, 1, a))
            loc_i.append(a + c0)
        cat_d, order = torch.sort(torch.cat([best_d] + loc_d, 1), dim=1, stable=True)
        best_d = cat_d[:, :k]
        best_i = torch.gather(torch.cat([best_i] + loc_i, 1), 1, order[:, :k])
    qm = qmask[:, None]
    d = torch.where(qm, torch.clamp(best_d, min=0.0), BIG)
    i = torch.where(qm, torch.clamp(best_i, 0, N - 1), 0).to(torch.int32)
    return d, i


def nn1_best(query, qmask, ref, rmask):
    """Nearest ref per query: (d2 [Q], idx [Q] int32)."""
    d, i = knn_best(query, qmask, ref, rmask, 1)
    return d[:, 0], i[:, 0]


def masked_argmin_dist(query: torch.Tensor, ref: torch.Tensor, ref_ok: torch.Tensor):
    """Per-query argmin over a small ref set with a per-query mask [Q, N]
    (the ring-constrained 2nd/3rd point searches of the odometry); the
    program's own expansion |q|^2 - 2 q.r + |r|^2, kept as it is."""
    q_sq = torch.sum(query * query, -1, keepdim=True)
    r_sq = torch.sum(ref * ref, -1)[None, :]
    d2 = q_sq - 2.0 * (query @ ref.T) + r_sq
    d2 = torch.where(ref_ok, d2, BIG)
    idx = torch.argmin(d2, dim=1)
    d = torch.gather(d2, 1, idx[:, None])[:, 0]
    return torch.clamp(d, min=0.0), idx.to(torch.int32)
