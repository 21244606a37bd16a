"""The row-sharded map 5-NN (per-rank map work O(N/D)), the port of
``alego_tpu.parallel.map_shard``.

Each rank owns 1/D of the map rows, answers the k-NN query against only its
shard (the k-NN kernel on the card, its plain version on the CPU), adds its
global row offset and gathers its own candidates' coordinates; the [D, Q, k]
candidates are then all-gathered and merged, O(D * Q * k) traffic whatever
the map's size.

The merge keeps ``lax.top_k``'s order over the rank-major concatenation
[Q, D * k]: ascending d2, and on ties the lower position (the lower rank,
then the lower slot), which a stable sort gives (``torch.topk`` promises no
order).  Fill slots (d2 = 1e30) carry the kernel's fill indices, which
differ from the Pallas kernel's (ROADMAP §3); every consumer masks them.
"""

from __future__ import annotations

import torch

from ..ops.knn import knn_best
from .comm import Comm


def make_sharded_map_knn(comm: Comm, k: int):
    """fn(query [Q, 3], qmask [Q], map_pts [N/D, 3], map_ok [N/D]) ->
    (d2 [Q, k] ascending, idx [Q, k] int32 GLOBAL rows, coords [Q, k, 3]),
    the map arguments being this rank's shard (:func:`shard_map_points`) and
    the query the same on every rank.  Each neighbour's coordinates are
    gathered from its own rank's shard, so no consumer gathers rows of the
    sharded store."""

    def knn(query, qmask, map_pts, map_ok):
        d_loc, i_loc = knn_best(query, qmask, map_pts, map_ok, k)
        coords = map_pts[i_loc.long()]
        if comm.size == 1:   # one sorted list: the merge is the identity
            return d_loc, i_loc, coords
        i_glob = i_loc + comm.rank * map_pts.shape[0]
        # one gather of the packed candidates (the indices ride as f32 bits)
        cand = comm.all_gather(torch.cat([d_loc[..., None],
                                          i_glob.view(torch.float32)[..., None], coords], -1))
        Q, D = query.shape[0], comm.size                     # cand [D, Q, k, 5]
        cand = cand.permute(1, 0, 2, 3).reshape(Q, D * k, 5)
        pos = torch.sort(cand[..., 0], dim=1, stable=True)[1][:, :k]
        best = torch.gather(cand, 1, pos[..., None].expand(-1, -1, 5))
        return (best[..., 0].contiguous(), best[..., 1].contiguous().view(torch.int32),
                best[..., 2:].contiguous())

    return knn


def shard_map_points(comm: Comm, pts: torch.Tensor, ok: torch.Tensor):
    """This rank's rows of a [N, ...] map, N padded to a multiple of the
    group size with invalid rows."""
    D = comm.size
    N = pts.shape[0]
    pad = (-N) % D
    if pad:
        pts = torch.cat([pts, pts.new_zeros((pad,) + pts.shape[1:])], 0)
        ok = torch.cat([ok, ok.new_zeros((pad,))], 0)
    nb = pts.shape[0] // D
    lo = comm.rank * nb
    return pts[lo:lo + nb].contiguous(), ok[lo:lo + nb].contiguous()


def per_device_map_bytes(n_points: int, n_devices: int) -> int:
    """Map-store bytes per rank: [N/D, 3] f32 + [N/D] bool."""
    rows = -(-n_points // n_devices)
    return rows * (3 * 4 + 1)
