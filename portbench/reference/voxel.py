# Frozen copy of alego_tpu_torch/ops/voxel.py for the benchmark's reference: plain
# PyTorch only, its imports made local; see portbench/reference/__init__.py.
"""Deterministic voxel-grid centroid downsampling (pcl::VoxelGrid
equivalent) and masked front-compaction, the port of ``alego_tpu.ops.voxel``.

Output slots follow the reference exactly: voxels in ascending order of
their hashed key, and when more voxels than slots exist the ones with the
largest keys drop (``voxel_key``'s bit mixing spreads the loss uniformly in
space).  The centroid sums are plain f64 segment sums (``index_add_``); the
reference's compensated two-float prefix differences only work around TPU
compiler limits.
"""

from __future__ import annotations

import torch

from .device import const

_SENTINEL = 1 << 30
_M32 = 0xFFFFFFFF


def voxel_key(points: torch.Tensor, leaf: float, extent: float) -> torch.Tensor:
    """floor(p / leaf) packed into one non-negative key < 2^30 (int64),
    splitmix-style bit-mixed with the reference's uint32 arithmetic (done in
    int64 and masked to 32 bits: torch has no wrapping uint32 multiply)."""
    side = int(2 * extent / leaf) + 2
    assert side ** 3 < 2 ** 31, "voxel grid too fine for int32 keys"
    q = torch.floor(points / const(leaf, points)).to(torch.int32) + side // 2
    q = q.clamp(0, side - 1).long()
    u = (q[..., 0] * side + q[..., 1]) * side + q[..., 2]
    u = ((u ^ (u >> 16)) * 0x45D9F3B) & _M32
    u = ((u ^ (u >> 16)) * 0x45D9F3B) & _M32
    u = u ^ (u >> 16)
    return u >> 2


def voxel_downsample(points: torch.Tensor, mask: torch.Tensor, leaf: float,
                     cap: int, extent: float = 256.0):
    """Centroid-downsample a masked set into ``cap`` slots.

    points [..., N, 3] with mask [..., N]; leading dimensions are independent
    batches (one voxel grid each).  Returns (points [..., cap, 3],
    mask [..., cap])."""
    lead = points.shape[:-2]
    N = points.shape[-2]
    pts = points.reshape(-1, N, 3)
    msk = mask.reshape(-1, N)
    B = pts.shape[0]
    dev = points.device

    keys = torch.where(msk, voxel_key(pts, leaf, extent), _SENTINEL)
    batch = torch.arange(B, device=dev)[:, None]
    gkey = (batch << 31) | keys                      # batches sort apart
    skey, order = torch.sort(gkey.reshape(-1))
    alive = (skey & ((1 << 31) - 1)) < _SENTINEL
    first = alive & torch.cat([skey.new_ones(1, dtype=torch.bool),
                               skey[1:] != skey[:-1]])
    # no boolean indexing anywhere below: it would wait on the device for
    # the selected count; dead rows add zeros and write to a discard slot
    run = (torch.cumsum(first.long(), 0) - 1).clamp(min=0)   # global run index
    src = torch.where(alive[:, None], pts.reshape(-1, 3)[order], 0.0).double()
    sums = torch.zeros((B * N, 3), dtype=torch.float64, device=dev)
    sums.index_add_(0, run, src)
    cnt = torch.zeros(B * N, dtype=torch.float64, device=dev)
    cnt.index_add_(0, run, alive.double())

    # slot of a run = its rank inside its batch (ascending hashed key)
    run_batch = skey >> 31
    per_batch = torch.zeros(B, dtype=torch.int64, device=dev)
    per_batch.index_add_(0, run_batch, first.long())
    offset = torch.cumsum(per_batch, 0) - per_batch
    slot = run - offset[run_batch]
    put = first & (slot < cap)
    dest = torch.where(put, run_batch * cap + slot, B * cap)

    centroid = (sums[run] / cnt[run].clamp(min=1.0)[:, None]).to(points.dtype)
    out = torch.zeros((B * cap + 1, 3), dtype=points.dtype, device=dev)
    out_mask = torch.zeros(B * cap + 1, dtype=torch.bool, device=dev)
    out.index_put_((dest,), centroid)
    out_mask.index_put_((dest,), put)
    return (out[:-1].reshape(lead + (cap, 3)),
            out_mask[:-1].reshape(lead + (cap,)))


# Same algorithm, kept as an alias so call sites read like the reference.
voxel_downsample_exact = voxel_downsample


def compact_masked(points: torch.Tensor, mask: torch.Tensor, cap: int,
                   aux: torch.Tensor | None = None):
    """Stable front-compaction of a masked set into ``cap`` slots.

    Returns (points [cap, 3], mask [cap]) and, given ``aux``, aux [cap],
    with points and aux zeroed on empty slots."""
    n = points.shape[0]
    order = torch.sort((~mask).to(torch.int8), stable=True)[1]
    if n < cap:
        order = torch.cat([order, order.new_full((cap - n,), n)])
    order = order[:cap]
    in_set = order < n
    o = order.clamp(max=n - 1)
    out_mask = mask[o] & in_set
    out_pts = torch.where(out_mask[:, None], points[o], 0.0)
    if aux is None:
        return out_pts, out_mask
    return out_pts, out_mask, torch.where(out_mask, aux[o], 0)
