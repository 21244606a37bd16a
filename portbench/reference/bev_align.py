# Frozen copy of alego_tpu_torch/ops/bev_align.py for the benchmark's reference: plain
# PyTorch only, its imports made local; see portbench/reference/__init__.py.
"""Coarse loop-closure alignment by bird's-eye-view correlation, the port of
``alego_tpu.ops.bev_align``.

The identity-initialised loop ICP (LM.cpp:828-836) has a basin of a couple
of metres and tens of degrees.  This recovers a global (yaw, dx, dy, dz)
start instead:

1. each cloud becomes a G x G bird's-eye structure grid, its points weighted
   by height above their own ground level, so walls and poles dominate and
   the ground plane cancels;
2. the source grid is built under K yaw hypotheses (one scatter over all K);
3. every (yaw, shift) pair is scored at once by FFT cross-correlation
   (``torch.fft``: the reference computes it outside any kernel as well);
4. the best peak, normalised by the grid energies, gives the ICP start.

The scatters add duplicates in any order on the GPU (atomics), so a grid
cell may differ from the reference's by a few f32 ulps before the
saturation at 3.0; the chosen peak is the same wherever it is clear of the
runner-up by more than that.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .device import at, const


class BevAlignment(NamedTuple):
    transform: torch.Tensor   # [4, 4] map-frame correction (src -> tgt)
    score: torch.Tensor       # normalised correlation peak in [0, 1]
    yaw: torch.Tensor         # chosen yaw (rad)
    shift: torch.Tensor       # [3] chosen translation (m)


def _ground_z(pts, ok):
    """Approximate ground height: the 0.1-quantile of the valid z."""
    zs = torch.sort(torch.where(ok, pts[:, 2], float("inf")))[0]
    n = torch.clamp(torch.sum(ok), min=1)
    # an f32 product truncated to int32, as the reference computes it
    k = (n.to(torch.float32) * const(0.1, zs)).to(torch.int32)
    return at(zs, torch.clamp(k, 0, pts.shape[0] - 1))


def _structure_grid(pts, w, center_xy, G: int, res: float):
    """Scatter height-weighted occupancy into [..., G, G] grids around
    ``center_xy``; ``pts`` [..., N, 3] with weights [N] (leading dimensions
    are separate grids)."""
    rel = (pts[..., :2] - center_xy) / const(res, pts)
    ij = torch.floor(rel).to(torch.int32) + G // 2
    inb = ((ij[..., 0] >= 0) & (ij[..., 0] < G) & (ij[..., 1] >= 0)
           & (ij[..., 1] < G))
    wi = torch.where(inb, w, 0.0)
    ij = torch.clamp(ij, 0, G - 1).long()
    lead = pts.shape[:-2]
    B = math.prod(lead)
    flat = (torch.arange(B, device=pts.device).reshape(lead + (1,)) * (G * G)
            + ij[..., 0] * G + ij[..., 1])
    grid = torch.zeros(B * G * G, dtype=pts.dtype, device=pts.device)
    grid.index_put_((flat.reshape(-1),), wi.reshape(-1), accumulate=True)
    # saturate: a dense facade column should count like a sparse one
    return torch.clamp(grid, max=3.0).reshape(lead + (G, G))


def bev_align(src, src_ok, tgt, tgt_ok, c_src, c_tgt,
              grid: int = 96, res: float = 1.0, n_yaw: int = 24) -> BevAlignment:
    """Global coarse alignment of map-frame clouds src -> tgt.

    ``c_src`` / ``c_tgt``: xy grid centres (the latest / candidate keypose
    positions).  Returns the rigid transform (z rotation + 3-D translation)
    to apply to ``src``, rotating about the source centre.  The admissible
    translation is at most half the grid."""
    dtype, dev = src.dtype, src.device
    G, P = grid, 2 * grid                        # zero-padded FFT size
    gz_s = _ground_z(src, src_ok)
    gz_t = _ground_z(tgt, tgt_ok)
    # height-above-ground weights: ground ~0, walls saturate at 2 m
    w_s = torch.clamp(src[:, 2] - gz_s - 0.3, 0.0, 2.0) * src_ok
    w_t = torch.clamp(tgt[:, 2] - gz_t - 0.3, 0.0, 2.0) * tgt_ok
    tgt_g = _structure_grid(tgt, w_t, c_tgt, G, res)

    yaws = torch.arange(n_yaw, dtype=dtype, device=dev) * const(2.0 * math.pi / n_yaw, src)
    yaws = torch.where(yaws > math.pi, yaws - 2.0 * math.pi, yaws)
    cz, sz = torch.cos(yaws), torch.sin(yaws)
    R2 = torch.stack([torch.stack([cz, -sz], -1), torch.stack([sz, cz], -1)], -2)
    rot = (src[:, :2] - c_src)[None] @ R2.transpose(-1, -2) + c_src    # [K, N, 2]
    src_pts = torch.cat([rot, src[None, :, 2:].expand(n_yaw, -1, -1)], -1)
    src_gs = _structure_grid(src_pts, w_s, c_src, G, res)              # [K, G, G]

    # FFT cross-correlation on the zero-padded plane:
    #   corr_k[s] = sum_u src_k[u] * tgt[u + s]
    Ft = torch.fft.rfft2(tgt_g, s=(P, P))
    Fs = torch.fft.rfft2(src_gs, s=(P, P))
    corr = torch.fft.irfft2(torch.conj(Fs) * Ft[None], s=(P, P))      # [K, P, P]

    # admissible shifts only (wrapped indices decode to signed shifts)
    sidx = torch.arange(P, device=dev)
    sgn = torch.where(sidx >= G, sidx - P, sidx)
    oks = torch.abs(sgn) <= G // 2
    corr = torch.where(oks[None, :, None] & oks[None, None, :], corr, float("-inf"))

    flat = corr.reshape(n_yaw, -1)
    best_per_yaw = torch.argmax(flat, dim=1)
    val_per_yaw = torch.gather(flat, 1, best_per_yaw[:, None])[:, 0]
    k = torch.argmax(val_per_yaw)
    peak = at(val_per_yaw, k)
    bi = at(best_per_yaw, k)
    dx = at(sgn, bi // P).to(dtype) * res
    dy = at(sgn, bi % P).to(dtype) * res
    dz = gz_t - gz_s

    # normalised score: peak / (|src| |tgt|), 1.0 for identical grids
    es = torch.sqrt(torch.sum(at(src_gs, k) ** 2) * torch.sum(tgt_g ** 2))
    score = peak / torch.clamp(es, min=1e-6)

    yaw, c, s = at(yaws, k), at(cz, k), at(sz, k)
    zero, one = torch.zeros_like(c), torch.ones_like(c)
    Rz = torch.stack([torch.stack([c, -s, zero]), torch.stack([s, c, zero]),
                      torch.stack([zero, zero, one])])
    pivot = torch.stack([c_src[0], c_src[1], zero])
    # matching src cell u with tgt cell u + s places world point
    # c_src + u res at c_tgt + (u + s) res: the translation is the centre
    # offset plus the cell shift
    shift = torch.stack([c_tgt[0] - c_src[0] + dx, c_tgt[1] - c_src[1] + dy, dz])
    T = torch.eye(4, dtype=dtype, device=dev)
    T[:3, :3] = Rz
    T[:3, 3] = pivot - Rz @ pivot + shift
    return BevAlignment(transform=T, score=score, yaw=yaw, shift=shift)
