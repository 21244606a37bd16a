# Frozen copy of alego_tpu_torch/ops/features.py for the benchmark's reference: plain
# PyTorch only, its imports made local; see portbench/reference/__init__.py.
"""Corner/surf feature extraction (stage-2 front half), the port of
``alego_tpu.ops.features``.

Curvature (LO.cpp:193) and the occluded/parallel marks (LO.cpp:200-229) are
shifted-array ops along the ring axis.  Picking (LO.cpp:242-348) is the
reference's iterated masked argmax / argmin: by default all 6 sectors of
all 16 rings at once (the lane-parallel picker), or with
``parallel_sectors=False`` the reference's sequential picker, sector after
sector.  The reference vmaps the picker over rings, here the rings are a
batch dimension.  ``argmax``/``argmin`` return the first index on ties, as
JAX's do.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .config import PipelineConfig
from .segmentation import SegmentedScan
from .voxel import voxel_downsample_exact, compact_masked

NEG = -1e30
POS = 1e30


class FeatureClouds(NamedTuple):
    """Stage-2 feature sets; ``*_ring`` is the ring id of each point."""

    sharp_pts: torch.Tensor        # [MS, 3]
    sharp_valid: torch.Tensor      # [MS]
    sharp_ring: torch.Tensor       # [MS] int32
    less_sharp_pts: torch.Tensor   # [MLS, 3]
    less_sharp_valid: torch.Tensor
    less_sharp_ring: torch.Tensor
    flat_pts: torch.Tensor         # [MF, 3]
    flat_valid: torch.Tensor
    flat_ring: torch.Tensor
    less_flat_pts: torch.Tensor    # [MLF, 3]
    less_flat_valid: torch.Tensor
    less_flat_ring: torch.Tensor


def curvature_and_window(seg: SegmentedScan, cfg: PipelineConfig):
    """Curvature (LO.cpp:193-194) and the per-ring window where features may
    live: k in [5, count-7]."""
    r = seg.ranges
    acc = -10.0 * r
    for d in range(1, 6):
        acc = acc + torch.roll(r, d, dims=1) + torch.roll(r, -d, dims=1)
    curv = acc * acc
    k = torch.arange(r.shape[1], device=r.device)[None, :]
    in_window = (k >= 5) & (k <= seg.counts[:, None] - 7)
    return curv, in_window


def occlusion_mask(seg: SegmentedScan, cfg: PipelineConfig) -> torch.Tensor:
    """Initial neighbor_picked state from the occluded/parallel tests
    (LO.cpp:200-229), as one-sided dilations."""
    r, c = seg.ranges, seg.cols
    d2 = torch.roll(r, -1, dims=1)
    near = torch.abs(c - torch.roll(c, -1, dims=1)) < cfg.occl_col_gap
    both = seg.valid & torch.roll(seg.valid, -1, dims=1)
    cond1 = both & near & (r - d2 > cfg.occl_depth_jump)   # marks k-5..k
    cond2 = both & near & (d2 - r > cfg.occl_depth_jump)   # marks k+1..k+5

    picked = torch.zeros_like(seg.valid)
    for l in range(0, 6):
        picked = picked | torch.roll(cond1, -l, dims=1)
    for l in range(1, 6):
        picked = picked | torch.roll(cond2, l, dims=1)

    diff_prev = torch.abs(torch.roll(r, 1, dims=1) - r)
    diff_next = torch.abs(d2 - r)
    parallel = ((diff_prev > cfg.parallel_rel_diff * r)
                & (diff_next > cfg.parallel_rel_diff * r))
    return picked | parallel


def _suppress(picked, cols, k, do, cfg: PipelineConfig):
    """Mark up to ``suppress_neighbors`` neighbours each side of each ring's
    pick ``k`` [R], stopping at a column gap > ``suppress_col_gap``
    (LO.cpp:282-305), where ``do`` [R]: the reference's ``_suppress``.  The
    window's start is clamped into the ring as ``dynamic_slice`` clamps it
    (a real pick's window is in bounds: sp >= 5, ep <= count - 7)."""
    ns = cfg.suppress_neighbors
    W = picked.shape[1]
    start = torch.clamp(k - ns, 0, W - (2 * ns + 1))
    win = start[:, None] + torch.arange(2 * ns + 1, device=k.device)
    win_cols = torch.gather(cols, 1, win)
    ok_gap = torch.abs(win_cols[:, 1:] - win_cols[:, :-1]) <= cfg.suppress_col_gap
    fwd = torch.cumprod(ok_gap[:, ns:].to(torch.int32), 1).bool()
    bwd = torch.cumprod(ok_gap[:, :ns].flip(1).to(torch.int32), 1).bool().flip(1)
    upd = torch.cat([bwd, torch.zeros_like(fwd[:, :1]), fwd], 1) & do[:, None]
    return picked.scatter(1, win, torch.gather(picked, 1, win) | upd)


def _pick_rings_sequential(curv, cols, ground, picked0, in_window, count,
                           cfg: PipelineConfig):
    """The reference's sequential sector picking (``_pick_ring``), batched
    over rings: sector after sector, the corner pass (descending curvature,
    up to ``max_less_sharp_per_sector + 2`` steps including the one that
    overflows) then the flat pass (ascending curvature, ground only).
    Returns labels [R, W] int32 as :func:`_pick_rings_parallel`."""
    R, W = curv.shape
    dev = curv.device
    idxs = torch.arange(W, dtype=torch.int32, device=dev)
    label = torch.zeros((R, W), dtype=torch.int32, device=dev)
    picked = picked0 | ~in_window
    diff = count - 11                      # end - start with end = count - 6
    S = cfg.n_sectors
    for j in range(S):
        sp = 5 + torch.div(j * diff, S, rounding_mode="floor")
        ep = 5 + torch.div((j + 1) * diff, S, rounding_mode="floor") - 1
        sector_ok = (sp < ep) & (diff > 0)
        in_sector = ((idxs >= sp[:, None]) & (idxs <= ep[:, None])
                     & sector_ok[:, None] & in_window)

        # corner pass: descending curvature (LO.cpp:260-307)
        n = torch.zeros(R, dtype=torch.int32, device=dev)
        stopped = torch.zeros(R, dtype=torch.bool, device=dev)
        for _ in range(cfg.max_less_sharp_per_sector + 2):
            elig = in_sector & ~picked & (curv > cfg.edge_curv_thresh) & ~ground
            has = elig.any(1) & ~stopped
            k = torch.argmax(torch.where(elig, curv, NEG), 1)
            n = n + has.to(torch.int32)
            lab_val = torch.where(n <= cfg.max_sharp_per_sector, 2,
                                  torch.where(n <= cfg.max_less_sharp_per_sector, 1, 0))
            overflow = n > cfg.max_less_sharp_per_sector
            at_k = idxs == k[:, None]
            label = torch.where(at_k & (has & ~overflow)[:, None],
                                lab_val.to(torch.int32)[:, None], label)
            picked = picked | (at_k & has[:, None])
            picked = _suppress(picked, cols, k, has & ~overflow, cfg)
            stopped = stopped | (has & overflow)

        # flat pass: ascending curvature, ground only (LO.cpp:309-348)
        n = torch.zeros(R, dtype=torch.int32, device=dev)
        for _ in range(cfg.max_flat_per_sector):
            elig = in_sector & ~picked & (curv < cfg.edge_curv_thresh) & ground
            has = elig.any(1)
            k = torch.argmin(torch.where(elig, curv, POS), 1)
            n = n + has.to(torch.int32)
            hit = (idxs == k[:, None]) & has[:, None]
            label = torch.where(hit, -1, label)
            picked = picked | hit
            picked = _suppress(picked, cols, k, has & (n < cfg.max_flat_per_sector), cfg)
    return label


def _pick_rings_parallel(curv, cols, ground, picked0, in_window, count,
                         cfg: PipelineConfig):
    """All 6 sectors of every ring pick simultaneously each step (the
    reference's ``_pick_ring_parallel``, batched over rings).

    curv/cols/ground/picked0/in_window [R, W], count [R]; returns labels
    [R, W] int32: 2 sharp, 1 less-sharp, -1 flat, 0 none."""
    R, W = curv.shape
    S = cfg.n_sectors
    ns = cfg.suppress_neighbors
    dev = curv.device
    idxs = torch.arange(W, dtype=torch.int32, device=dev)
    j = torch.arange(S, dtype=torch.int32, device=dev)
    diff = (count - 11)[:, None]                                   # [R, 1]
    sp = 5 + torch.div(j * diff, S, rounding_mode="floor")          # [R, S]
    ep = 5 + torch.div((j + 1) * diff, S, rounding_mode="floor") - 1
    sector_ok = (sp < ep) & (diff > 0)
    in_sector = ((idxs >= sp[..., None]) & (idxs <= ep[..., None])
                 & sector_ok[..., None] & in_window[:, None, :])   # [R, S, W]

    label = torch.zeros((R, W), dtype=torch.int32, device=dev)
    picked = picked0 | ~in_window

    # Gf[l-1][:, i]: the l column gaps starting at i are all small, i.e.
    # position i+l is reachable from a pick at i (and i from a pick at i+l)
    gap_ok = torch.cat([torch.abs(cols[:, 1:] - cols[:, :-1]) <= cfg.suppress_col_gap,
                        torch.zeros((R, 1), dtype=torch.bool, device=dev)], 1)
    Gf = []
    for l in range(1, ns + 1):
        shifted = torch.roll(gap_ok, -(l - 1), dims=1)
        if l > 1:
            shifted[:, W - (l - 1):] = False
        Gf.append((Gf[-1] if Gf else torch.ones_like(gap_ok)) & shifted)

    def onehot(kj):
        return idxs == kj[..., None]                               # [R, S, W]

    def suppression(kj, do):
        """[R, S] picks -> OR of their gap-limited +-5 windows."""
        m = torch.zeros((R, S, W), dtype=torch.bool, device=dev)
        for l in range(1, ns + 1):
            gf_at_k = torch.gather(Gf[l - 1], 1, kj.long())         # [R, S]
            m = m | ((idxs == (kj + l)[..., None]) & gf_at_k[..., None])
            m = m | ((idxs == (kj - l)[..., None]) & Gf[l - 1][:, None, :])
        return torch.any(m & do[..., None], dim=1)

    def picks_mask(kj, do):
        return torch.any(onehot(kj) & do[..., None], dim=1)

    corner_ok = (curv > cfg.edge_curv_thresh) & ~ground
    n = torch.zeros((R, S), dtype=torch.int32, device=dev)
    stopped = torch.zeros((R, S), dtype=torch.bool, device=dev)
    for _ in range(cfg.max_less_sharp_per_sector + 1):
        elig = in_sector & (corner_ok & ~picked)[:, None, :]
        has = elig.any(dim=2) & ~stopped
        kj = torch.argmax(torch.where(elig, curv[:, None, :], NEG), dim=2).to(torch.int32)
        n = n + has.to(torch.int32)
        lab_val = torch.where(n <= cfg.max_sharp_per_sector, 2,
                              torch.where(n <= cfg.max_less_sharp_per_sector, 1, 0))
        overflow = n > cfg.max_less_sharp_per_sector
        do_label = has & ~overflow
        upd = torch.sum((onehot(kj) & do_label[..., None]) * lab_val[..., None],
                        dim=1, dtype=torch.int32)        # sectors are disjoint
        label = torch.where(upd > 0, upd, label)
        picked = picked | picks_mask(kj, has)
        picked = picked | suppression(kj, do_label)
        stopped = stopped | (has & overflow)

    flat_ok = (curv < cfg.edge_curv_thresh) & ground
    n = torch.zeros((R, S), dtype=torch.int32, device=dev)
    for _ in range(cfg.max_flat_per_sector):
        elig = in_sector & (flat_ok & ~picked)[:, None, :]
        has = elig.any(dim=2)
        kj = torch.argmin(torch.where(elig, curv[:, None, :], POS), dim=2).to(torch.int32)
        n = n + has.to(torch.int32)
        pm = picks_mask(kj, has)
        label = torch.where(pm, -1, label)
        picked = picked | pm
        picked = picked | suppression(kj, has & (n < cfg.max_flat_per_sector))
    return label


def extract_features(seg: SegmentedScan, cfg: PipelineConfig) -> FeatureClouds:
    R, W = seg.ranges.shape
    curv, in_window = curvature_and_window(seg, cfg)
    picked0 = occlusion_mask(seg, cfg)
    picker = _pick_rings_parallel if cfg.parallel_sectors else _pick_rings_sequential
    labels = picker(curv, seg.cols, seg.ground, picked0, in_window, seg.counts, cfg)

    ring_ids = torch.arange(R, dtype=torch.int32,
                            device=curv.device)[:, None].expand(R, W).reshape(-1)
    flat_pts = seg.points.reshape(-1, 3)

    def gather(mask, cap):
        return compact_masked(flat_pts, mask.reshape(-1), cap, aux=ring_ids)

    sharp_pts, sharp_valid, sharp_ring = gather(labels == 2, cfg.max_sharp)
    ls_pts, ls_valid, ls_ring = gather(labels >= 1, cfg.max_less_sharp)
    fl_pts, fl_valid, fl_ring = gather(labels == -1, cfg.max_flat)

    # less-flat: every sector point with label <= 0, voxel 0.4 per ring
    lf_mask = (labels <= 0) & in_window & seg.valid
    cap_ring = cfg.max_less_flat // R
    lf_pts, lf_valid = voxel_downsample_exact(seg.points, lf_mask,
                                              cfg.less_flat_leaf, cap_ring)
    lf_ring = torch.arange(R, dtype=torch.int32,
                           device=curv.device)[:, None].expand(R, cap_ring)

    return FeatureClouds(
        sharp_pts=sharp_pts, sharp_valid=sharp_valid, sharp_ring=sharp_ring,
        less_sharp_pts=ls_pts, less_sharp_valid=ls_valid, less_sharp_ring=ls_ring,
        flat_pts=fl_pts, flat_valid=fl_valid, flat_ring=fl_ring,
        less_flat_pts=lf_pts.reshape(-1, 3), less_flat_valid=lf_valid.reshape(-1),
        less_flat_ring=lf_ring.reshape(-1),
    )
