# Frozen copy of alego_tpu_torch/ops/segmentation.py for the benchmark's reference: plain
# PyTorch only, its imports made local; see portbench/reference/__init__.py.
"""Range-image segmentation + compaction (stage-1 back half), the port of
``alego_tpu.ops.segmentation``.

Connected components of the range image (the reference's BFS flood fill,
IP.cpp:306-412) come from the CCL fixpoint (``ops/ccl.py``: the CUDA kernel
on the GPU, its plain version on the CPU).  Component validity
(IP.cpp:378-397) is counted by a scatter-add into a fixed [N + 1] buffer
in place of the TPU's sort-and-scan; it gives the same verdict per pixel
(``bincount`` would read the label maximum back to the host).  Compaction
into the ring-major layout (IP.cpp:254-287) is a stable sort on the keep key whose
order then gathers the payloads.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .config import PipelineConfig
from .ccl import ccl_labels
from .projection import RangeImage


class SegmentedScan(NamedTuple):
    """Ring-major compacted scan, the stage-1 -> stage-2 contract."""

    points: torch.Tensor   # [R, W, 3]
    ranges: torch.Tensor   # [R, W]
    cols: torch.Tensor     # [R, W] int32 original column index
    ground: torch.Tensor   # [R, W] bool
    valid: torch.Tensor    # [R, W] bool
    counts: torch.Tensor   # [R] int32 points per ring
    outlier_points: torch.Tensor  # [MO, 3]
    outlier_valid: torch.Tensor   # [MO] bool
    orient_start: torch.Tensor
    orient_diff: torch.Tensor
    outlier_cols: torch.Tensor    # [MO] int32


def _neighbor_connectivity(ranges: torch.Tensor, segmentable: torch.Tensor,
                           cfg: PipelineConfig):
    """Edges to the right (circular) and upper neighbour that pass the
    reference's angle criterion (IP.cpp:351-366)."""
    def trig(angle):
        a = torch.full((), angle, dtype=ranges.dtype, device=ranges.device)
        return torch.sin(a), torch.cos(a)

    def edge_ok(a, b, sin_a, cos_a):
        d1 = torch.maximum(a, b)
        d2 = torch.minimum(a, b)
        ang = torch.atan2(d2 * sin_a, d1 - d2 * cos_a)
        return ang > cfg.seg_theta

    sx, cx = trig(cfg.ang_res_x)
    sy, cy = trig(cfg.ang_res_y)
    right_rng = torch.roll(ranges, -1, dims=1)
    right_seg = torch.roll(segmentable, -1, dims=1)
    conn_right = segmentable & right_seg & edge_ok(ranges, right_rng, sx, cx)
    conn_up = (segmentable[:-1] & segmentable[1:]
               & edge_ok(ranges[:-1], ranges[1:], sy, cy))
    return conn_right, conn_up


def label_components(img: RangeImage, cfg: PipelineConfig):
    """CCL + component validity.  Returns (labels [R, H] int32, -1 off the
    segmentable pixels; seg_ok; outlier_px)."""
    segmentable = img.valid & ~img.ground
    conn_right, conn_up = _neighbor_connectivity(img.ranges, segmentable, cfg)
    labels = ccl_labels(conn_right.contiguous(), conn_up.contiguous())
    return _component_stats(labels, segmentable, cfg)


def component_sizes(labels: torch.Tensor, n: int) -> torch.Tensor:
    """Pixels per label: int64 [n] counts of ``labels`` (int64 in [0, n)),
    a scatter-add into a fixed buffer; ``torch.bincount`` on the card reads
    the largest label back to the host to size its output."""
    sizes = torch.zeros(n, dtype=torch.int64, device=labels.device)
    return sizes.index_add_(0, labels, torch.ones_like(labels))


def _component_stats(labels: torch.Tensor, segmentable: torch.Tensor,
                     cfg: PipelineConfig):
    """Segment validity (IP.cpp:378-397): a component is kept when it has
    >= seg_big_cluster pixels, or >= seg_valid_point_num pixels over
    >= seg_valid_line_num distinct rings."""
    R, H = labels.shape
    N = R * H
    lab = torch.where(segmentable, labels, N).long()       # N = no component
    sizes = component_sizes(lab.reshape(-1), N + 1)
    present = torch.zeros((R, N + 1), dtype=torch.bool, device=labels.device)
    present.scatter_(1, lab, True)
    rings = present.sum(0)
    ok_seg = (sizes >= cfg.seg_big_cluster) | (
        (sizes >= cfg.seg_valid_point_num) & (rings >= cfg.seg_valid_line_num))
    per_px_valid = ok_seg[lab]
    seg_ok = segmentable & per_px_valid
    outlier_px = segmentable & ~per_px_valid
    return torch.where(segmentable, labels, -1), seg_ok, outlier_px


def _stable_front(key: torch.Tensor, dim: int) -> torch.Tensor:
    """Order that moves key == 0 entries to the front, stably."""
    return torch.sort(key, dim=dim, stable=True)[1]


def compact(img: RangeImage, seg_ok: torch.Tensor, outlier_px: torch.Tensor,
            cfg: PipelineConfig) -> SegmentedScan:
    """Masked compaction into the ring-major layout (IP.cpp:254-287): valid
    segments always; ground only every ground_subsample'th column or within
    5 columns of the sweep edges; outliers above ring ground_scan_id at
    every outlier_subsample'th column (IP.cpp:263-277)."""
    R, H = img.ranges.shape
    W = cfg.ring_width
    dev = img.ranges.device
    cols = torch.arange(H, dtype=torch.int32, device=dev).expand(R, H)
    ground_keep = img.ground & ~(
        (cols % cfg.ground_subsample != 0) & (cols > 4) & (cols < H - 5))
    keep = seg_ok | ground_keep

    order = _stable_front((~keep).to(torch.int8), 1)
    if H < W:   # ring wider than the image (tiny geometries): pad
        pad = torch.full((R, W - H), H, dtype=order.dtype, device=dev)
        order = torch.cat([order, pad], 1)
    order = order[:, :W]
    in_img = order < H
    o = order.clamp(max=H - 1)
    valid = torch.gather(keep, 1, o) & in_img
    vpts = valid[..., None]
    pts = torch.where(vpts, torch.gather(img.points, 1, o[..., None].expand(R, W, 3)), 0.0)
    rng = torch.where(valid, torch.gather(img.ranges, 1, o), 0.0)
    col_out = torch.where(valid, o.to(torch.int32), 0)
    grd = valid & torch.gather(img.ground, 1, o)
    counts = keep.sum(1).to(torch.int32)

    g1 = cfg.ground_scan_id + 1
    s = cfg.outlier_subsample
    out_keep = outlier_px[g1:, ::s].reshape(-1)
    fp = img.points[g1:, ::s].reshape(-1, 3)
    o_col = cols[g1:, ::s].reshape(-1)
    if out_keep.shape[0] < cfg.max_outlier:
        deficit = cfg.max_outlier - out_keep.shape[0]
        out_keep = torch.cat([out_keep, out_keep.new_zeros(deficit)])
        fp = torch.cat([fp, fp.new_zeros((deficit, 3))])
        o_col = torch.cat([o_col, o_col.new_zeros(deficit)])
    o_order = _stable_front((~out_keep).to(torch.int8), 0)[: cfg.max_outlier]
    o_valid = out_keep[o_order]
    o_pts = torch.where(o_valid[:, None], fp[o_order], 0.0)
    o_cols = torch.where(o_valid, o_col[o_order], 0)

    return SegmentedScan(
        points=pts, ranges=rng, cols=col_out, ground=grd, valid=valid,
        counts=torch.clamp(counts, max=W),
        outlier_points=o_pts, outlier_valid=o_valid,
        orient_start=img.orient_start, orient_diff=img.orient_diff,
        outlier_cols=o_cols)


def segment_scan(img: RangeImage, cfg: PipelineConfig) -> SegmentedScan:
    """Full stage-1 back half: CCL + validity + compaction."""
    _, seg_ok, outlier_px = label_components(img, cfg)
    return compact(img, seg_ok, outlier_px, cfg)
