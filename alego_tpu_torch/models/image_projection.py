"""Stage 1: raw scan -> segmented ring-major cloud, the port of
``alego_tpu.models.image_projection`` (the reference's whole ``IP`` node,
IP.cpp:106-304)."""

from __future__ import annotations

import torch

from ..config import PipelineConfig
from ..ops.projection import project_scan
from ..ops.segmentation import segment_scan, SegmentedScan


def image_projection(points: torch.Tensor, mask: torch.Tensor,
                     cfg: PipelineConfig) -> SegmentedScan:
    """points [N, 3] padded raw scan + validity mask -> SegmentedScan."""
    return segment_scan(project_scan(points, mask, cfg), cfg)
