# Frozen copy of alego_tpu_torch/models/image_projection.py for the benchmark's reference: plain
# PyTorch only, its imports made local; see portbench/reference/__init__.py.
"""Stage 1: raw scan -> segmented ring-major cloud, the port of
``alego_tpu.models.image_projection`` (the reference's whole ``IP`` node,
IP.cpp:106-304)."""

from __future__ import annotations

import torch

from .config import PipelineConfig
from .projection import project_scan
from .segmentation import segment_scan, SegmentedScan


def image_projection(points: torch.Tensor, mask: torch.Tensor,
                     cfg: PipelineConfig) -> SegmentedScan:
    """points [N, 3] padded raw scan + validity mask -> SegmentedScan."""
    return segment_scan(project_scan(points, mask, cfg), cfg)
