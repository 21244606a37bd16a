"""The reference's frame step and hoisted loop attempt: the program's
``slam_step`` with de-skew off (projection and segmentation, features,
two-step odometry, and on every ``map_frame_decimation``'th frame the
scan-to-map step with keyframe saves), and ``loop_closure_step`` as the host
runs it between frames.  State is NamedTuples of tensors, as the program's,
so a state of the program can be carried over field by field."""

from __future__ import annotations

from typing import NamedTuple

import torch

from .config import PipelineConfig
from .features import extract_features
from .image_projection import image_projection
from . import laser_mapping as lm
from . import laser_odometry as lo


class SlamState(NamedTuple):
    odo: lo.OdometryState
    mapping: lm.MappingState
    frame: torch.Tensor          # int32 frame counter
    T_odom2laser: torch.Tensor   # [4, 4]


def init_state(cfg: PipelineConfig, device, dtype=torch.float32) -> SlamState:
    return SlamState(odo=lo.init_state(cfg, device, dtype),
                     mapping=lm.init_state(cfg, device, dtype),
                     frame=torch.zeros((), dtype=torch.int32, device=device),
                     T_odom2laser=torch.eye(4, dtype=dtype, device=device))


def slam_step(state: SlamState, points: torch.Tensor, mask: torch.Tensor,
              time: torch.Tensor, cfg: PipelineConfig, do_map: bool):
    """One scan: returns (state, T_map2laser)."""
    if cfg.use_imu or cfg.use_odom or any(cfg.tf_b2l) or cfg.loop_in_step:
        raise ValueError("the reference runs de-skew off, no base-link "
                         "transform and the loop attempt hoisted")
    seg = image_projection(points, mask, cfg)
    fc = extract_features(seg, cfg)
    odo, T_odom2laser = lo.odometry_step(state.odo, fc, cfg)
    mapping = state.mapping
    if do_map:
        mapping, _ = lm.mapping_step(
            mapping, T_odom2laser, fc.less_sharp_pts, fc.less_sharp_valid,
            fc.less_flat_pts, fc.less_flat_valid, seg.outlier_points,
            seg.outlier_valid, time, cfg)
    new = SlamState(odo=odo, mapping=mapping, frame=state.frame + 1,
                    T_odom2laser=T_odom2laser)
    return new, mapping.T_map2odom @ T_odom2laser


def loop_step(state: SlamState, cfg: PipelineConfig) -> SlamState:
    """The hoisted loop attempt (its gate read on the host)."""
    if not bool(state.mapping.graph.count > 1):
        return state
    return state._replace(mapping=lm.loop_closure_step(state.mapping, cfg)[0])
