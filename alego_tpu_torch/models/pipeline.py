"""End-to-end SLAM frame step and the host loop that feeds it, the port of
``alego_tpu.models.pipeline`` (de-skew off: ``use_imu``/``use_odom``).

Per frame, ``slam_step`` runs projection, segmentation (the CCL kernel),
feature extraction, two-step odometry (the 1-NN kernel) and, on every
``map_frame_decimation``'th frame, scan-to-map mapping with keyframe saves
(the k-NN kernel).  Loop closure (ICP on the 1-NN kernel, acceptance on the
k = 1 k-NN kernel, the pose-graph solve) runs inside the step every
``loop_every_n_frames`` frames with ``loop_in_step=True`` (the config
default), or, with ``loop_in_step=False``, as the host loop's own call
between frames (``SlamPipeline._maybe_loop``).  State is NamedTuples of
tensors like the reference's; the keyframe store is updated in place.

Not ported yet: de-skew, checkpoints and the batched ``run_scanned`` path.
"""

from __future__ import annotations

import typing
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..config import PipelineConfig
from ..device import resolve_device
from ..ops import deskew, se3
from ..ops.features import extract_features
from .image_projection import image_projection
from . import laser_odometry as lo
from . import laser_mapping as lm


class SlamState(NamedTuple):
    odo: lo.OdometryState
    mapping: lm.MappingState
    frame: torch.Tensor          # int32 frame counter
    T_odom2laser: torch.Tensor   # [4, 4] latest odometry pose
    imu: deskew.ImuBuffer        # IMU buffer (layout parity; unused here)


def init_state(cfg: PipelineConfig, device=None, dtype=torch.float32) -> SlamState:
    dev = resolve_device(device)
    return SlamState(
        odo=lo.init_state(cfg, dev, dtype),
        mapping=lm.init_state(cfg, dev, dtype),
        frame=torch.zeros((), dtype=torch.int32, device=dev),
        T_odom2laser=torch.eye(4, dtype=dtype, device=dev),
        imu=deskew.init_buffer(cfg.imu_queue_length, dev, dtype),
    )


def slam_step(state: SlamState, points: torch.Tensor, mask: torch.Tensor,
              time: torch.Tensor, cfg: PipelineConfig, do_map_static=None,
              do_loop_static=None):
    """Process one raw scan. Returns (state, T_map2laser).

    ``do_map_static``: the every-2nd-frame mapping gate (LM.cpp:244-245) as
    a host bool; ``do_loop_static``: the ``loop_every_n_frames`` cadence of
    the in-step loop attempt (``loop_in_step=True``) as a host bool.  For
    either, ``None`` reads ``state.frame`` from the device."""
    if cfg.use_imu or cfg.use_odom:
        raise NotImplementedError("de-skew (use_imu/use_odom) is not ported yet")

    seg = image_projection(points, mask, cfg)
    fc = extract_features(seg, cfg)
    odo, T_odom2laser = lo.odometry_step(state.odo, fc, cfg)

    if do_map_static is None:
        do_map_static = int(state.frame) % cfg.map_frame_decimation == 0
    mapping = state.mapping
    if do_map_static:
        mapping, _ = lm.mapping_step(
            mapping, T_odom2laser,
            fc.less_sharp_pts, fc.less_sharp_valid,
            fc.less_flat_pts, fc.less_flat_valid,
            seg.outlier_points, seg.outlier_valid, time, cfg)

    # the loop attempt on a time cadence, the reference's 1 Hz thread
    # (LM.cpp:779-794); loop_closure_step itself reads whether a candidate
    # exists and the graph has two nodes (the reference's count > 1 gate)
    if cfg.loop_closure_enabled and cfg.loop_in_step:
        if do_loop_static is None:
            do_loop_static = int(state.frame) % cfg.loop_every_n_frames == 0
        if do_loop_static:
            mapping = lm.loop_closure_step(mapping, cfg)[0]

    T_map2laser = mapping.T_map2odom @ T_odom2laser
    new_state = SlamState(odo=odo, mapping=mapping, frame=state.frame + 1,
                          T_odom2laser=T_odom2laser, imu=state.imu)
    if any(cfg.tf_b2l):
        return new_state, T_map2laser @ _tf_l2b(cfg, T_map2laser)
    return new_state, T_map2laser


def _tf_l2b(cfg: PipelineConfig, like: torch.Tensor) -> torch.Tensor:
    """inv(T_b2l) from cfg.tf_b2l = (x, y, z, roll, pitch, yaw) of the laser
    in base-link (LO.cpp:591)."""
    params = torch.zeros(6, dtype=like.dtype, device=like.device)
    for i, v in enumerate(cfg.tf_b2l):
        params[i] = float(v)
    return se3.inv_mat(se3.params_to_mat(params))


# ---------------------------------------------------------------------------
# the state carried across from the reference
# ---------------------------------------------------------------------------

_DTYPES = {np.dtype(np.float32): torch.float32, np.dtype(np.bool_): torch.bool,
           np.dtype(np.int32): torch.int32}


def tree_from_reference(cls, tree, device=None, template=None, path="state"):
    """A NamedTuple tree of the reference (numpy or array-like leaves) as
    the port's NamedTuple ``cls`` on ``device``: fields matched by name,
    leaves checked for dtype (float32, bool or int32) and, against
    ``template`` when given, for shape."""
    return _convert(cls, tree, template, resolve_device(device), path)


def _convert(cls, node, template, dev, path):
    fields = getattr(node, "_fields", None)
    if fields is None or tuple(fields) != cls._fields:
        raise ValueError(f"{path}: expected fields {cls._fields}, got {fields}")
    hints = typing.get_type_hints(cls)
    out = {}
    for name in cls._fields:
        sub, sub_path = getattr(node, name), f"{path}.{name}"
        sub_tmpl = None if template is None else getattr(template, name)
        if hasattr(hints[name], "_fields"):
            out[name] = _convert(hints[name], sub, sub_tmpl, dev, sub_path)
            continue
        arr = np.asarray(sub)
        dtype = _DTYPES.get(arr.dtype)
        if dtype is None:
            raise ValueError(f"{sub_path}: unsupported dtype {arr.dtype}")
        if sub_tmpl is not None and (tuple(arr.shape) != tuple(sub_tmpl.shape)
                                     or dtype != sub_tmpl.dtype):
            raise ValueError(
                f"{sub_path}: {arr.dtype}{tuple(arr.shape)} does not match "
                f"{sub_tmpl.dtype}{tuple(sub_tmpl.shape)}")
        out[name] = torch.from_numpy(np.array(arr)).to(dev)
    return cls(**out)


def state_from_reference(tree, device=None, cfg: Optional[PipelineConfig] = None
                         ) -> SlamState:
    """The reference's ``SlamState`` (a NamedTuple tree of numpy arrays, e.g.
    ``jax.tree_util.tree_map(np.asarray, state)``) as this port's
    ``SlamState`` on ``device``.

    Leaves are matched by field name; each must be float32, bool or int32.
    With ``cfg`` every leaf's shape and dtype are also checked against this
    port's ``init_state(cfg)`` (built on the meta device: no memory)."""
    template = None if cfg is None else init_state(cfg, device="meta")
    return tree_from_reference(SlamState, tree, device, template)


# ---------------------------------------------------------------------------
# host side
# ---------------------------------------------------------------------------

class SlamPipeline:
    """Host-side runner around ``slam_step``: feeds padded scans, collects
    poses, exports the map.  Runs on ``cuda`` unless ``device`` says
    otherwise; the per-frame poses stay on the device until ``run`` stacks
    them."""

    _sync_every = 16      # frames between capacity checks (one host read)
    _compact_margin = 16  # compact this many keyframes before capacity

    def __init__(self, cfg: PipelineConfig, device=None, dtype=torch.float32):
        self.cfg = cfg
        self.device = resolve_device(device)
        self._dtype = dtype
        self.reset()

    def reset(self):
        """Fresh SLAM state."""
        self.state = init_state(self.cfg, self.device, self._dtype)
        self.poses = []
        self._frame = 0
        self._loop_live = False
        self.compactions = 0

    def _maybe_loop(self, frames_advanced: int):
        """Hoisted loop-closure attempt (``loop_in_step=False``): run
        ``loop_closure_step`` when the frame counter crossed a
        ``loop_every_n_frames`` boundary, the reference's own loop thread
        (LM.cpp:779-794).  One attempt per crossing, however many boundaries
        it spans: a second attempt on the same graph tip is a no-op."""
        cfg = self.cfg
        if not cfg.loop_closure_enabled or cfg.loop_in_step:
            return
        before = self._frame - frames_advanced
        if self._frame // cfg.loop_every_n_frames == before // cfg.loop_every_n_frames:
            return
        # the count > 1 guard reads the device; latched, it costs one read
        # per run
        if not self._loop_live:
            if int(self.state.mapping.graph.count) <= 1:
                return
            self._loop_live = True
        self.state = self.state._replace(
            mapping=lm.loop_closure_step(self.state.mapping, cfg)[0])

    def _maybe_compact(self):
        """Keep-mapping-forever policy: near capacity, thin old keyframes
        (``laser_mapping.compact_keyframes``) so new territory keeps mapping."""
        if int(self.state.mapping.graph.count) >= self.cfg.max_keyframes - self._compact_margin:
            self.state = self.state._replace(
                mapping=lm.compact_keyframes(self.state.mapping, self.cfg))
            self.compactions += 1

    def _to_device(self, a: np.ndarray, dtype) -> torch.Tensor:
        t = torch.as_tensor(a, dtype=dtype)
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.to(self.device)

    def process(self, points: np.ndarray, mask: np.ndarray,
                time: Optional[float] = None) -> torch.Tensor:
        """Feed one scan; returns the map-frame pose [4, 4] on the device."""
        t = self._frame * self.cfg.scan_period if time is None else time
        do_map = self._frame % self.cfg.map_frame_decimation == 0
        do_loop = self._frame % self.cfg.loop_every_n_frames == 0
        self.state, pose = slam_step(
            self.state, self._to_device(points, self._dtype),
            self._to_device(mask, torch.bool),
            torch.full((), t, dtype=self._dtype, device=self.device),
            self.cfg, do_map_static=do_map, do_loop_static=do_loop)
        self._frame += 1
        self._maybe_loop(1)
        self.poses.append(pose)
        if self._frame % self._sync_every == 0:
            self._maybe_compact()
        return pose

    def run(self, points_seq: np.ndarray, mask_seq: np.ndarray) -> np.ndarray:
        for k in range(points_seq.shape[0]):
            self.process(points_seq[k], mask_seq[k])
        return torch.stack(self.poses).cpu().numpy()

    def export_map(self):
        """The global map from the keyframes (the /save_map service,
        LM.cpp:1007-1055): dict of numpy arrays."""
        ms = self.state.mapping
        n = int(ms.graph.count)
        poses = ms.graph.poses[:n].cpu().numpy()
        out = {"keyposes": poses}
        for name, pts, val in (("corner", ms.kf_corner, ms.kf_corner_valid),
                               ("surf", ms.kf_surf, ms.kf_surf_valid),
                               ("outlier", ms.kf_outlier, ms.kf_outlier_valid)):
            pts, val = pts[:n].cpu().numpy(), val[:n].cpu().numpy()
            clouds = [pts[k][val[k]] @ poses[k][:3, :3].T + poses[k][:3, 3]
                      for k in range(n)]
            out[name] = (np.concatenate(clouds, 0) if clouds
                         else np.zeros((0, 3), np.float32))
        return out
