"""End-to-end SLAM frame step and the host loop that feeds it, the port of
``alego_tpu.models.pipeline``.

Per frame, ``slam_step`` runs projection, segmentation (the CCL kernel),
the IMU/odometry de-skew of the segmented and outlier clouds (``use_imu`` /
``use_odom``), feature extraction, two-step odometry (the 1-NN kernel) and,
on every ``map_frame_decimation``'th frame, scan-to-map mapping with
keyframe saves (the k-NN kernel).  Loop closure (ICP on the 1-NN kernel,
acceptance on the k = 1 k-NN kernel, the pose-graph solve) runs inside the
step every ``loop_every_n_frames`` frames with ``loop_in_step=True`` (the
config default), or, with ``loop_in_step=False``, as the host loop's own
call between frames or chunks (``SlamPipeline._maybe_loop``).  State is
NamedTuples of tensors like the reference's; the keyframe store is updated
in place.  Nothing inside the step is read on the host, so it can be
captured in a CUDA graph.

``SlamPipeline`` holds one static ``SlamState`` whose tensors never move:
each frame writes its results back into them (the counterpart of the
reference's ``donate_argnums=0``), and so does every update between frames
(loop attempts, compaction, IMU input, reset, checkpoint loads).  On the
card the frame step is replayed from CUDA graphs (``step_graph``), and the
loop attempt, once the host has read its gate, from its own
(``loop_graph``); on the CPU both run eagerly.  It feeds scans one by one
(``process``) or
in chunks (``run_scanned``, the CLI's streaming path: the reference's
``lax.scan`` becomes a host loop over the chunk with the mapping gate taken
from the frame phase the host knows), buffers IMU samples host-side,
exports the map and writes schema-checked checkpoints.
"""

from __future__ import annotations

import typing
import warnings
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..config import PipelineConfig
from ..device import resolve_device, vector
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
    imu: deskew.ImuBuffer        # IMU integration buffer (used if use_imu/use_odom)


def init_state(cfg: PipelineConfig, device=None, dtype=torch.float32) -> SlamState:
    dev = resolve_device(device)
    return SlamState(
        odo=lo.init_state(cfg, dev, dtype),
        mapping=lm.init_state(cfg, dev, dtype),
        frame=torch.zeros((), dtype=torch.int32, device=dev),
        T_odom2laser=torch.eye(4, dtype=dtype, device=dev),
        imu=deskew.init_buffer(cfg.imu_queue_length, dev, dtype),
    )


def front_step(state: SlamState, points: torch.Tensor, mask: torch.Tensor,
               time: torch.Tensor, cfg: PipelineConfig):
    """The frame step's front half, everything before the map state:
    projection and segmentation, de-skew (``use_imu`` / ``use_odom``),
    features and odometry.  Returns (odo_state, T_odom2laser, features,
    segmented scan)."""
    seg = image_projection(points, mask, cfg)
    # de-skew the segmented cloud (LO.cpp:184; the odometry-aided variant
    # LO.cpp:737-795 shares the buffer and the interpolation); the outlier
    # cloud moves with it, since the surf map merges both (LM.cpp:385-387)
    if cfg.use_imu or cfg.use_odom:
        pts_ds = deskew.deskew(seg.points, seg.cols, seg.valid, time,
                               state.imu, cfg, orient_start=seg.orient_start,
                               orient_diff=seg.orient_diff)
        out_ds = deskew.deskew(seg.outlier_points, seg.outlier_cols,
                               seg.outlier_valid, time, state.imu, cfg,
                               orient_start=seg.orient_start,
                               orient_diff=seg.orient_diff)
        seg = seg._replace(points=pts_ds, outlier_points=out_ds)
    fc = extract_features(seg, cfg)
    odo, T_odom2laser = lo.odometry_step(state.odo, fc, cfg)
    return odo, T_odom2laser, fc, seg


def slam_step(state: SlamState, points: torch.Tensor, mask: torch.Tensor,
              time: torch.Tensor, cfg: PipelineConfig, do_map_static=None,
              do_loop_static=None, assoc=None, graph_optimizer=None, read=bool,
              tf_l2b=None):
    """Process one raw scan. Returns (state, T_map2laser).

    ``do_map_static``: the every-2nd-frame mapping gate (LM.cpp:244-245) as
    a host bool; ``do_loop_static``: the ``loop_every_n_frames`` cadence of
    the in-step loop attempt (``loop_in_step=True``) as a host bool.  For
    either, ``None`` reads ``state.frame`` from the device.  ``assoc`` goes
    to ``mapping_step``, ``graph_optimizer`` and ``read`` to
    ``loop_closure_step`` (the distributed pipeline's hooks).  ``tf_l2b``:
    :func:`tf_l2b` of ``cfg``, computed once by the caller (by default here,
    when ``cfg.tf_b2l`` is set).  With both gates given and no loop attempt,
    nothing is read on the host."""
    odo, T_odom2laser, fc, seg = front_step(state, points, mask, time, cfg)

    if do_map_static is None:
        do_map_static = int(state.frame) % cfg.map_frame_decimation == 0
    mapping = state.mapping
    if do_map_static:
        mapping, _ = lm.mapping_step(
            mapping, T_odom2laser,
            fc.less_sharp_pts, fc.less_sharp_valid,
            fc.less_flat_pts, fc.less_flat_valid,
            seg.outlier_points, seg.outlier_valid, time, cfg, assoc=assoc)

    # the loop attempt on a time cadence, the reference's 1 Hz thread
    # (LM.cpp:779-794); loop_closure_step itself reads whether a candidate
    # exists and the graph has two nodes (the reference's count > 1 gate)
    if cfg.loop_closure_enabled and cfg.loop_in_step:
        if do_loop_static is None:
            do_loop_static = int(state.frame) % cfg.loop_every_n_frames == 0
        if do_loop_static:
            mapping = lm.loop_closure_step(mapping, cfg, graph_optimizer=graph_optimizer,
                                           read=read)[0]

    new_state = SlamState(odo=odo, mapping=mapping, frame=state.frame + 1,
                          T_odom2laser=T_odom2laser, imu=state.imu)
    return new_state, frame_pose(mapping, T_odom2laser, cfg, tf_l2b)


def frame_pose(mapping: lm.MappingState, T_odom2laser: torch.Tensor,
               cfg: PipelineConfig, l2b=None) -> torch.Tensor:
    """A frame's output pose: T_map2odom @ T_odom2laser, followed by
    inv(T_b2l) when ``cfg.tf_b2l`` is set (``l2b``, or computed here)."""
    T_map2laser = mapping.T_map2odom @ T_odom2laser
    if any(cfg.tf_b2l):
        return T_map2laser @ (tf_l2b(cfg, T_map2laser) if l2b is None else l2b)
    return T_map2laser


def tf_l2b(cfg: PipelineConfig, like: torch.Tensor) -> torch.Tensor:
    """inv(T_b2l) from cfg.tf_b2l = (x, y, z, roll, pitch, yaw) of the laser
    in base-link (LO.cpp:591)."""
    return se3.inv_mat(se3.params_to_mat(vector(cfg.tf_b2l, like.dtype, like.device)))


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

def _flatten(tree, path="state"):
    """(path, tensor) leaves of a NamedTuple tree in field order, depth
    first: the order of the reference's ``jax.tree_util.tree_flatten``."""
    out = []
    for name, sub in zip(tree._fields, tree):
        if hasattr(sub, "_fields"):
            out += _flatten(sub, f"{path}.{name}")
        else:
            out.append((f"{path}.{name}", sub))
    return out


def _unflatten(template, leaves):
    """The tree of ``template``'s NamedTuple types with ``leaves`` (in
    :func:`_flatten`'s order) in its places."""
    it = iter(leaves)

    def build(node):
        return type(node)(*[build(sub) if hasattr(sub, "_fields") else next(it)
                            for sub in node])
    return build(template)


def _check_layout(dst, src):
    """Raise ``ValueError`` unless ``src`` has ``dst``'s fields, and each
    leaf its shape, dtype and device."""
    d_leaves, s_leaves = _flatten(dst), _flatten(src)
    if [p for p, _ in d_leaves] != [p for p, _ in s_leaves]:
        raise ValueError("state fields differ from the pipeline's")
    for (path, d), (_, t) in zip(d_leaves, s_leaves):
        if t.shape != d.shape or t.dtype != d.dtype or t.device != d.device:
            raise ValueError(f"{path}: {t.dtype}{tuple(t.shape)} on {t.device} does not "
                             f"match {d.dtype}{tuple(d.shape)} on {d.device}")


def commit(dst: SlamState, src: SlamState):
    """Write the state ``src`` into the tensors of ``dst`` in place, leaf by
    leaf; a leaf that already is its destination (the keyframe store, which
    the step writes in place) is skipped.  Reads nothing on the host, so it
    can be captured with the step."""
    _check_layout(dst, src)
    for (_, d), (_, t) in zip(_flatten(dst), _flatten(src)):
        if not (t.data_ptr() == d.data_ptr() and t.stride() == d.stride()):
            d.copy_(t)


class FrameInputs:
    """The frame step's static inputs: ``points`` [P, 3], ``mask`` [P] and
    ``time`` (0-dim), allocated at the first scan and again only when the
    scans' padded length changes.  On the card each scan is copied from one
    of ``RING`` pinned host slots, allocated once and reused in turn: the
    host writes a slot again only once its last copy has finished (its
    event), so it can run ``RING`` frames ahead of the device before it
    waits."""

    RING = 16

    def __init__(self, device: torch.device, dtype):
        self.device, self.dtype = device, dtype
        self.points = self.mask = None
        self.time = torch.zeros((), dtype=dtype, device=device)
        self._slots = []
        self._next = 0

    def feed(self, points: np.ndarray, mask: np.ndarray, t: float) -> bool:
        """Copy one scan into the static inputs (asynchronously on the
        card).  True when the buffers were (re)allocated."""
        points, mask = np.asarray(points), np.asarray(mask)
        moved = self.points is None or tuple(self.points.shape) != points.shape
        if moved:
            self.points = torch.zeros(points.shape, dtype=self.dtype, device=self.device)
            self.mask = torch.zeros(mask.shape, dtype=torch.bool, device=self.device)
            self._slots, self._next = [], 0
        self.time.fill_(float(t))
        if self.device.type != "cuda":
            self.points.copy_(torch.from_numpy(points))
            self.mask.copy_(torch.from_numpy(mask))
            return moved
        if len(self._slots) < self.RING:
            self._slots.append((torch.empty(points.shape, dtype=self.dtype, pin_memory=True),
                                torch.empty(mask.shape, dtype=torch.bool, pin_memory=True),
                                torch.cuda.Event()))
        host_pts, host_mask, copied = self._slots[self._next % self.RING]
        self._next += 1
        if not copied.query():
            copied.synchronize()
        host_pts.numpy()[...] = points
        host_mask.numpy()[...] = mask
        self.points.copy_(host_pts, non_blocking=True)
        self.mask.copy_(host_mask, non_blocking=True)
        copied.record()
        return moved


class SlamPipeline:
    """Host-side runner around ``slam_step``: feeds padded scans one by one
    (``process``) or in chunks (``run_scanned``), buffers IMU samples and
    flushes them before each scan or chunk, collects poses, exports the map
    and writes checkpoints.  Runs on ``cuda`` unless ``device`` says
    otherwise; the per-frame poses stay on the device until they are read.

    The state is static: ``state``'s tensors stay where they are for the
    pipeline's life, and every update (each frame, the hoisted loop
    attempt, compaction, IMU and odometry input, ``reset``,
    ``load_checkpoint``) is written into them (:func:`commit`).  On the
    card the frame step (front half and, on mapping frames, the mapping
    step) replays CUDA graphs captured at the first frame
    (``step_graph.StepGraphs``: no host sync inside a frame, no eager
    fallback: a step that cannot be captured raises), and the loop attempt,
    hoisted or in-step, replays the graph captured at the first attempt
    whose gate passes (``loop_graph.LoopAttemptGraph``, in the step graphs'
    memory pool) after one host read of that gate; compaction and the
    overflow check stay eager between frames, with one host read each.
    Assigning ``state`` adopts the given tree as the static state (the
    graphs are captured again when next needed).

    ``collect_odom_poses`` (debug only) keeps each frame's ``T_odom2laser``
    of the ``process`` path in ``odom_poses`` as numpy, one host read per
    frame."""

    _sync_every = 16       # frames between capacity checks (one host read)
    _overflow_every = 128  # frames between overflow checks on ``process``
    # the distributed pipeline's hooks (parallel/distributed.py): the map
    # association, the pose-graph solve, and how the host reads the device
    # flags it branches on
    _assoc = None
    _graph_optimizer = None
    _read = bool
    # replay the frame step from CUDA graphs on the card (the distributed
    # pipeline, whose hooks are collectives, keeps the eager step)
    _graphed = True

    def __init__(self, cfg: PipelineConfig, device=None, dtype=torch.float32,
                 collect_odom_poses: bool = False):
        self.cfg = cfg
        self.device = resolve_device(device)
        self._dtype = dtype
        self._collect_odom = collect_odom_poses
        self._state = None
        self._inputs = FrameInputs(self.device, dtype)
        self.graphs = None     # step_graph.StepGraphs, captured at the first frame
        self.loop_graph = None  # loop_graph.LoopAttemptGraph, at the first attempt
        self.reset()
        self._l2b = (tf_l2b(cfg, self._state.T_odom2laser) if any(cfg.tf_b2l)
                     else None)

    @property
    def state(self) -> SlamState:
        """The static state (its tensors are updated in place)."""
        return self._state

    @state.setter
    def state(self, new: SlamState):
        _check_layout(self._state, new)
        self._state = new
        self.graphs = self.loop_graph = None

    def _commit(self, new: SlamState):
        commit(self._state, new)

    def reset(self):
        """Fresh SLAM state, written into the static tensors."""
        fresh = init_state(self.cfg, self.device, self._dtype)
        if self._state is None:
            self._state = fresh
        else:
            self._commit(fresh)
        self.poses = []
        self.odom_poses = []
        self._imu_pending = []
        self._frame = 0
        self._loop_live = False
        self._overflow_warned = False
        self.compactions = 0

    def _hooks(self) -> dict:
        return dict(assoc=self._assoc, graph_optimizer=self._graph_optimizer,
                    read=self._read)

    def _check_overflow(self):
        """Surface the keyframe-capacity policy: keyframes rejected at
        capacity are counted (``graph.overflow``), never silent.  With
        :meth:`_maybe_compact` on the ``process`` path this should not fire;
        it guards ``run_scanned``, where one chunk can cross capacity before
        the host compacts.  Warns once per run; one host read."""
        if self._overflow_warned:
            return
        ov = int(self.state.mapping.graph.overflow)
        if ov:
            warnings.warn(
                f"pose-graph hit capacity ({self.cfg.max_keyframes}) inside "
                f"a batched scan: {ov} keyframes rejected before host-side "
                "compaction could run; use shorter run_scanned chunks or "
                "raise cfg.max_keyframes", RuntimeWarning)
            self._overflow_warned = True

    def _loop_attempt(self):
        """One ``loop_closure_step`` on the state's map, committed.  On the
        card: the gate read on the host, then, if it passes, the attempt
        replayed from its graph (captured here at the first such call)."""
        ms = self._state.mapping
        if not (self._graphed and self.device.type == "cuda"):
            self._commit(self._state._replace(mapping=lm.loop_closure_step(
                ms, self.cfg, graph_optimizer=self._graph_optimizer, read=self._read)[0]))
            return
        if not self._read(lm.loop_gate(ms, self.cfg)[0]):
            return
        if self.loop_graph is None:
            from .loop_graph import LoopAttemptGraph
            self.loop_graph = LoopAttemptGraph(
                ms, self.cfg, pool=None if self.graphs is None else self.graphs.pool)
        self.loop_graph.replay()

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
            if not self._read(self.state.mapping.graph.count > 1):
                return
            self._loop_live = True
        self._loop_attempt()

    def _maybe_compact(self, margin: int = 16):
        """Keep-mapping-forever policy: within ``margin`` keyframes of
        capacity, thin old keyframes (``laser_mapping.compact_keyframes``)
        so new territory keeps mapping."""
        if self._read(self.state.mapping.graph.count >= self.cfg.max_keyframes - margin):
            self._commit(self._state._replace(
                mapping=lm.compact_keyframes(self._state.mapping, self.cfg)))
            self.compactions += 1

    def _to_device(self, a: np.ndarray, dtype) -> torch.Tensor:
        """A small host array (IMU and odometry input) on the device; on the
        card through pinned memory from PyTorch's host cache, which reuses
        a block only once its copy has finished, so no call waits."""
        t = torch.as_tensor(a, dtype=dtype)
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.to(self.device)

    # ---- IMU and odometry input (LO.cpp:737-795, 840-881) ----
    def add_imu(self, t: float, rpy, lin_acc):
        """Feed one IMU sample (the /imu/data handler, LO.cpp:840-881).
        Samples queue on the host and are integrated, in one copy to the
        device, before the next ``process`` or ``run_scanned``."""
        self._imu_pending.append(np.concatenate([
            [t], np.asarray(rpy, np.float32).reshape(3),
            np.asarray(lin_acc, np.float32).reshape(3)]).astype(np.float32))

    def _flush_imu(self):
        rows = self._to_device(np.stack(self._imu_pending), self._dtype)
        self._imu_pending = []
        self._commit(self._state._replace(imu=deskew.integrate_imu_chunk(
            self._state.imu, rows[:, 0], rows[:, 1:4], rows[:, 4:7], rows.shape[0])))

    def add_odom(self, t: float, rpy, pos, velo=(0.0, 0.0, 0.0)):
        """Feed one external-odometry sample (the ``use_odom`` input path,
        LO.cpp:737-795): the pose comes from the message, not integrated."""
        row = self._to_device(np.concatenate([[t], np.reshape(rpy, 3), np.reshape(pos, 3),
                                              np.reshape(velo, 3)]).astype(np.float32),
                              self._dtype)
        self._commit(self._state._replace(imu=deskew.integrate_odom(
            self._state.imu, row[0], row[1:4], row[4:7], row[7:10])))

    # ---- frames ----
    def _step(self, points, mask, t: float) -> torch.Tensor:
        """Feed one scan into the static inputs and run frame ``_frame``
        (the counter is advanced by the caller); returns its pose, a tensor
        of its own on the device."""
        cfg, f = self.cfg, self._frame
        moved = self._inputs.feed(points, mask, t)
        do_map = f % cfg.map_frame_decimation == 0
        do_loop = f % cfg.loop_every_n_frames == 0
        if not (self._graphed and self.device.type == "cuda"):
            new, pose = slam_step(self._state, self._inputs.points, self._inputs.mask,
                                  self._inputs.time, cfg, do_map_static=do_map,
                                  do_loop_static=do_loop, tf_l2b=self._l2b, **self._hooks())
            self._commit(new)
            return pose
        from .step_graph import StepGraphs
        if self.graphs is None or moved:
            self.graphs = StepGraphs(self._state, self._inputs, cfg, self._l2b)
        self.graphs.replay(do_map)
        if not (cfg.loop_closure_enabled and cfg.loop_in_step and do_loop):
            return self.graphs.pose.clone()
        # the in-step attempt follows the replay, as it follows the mapping
        # step inside slam_step, and the pose is taken after it
        self._loop_attempt()
        return frame_pose(self._state.mapping, self._state.T_odom2laser, cfg, self._l2b)

    def process(self, points: np.ndarray, mask: np.ndarray,
                time: Optional[float] = None) -> torch.Tensor:
        """Feed one scan; returns the map-frame pose [4, 4] on the device."""
        if self._imu_pending:
            self._flush_imu()
        t = self._frame * self.cfg.scan_period if time is None else time
        pose = self._step(points, mask, t)
        self._frame += 1
        self._maybe_loop(1)
        self.poses.append(pose)
        if self._collect_odom:
            self.odom_poses.append(self.state.T_odom2laser.cpu().numpy())
        if self._frame % self._sync_every == 0:
            self._maybe_compact()
        if self._frame % self._overflow_every == 0:
            self._check_overflow()
        return pose

    def run(self, points_seq: np.ndarray, mask_seq: np.ndarray) -> np.ndarray:
        for k in range(points_seq.shape[0]):
            self.process(points_seq[k], mask_seq[k])
        return torch.stack(self.poses).cpu().numpy()

    def run_scanned(self, points_seq: np.ndarray, mask_seq: np.ndarray,
                    times: Optional[np.ndarray] = None) -> np.ndarray:
        """Feed a chunk of scans: the reference's batch path (``lax.scan``
        over the chunk in one device call) and the CLI's streaming path.
        Here a host loop over the chunk's frames, each through the frame
        step with the mapping and in-step loop gates taken from the frame
        phase the host knows.  ``times``: the scans' stamps (bag replay), by
        default the frame clock.  After the chunk: exactly one hoisted loop
        attempt if it crossed a ``loop_every_n_frames`` boundary, compaction
        with a margin of at least the chunk, the overflow check.  Returns
        the chunk's poses [n, 4, 4] as numpy (one host read)."""
        if self._imu_pending:
            self._flush_imu()
        cfg = self.cfg
        n = points_seq.shape[0]
        if times is None:
            times = (np.arange(self._frame, self._frame + n, dtype=np.float32)
                     * np.float32(cfg.scan_period))
        times = np.asarray(times, np.float32)
        out = []
        for i in range(n):
            out.append(self._step(points_seq[i], mask_seq[i], float(times[i])))
            self._frame += 1
        self._maybe_loop(n)
        self.poses.extend(out)
        # a whole chunk can land between capacity checks: margin >= chunk
        self._maybe_compact(margin=max(16, n))
        self._check_overflow()
        return torch.stack(out).cpu().numpy()

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

    # ---- checkpoint and resume (the reference's npz layout) ----
    def _state_schema(self) -> str:
        """The state's layout: each leaf's field path, shape and dtype.
        Leaves are stored by position, so any change of structure or
        capacity would misassign arrays without this check."""
        return ";".join(f"{p}:{tuple(t.shape)}:{str(t.dtype).replace('torch.', '')}"
                        for p, t in _flatten(self.state))

    def save_checkpoint(self, path: str):
        """The state's leaves as ``arr_0..`` (field order, depth first, as
        the reference stores its pytree leaves), the frame counter and the
        schema, in one npz."""
        np.savez(path, *[t.cpu().numpy() for _, t in _flatten(self.state)],
                 frame=self._frame, schema=np.asarray(self._state_schema()))

    def load_checkpoint(self, path: str):
        """Restore a checkpoint onto this pipeline's device; a checkpoint of
        another layout raises ``ValueError``."""
        with np.load(path) as data:
            if "schema" in data.files and str(data["schema"]) != self._state_schema():
                raise ValueError(
                    f"checkpoint {path} was written by an incompatible "
                    "pipeline state layout (different code version or "
                    "config capacities); re-run from the source data")
            n = len(_flatten(self.state))
            leaves = [torch.from_numpy(np.array(data[f"arr_{i}"])).to(self.device)
                      for i in range(n)]
            frame = int(data["frame"])
        self._commit(_unflatten(self.state, leaves))
        self._frame = frame
