"""How ``correct`` is decided: the program's answers held against the plain
reference (``reference/``), which shares no code with the program.

A SLAM run is chaotic: two sound f32 runs of the same scans part by
millimetres within a few frames and by centimetres over a lap.  So the
reference follows the program two ways, and both are compared:

- the start: the first frames of a session, each side from its own fresh
  state (``start_gap_m``, the largest pose gap);
- steps: at calls drawn from the seed, the program's state just before the
  call (a snapshot taken in the window, off the window's clock) is carried
  into the reference's types, the reference runs the call's frames and the
  hoisted loop attempt that follows them, and the poses, the keyframe poses
  after it (loop closures included) and the counts of keyframes, attempts
  and loop factors with their pairs (``discrete_diff``, exact) are compared
  with the program's.  Each step's largest pose gap over its first frames
  (all of a one-frame call's), its last frame's gap and its largest
  keyframe gap are taken; ``step_gap_m``, ``last_gap_m`` and ``kf_gap_m``
  are their medians over the steps.  A single frame's gap is heavy-tailed:
  two sound runs from one state can take another correspondence or another
  of the pose graph's two initialisations and part by millimetres to
  centimetres on one step in a dozen, while the control parts on every
  step.

Each number has its limit in the cell's file (``cells/<cell>.json``,
``check.limits``); ``PERF.md`` gives the readings each limit was set from.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

# leaves whose leading axis is the keyframe capacity: a snapshot keeps only
# the keyframes in use (the rest are the fresh state's zeros)
_KF_LEAVES = ("state.mapping.kf_", "state.mapping.graph.poses",
              "state.mapping.graph.chain_rel")


def flatten(tree, path="state"):
    """(path, tensor) leaves of a NamedTuple tree, depth first."""
    out = []
    for name, sub in zip(tree._fields, tree):
        if hasattr(sub, "_fields"):
            out += flatten(sub, f"{path}.{name}")
        else:
            out.append((f"{path}.{name}", sub))
    return out


def _kf_leaf(path: str) -> bool:
    return any(path.startswith(p) for p in _KF_LEAVES)


def snapshot(state) -> dict:
    """The program's state on the host: {path: tensor}, the keyframe
    stores cut to the keyframes in use (one host read for the count)."""
    count = int(state.mapping.graph.count)
    return {p: (t[:count] if _kf_leaf(p) else t).to("cpu", copy=True)
            for p, t in flatten(state)}


def outcome(state) -> dict:
    """What a step leaves that the check compares, on the host."""
    g = state.mapping.graph
    count, loops = int(g.count), int(g.loop_count)
    return dict(count=count, loop_count=loops,
                attempts=int(state.mapping.loop_attempts),
                kf_poses=g.poses[:count].to("cpu", copy=True).numpy(),
                pairs=sorted(zip(g.loop_i[:loops].tolist(), g.loop_j[:loops].tolist())))


def to_reference(snap: dict, template):
    """The reference's state (``template``: its fresh state on the device)
    with the snapshot's leaves in place, matched by path.  Leaves of the
    program that the reference does not carry (the IMU buffer, unused with
    de-skew off) are skipped; a leaf of the reference that the snapshot
    lacks, or of another shape or dtype, raises."""
    leaves = []
    for path, t in flatten(template):
        src = snap.get(path)
        if src is None:
            raise ValueError(f"the program's state has no leaf {path}")
        ok = (src.dtype == t.dtype and (tuple(src.shape) == tuple(t.shape)
                                        or (_kf_leaf(path) and src.shape[1:] == t.shape[1:])))
        if not ok:
            raise ValueError(f"{path}: {src.dtype}{tuple(src.shape)} does not fit "
                             f"{t.dtype}{tuple(t.shape)}")
        t, src = t.clone(), src.to(t.device)
        if t.dim() and src.shape[0] != t.shape[0]:
            t[:src.shape[0]] = src
        else:
            t.copy_(src)
        leaves.append(t)
    it = iter(leaves)

    def build(node):
        return type(node)(*[build(s) if hasattr(s, "_fields") else next(it) for s in node])
    return build(template)


class Feed(NamedTuple):
    """How the cell hands frames to the program: ``chunk`` frames a call
    (1: ``process``), and the frame clock."""
    chunk: int
    scan_period: float
    map_every: int
    loop_every: int

    def times(self, first: int, n: int) -> list:
        """The stamps the program gives frames first..first+n-1."""
        if self.chunk == 1:
            return [float(first + i) * self.scan_period for i in range(n)]
        return [float(x) for x in np.arange(first, first + n, dtype=np.float32)
                * np.float32(self.scan_period)]


class Reference:
    """The reference over one cell's scans: its configuration and frames,
    and the precision it computes in (``control=True``: TF32, the control)."""

    def __init__(self, rcfg, points: np.ndarray, mask: np.ndarray, feed: Feed,
                 device, control: bool = False):
        from reference import pipeline, precision
        self.cfg, self.points, self.mask, self.feed = rcfg, points, mask, feed
        self.device = torch.device(device)
        self._pipeline = pipeline
        self._mode = precision.TF32 if control else None

    def fresh(self):
        return self._pipeline.init_state(self.cfg, self.device)

    def run(self, state, first: int, n: int):
        """Frames first..first+n-1 from ``state`` as the program's feed runs
        them, the hoisted loop attempts after whole calls included: (state,
        poses [n, 4, 4])."""
        if self._mode is None:
            return self._run(state, first, n)
        prev = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            with self._mode():
                return self._run(state, first, n)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = prev

    def _run(self, state, first, n):
        f, pipe, poses = self.feed, self._pipeline, []
        times = f.times(first, n)
        with torch.no_grad():
            for c0 in range(0, n, f.chunk):
                for i in range(c0, min(c0 + f.chunk, n)):
                    k = first + i
                    pts = torch.from_numpy(self.points[k]).to(self.device)
                    msk = torch.from_numpy(self.mask[k]).to(self.device)
                    t = torch.full((), times[i], dtype=torch.float32, device=self.device)
                    state, pose = pipe.slam_step(state, pts, msk, t, self.cfg,
                                                 do_map=k % f.map_every == 0)
                    poses.append(pose)
                start, end = first + c0, first + c0 + f.chunk
                if c0 + f.chunk <= n and end // f.loop_every != start // f.loop_every:
                    state = pipe.loop_step(state, self.cfg)
        return state, torch.stack(poses).cpu().numpy()


def _gap(a: np.ndarray, b: np.ndarray) -> float:
    """Largest translation gap (m) between two pose stacks [n, 4, 4]; a
    non-finite pose reads as infinitely far."""
    d = np.linalg.norm(a[..., :3, 3].astype(np.float64) - b[..., :3, 3], axis=-1)
    return float(np.max(np.where(np.isfinite(d), d, np.inf))) if d.size else 0.0


def compare(ref: Reference, start_poses: np.ndarray, steps: list, step_frames: int = 0) -> dict:
    """The numbers compared.  ``start_poses``: the program's first frames
    of a session; ``steps``: [(first frame, n, pre-state snapshot, the
    program's poses [n, 4, 4], its outcome after the step)].  The
    reference runs every call whole; ``step_frames``: the call's first
    frames that ``step_gap_m`` reads (0: all).  Also ``frame_gaps``, each
    frame's gap (not compared: for setting limits)."""
    out = dict(start_gap_m=0.0, step_gap_m=0.0, last_gap_m=0.0, kf_gap_m=0.0,
               discrete_diff=0, frame_gaps=dict(start=[], steps=[], kf=[]))
    if len(start_poses):
        _, poses = ref.run(ref.fresh(), 0, len(start_poses))
        out["start_gap_m"] = _gap(start_poses, poses)
        out["frame_gaps"]["start"] = [_gap(a[None], b[None]) for a, b in zip(start_poses, poses)]
    step_gaps, last_gaps, kf_gaps = [], [], []
    for first, n, pre, prog_poses, prog in steps:
        state, poses = ref.run(to_reference(pre, ref.fresh()), first, n)
        head = step_frames or n
        step_gaps.append(_gap(prog_poses[:head], poses[:head]))
        last_gaps.append(_gap(prog_poses[-1:], poses[-1:]))
        out["frame_gaps"]["steps"].append(
            [first] + [_gap(a[None], b[None]) for a, b in zip(prog_poses, poses)])
        mine = outcome(state)
        m = min(mine["count"], prog["count"])
        kf_gaps.append(_gap(prog["kf_poses"][:m], mine["kf_poses"][:m]))
        out["discrete_diff"] += (abs(mine["count"] - prog["count"])
                                 + abs(mine["attempts"] - prog["attempts"])
                                 + abs(mine["loop_count"] - prog["loop_count"])
                                 + len(set(mine["pairs"]) ^ set(prog["pairs"])))
    if steps:
        out["step_gap_m"] = float(np.median(step_gaps))
        out["last_gap_m"] = float(np.median(last_gaps))
        out["kf_gap_m"] = float(np.median(kf_gaps))
    out["frame_gaps"]["kf"] = kf_gaps
    out["steps"] = len(steps)
    return out


def judge(numbers: dict, limits: dict) -> tuple:
    """(correct, [(name, value, limit)]): every number within its limit, a
    non-finite number never; no step compared is a failure too."""
    rows = [(k, numbers[k], limits[k]) for k in sorted(limits)]
    ok = all(math.isfinite(v) and v <= lim for _, v, lim in rows)
    return ok and numbers.get("steps", 0) > 0, rows
