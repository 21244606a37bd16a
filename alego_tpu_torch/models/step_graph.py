"""The frame step as CUDA graphs: the counterpart of the reference's
``jax.jit(slam_step, donate_argnums=0)`` and of ``scan_sequence``'s
decimation-aligned groups (slot 0 maps, the others do not).

:class:`StepGraphs` captures ``slam_step`` (projection, segmentation with
the CCL kernel, de-skew, features, odometry with the 1-NN kernel and, on
mapping frames, the mapping step with the k-NN kernel) once per kind of
frame phase: one graph that maps and, when ``map_frame_decimation > 1``,
one that does not.  Each graph reads the pipeline's static inputs and
static state and writes its results back into the state (``commit``) and
the frame's pose into :attr:`StepGraphs.pose`; a replay launches every
kernel of the frame with no host work and no host sync.  Nothing is
caught: a step that cannot be captured (a host read inside it) raises.

Before the capture the step runs once, on a copy of the state, on the
capture stream: it loads the kernels' libraries and the libraries' handles
and workspaces, and sets up the allocator.  The capture itself executes
nothing, so the first frame's answer comes from its first replay.  Both
graphs share one memory pool: each keeps no tensor of its own alive past
its replay, since its results are copied into the static state.

Kernel launches are counted by the wrappers (``kernels.LAUNCHES``), which
run at capture, not at replay.  The counts that the warm-up and the
captures add are taken out again and kept here (``warmup_launches``,
``launches``), and each replay adds its graph's captured counts, so the
counts read as those of the frames that ran.
"""

from __future__ import annotations

import collections
import time

import torch

from .. import kernels
from .pipeline import FrameInputs, SlamState, _flatten, _unflatten, commit, slam_step


def _restore(counts: collections.Counter):
    kernels.LAUNCHES.clear()
    kernels.LAUNCHES.update(counts)


class StepGraphs:
    """The frame step of ``cfg`` captured over ``state`` (static, updated in
    place by every replay) and ``inputs`` (the static scan buffers).
    ``tf_l2b``: the pipeline's base-link transform (``cfg.tf_b2l``), or
    None.  Records ``capture_seconds`` (warm-up and captures) and
    ``launches`` (per graph, the kernel launches of one replay)."""

    def __init__(self, state: SlamState, inputs: FrameInputs, cfg, tf_l2b=None):
        if inputs.device.type != "cuda":
            raise ValueError("CUDA graphs need the step's state on a CUDA device")
        self.cfg = cfg
        self._state, self._inputs, self._l2b = state, inputs, tf_l2b
        self.pose = torch.empty((4, 4), dtype=state.T_odom2laser.dtype, device=inputs.device)
        phases = (True, False) if cfg.map_frame_decimation > 1 else (True,)
        t0 = time.perf_counter()
        stream = torch.cuda.Stream(inputs.device)
        mark = collections.Counter(kernels.LAUNCHES)
        self._warm_up(stream)
        self.warmup_launches = dict(kernels.LAUNCHES - mark)
        _restore(mark)
        self.pool = torch.cuda.graph_pool_handle()
        self.graphs, self.launches = {}, {}
        for do_map in phases:
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, pool=self.pool, stream=stream):
                self._body(self._state, do_map)
            self.launches[do_map] = dict(kernels.LAUNCHES - mark)
            _restore(mark)
            self.graphs[do_map] = graph
        torch.cuda.synchronize(inputs.device)
        self.capture_seconds = time.perf_counter() - t0

    def _body(self, state: SlamState, do_map: bool):
        """One frame into ``state`` and :attr:`pose` (the captured program;
        the in-step loop attempt is not part of it)."""
        inp = self._inputs
        new, pose = slam_step(state, inp.points, inp.mask, inp.time, self.cfg,
                              do_map_static=do_map, do_loop_static=False,
                              tf_l2b=self._l2b)
        commit(state, new)
        self.pose.copy_(pose)

    def _warm_up(self, stream: torch.cuda.Stream):
        """A mapping frame, on a copy of the state, on the capture stream
        (the mapping frame runs every op of the other phase too)."""
        stream.wait_stream(torch.cuda.current_stream(stream.device))
        with torch.cuda.stream(stream):
            copy = _unflatten(self._state, [t.clone() for _, t in _flatten(self._state)])
            self._body(copy, True)
            del copy
        torch.cuda.current_stream(stream.device).wait_stream(stream)

    def replay(self, do_map: bool):
        """Run one frame: the graph of its phase, and its launches counted."""
        self.graphs[do_map].replay()
        kernels.LAUNCHES.update(self.launches[do_map])
