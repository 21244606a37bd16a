"""The loop-closure attempt as CUDA graphs: the counterpart of the
reference's ``jax.jit(loop_closure_step)`` (the hoisted attempt) and of the
in-step ``lax.cond`` around it.

:class:`LoopAttemptGraph` captures one attempt past its gate
(``laser_mapping.loop_gate`` and ``loop_attempt``: the candidate search,
both ICPs with their 1-NN kernel launches, the BEV rescue, the acceptance
gate on the k = 1 k-NN kernel, both pose-graph solves and the attempt
counters) over the pipeline's static mapping state, and writes the new
state back into it (``pipeline.commit``) and ``closed`` and ``fitness``
into static buffers.  The host reads only the gate, before a replay
(``SlamPipeline._loop_attempt``), so a replay always runs an attempt and
reads nothing.  Nothing is caught: an attempt that cannot be captured (a
host read inside it) raises.

The attempt's fixed-length loops are not unrolled into the capture:
ICP's iterations and each pose-graph solve's GN iterations run through a
``loop`` hook (``device.fixed_loop``'s contract), which here ends the open
graph, captures one iteration into a graph of its own that updates the
loop's carry in place, and opens the next graph.  A replay launches the
graphs in order, each iteration's graph as many times as its loop runs,
with no host read between them (XLA likewise compiles the reference's
``while_loop`` body once).  The capture then records one iteration of each
of the four loops instead of ``icp_iters + loop_rescue_icp_iters + 2 *
pose_graph_gn_iters``: about a tenth of the attempt's operations at the
default config.

Before the capture the attempt runs once on the capture stream (libraries,
handles, workspaces, FFT plans), each loop cut to one iteration and its
result dropped: ``loop_attempt`` writes nothing into the state it is given,
so the warm-up needs no copy of it.  The capture executes nothing, so the
first attempt's answer comes from its first replay.  The graphs between
the loops may share the step graphs' memory pool: they keep no tensor
alive past the attempt, and replay in the order they were captured.  The
iteration graphs take a pool of their own, since they are replayed after
graphs captured later than them.
The kernel launches counted at capture are taken out again and each
replay adds them, times the iteration graphs' repeats.
"""

from __future__ import annotations

import collections
import time

import torch

from .. import kernels
from . import laser_mapping as lm
from .pipeline import commit


def _one_iteration(body, carry, n):
    return body(carry)


class LoopAttemptGraph:
    """One loop attempt of ``cfg`` captured over ``ms`` (a static
    ``MappingState``, updated in place by every replay).  ``pool``: a
    memory pool to share (the step graphs'), or None for a pool of its own.
    Records ``capture_seconds`` (warm-up and captures), ``warmup_seconds``,
    ``warmup_launches``, ``launches`` (the kernel launches of one replay)
    and ``graph_launches`` (the graphs one replay launches)."""

    def __init__(self, ms: lm.MappingState, cfg, pool=None):
        dev = ms.T_map2odom.device
        if dev.type != "cuda":
            raise ValueError("CUDA graphs need the mapping state on a CUDA device")
        self.cfg = cfg
        self.closed = torch.zeros((), dtype=torch.bool, device=dev)
        self.fitness = torch.zeros((), dtype=ms.T_map2odom.dtype, device=dev)
        t0 = time.perf_counter()
        stream = torch.cuda.Stream(dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
        self.pool = torch.cuda.graph_pool_handle() if pool is None else pool
        self._iter_pool = torch.cuda.graph_pool_handle()
        self._plan = []       # [graph, repeats, launches] in replay order
        self._open = None     # the graph being captured and the counts before it
        with torch.cuda.stream(stream):
            mark = collections.Counter(kernels.LAUNCHES)
            self._attempt(ms, _one_iteration)
            self.warmup_launches = dict(kernels.LAUNCHES - mark)
            self._restore(mark)
            torch.cuda.synchronize(dev)
            self.warmup_seconds = time.perf_counter() - t0
            try:
                self._begin(self.pool, 1)
                new, closed, fitness = self._attempt(ms, self._loop)
                commit(ms, new)
                self.closed.copy_(closed)
                self.fitness.copy_(fitness)
                self._end()
            except BaseException:
                if self._open is not None:
                    try:      # close the capture the error invalidated
                        self._open[0].capture_end()
                    except RuntimeError:
                        pass
                    self._restore(self._open[1])
                raise
        torch.cuda.synchronize(dev)
        self.launches = collections.Counter()
        for _, repeats, launches in self._plan:
            for k, v in launches.items():
                self.launches[k] += repeats * v
        self.launches = dict(self.launches)
        self.graph_launches = sum(repeats for _, repeats, _ in self._plan)
        self.capture_seconds = time.perf_counter() - t0

    def _attempt(self, ms: lm.MappingState, loop):
        """The gate's candidate and the attempt against it (the gate is not
        read): (new state, closed, fitness)."""
        _, closest, latest = lm.loop_gate(ms, self.cfg)
        return lm.loop_attempt(ms, closest, latest, self.cfg, loop=loop)

    @staticmethod
    def _restore(mark: collections.Counter):
        kernels.LAUNCHES.clear()
        kernels.LAUNCHES.update(mark)

    def _begin(self, pool, repeats: int):
        graph = torch.cuda.CUDAGraph()
        self._open = (graph, collections.Counter(kernels.LAUNCHES))
        graph.capture_begin(pool=pool)
        self._plan.append([graph, repeats, None])

    def _end(self):
        graph, mark = self._open
        graph.capture_end()
        self._open = None
        self._plan[-1][2] = dict(kernels.LAUNCHES - mark)
        self._restore(mark)

    def _loop(self, body, carry: tuple, n: int) -> tuple:
        """``device.fixed_loop`` in the capture: the carry copied into buffers
        of the open graph, then one iteration captured into a graph that
        writes its result back into them, replayed ``n`` times."""
        carry = tuple(c.clone() for c in carry)
        self._end()
        self._begin(self._iter_pool, n)
        for c, new in zip(carry, body(carry)):
            c.copy_(new)
        self._end()
        self._begin(self.pool, 1)
        return carry

    def replay(self):
        """Run one attempt (the caller has read its gate) and count its
        launches."""
        for graph, repeats, _ in self._plan:
            for _ in range(repeats):
                graph.replay()
        kernels.LAUNCHES.update(self.launches)
