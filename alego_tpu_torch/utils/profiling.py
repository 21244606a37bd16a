"""Host-side timers (SURVEY §5.1), a copy of the reference package's.

The reference wraps every phase in ``TicToc`` wall-clock timers and prints via
ROS logging (utility.h:99-120, e.g. LO.cpp:367-368, LM.cpp:250-269).  Here:
the same host-side timer and a stage-time aggregator, and
:func:`device_trace`, a ``torch.profiler`` trace of a block written as a
Chrome trace (where the reference writes a ``jax.profiler`` trace).
``tools/profile_step.py`` breaks the frame step's trace down.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict


class TicToc:
    """Wall-clock ms timer (utility.h:99-120 equivalent)."""

    def __init__(self):
        self.tic()

    def tic(self):
        self._t0 = time.perf_counter()

    def toc(self) -> float:
        return (time.perf_counter() - self._t0) * 1000.0


class StageTimer:
    """Aggregates per-stage wall times across frames."""

    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = (time.perf_counter() - t0) * 1000.0
            self.totals[name] += dt
            self.counts[name] += 1

    def report(self) -> str:
        lines = []
        for name in sorted(self.totals):
            n = self.counts[name]
            lines.append(f"{name}: {self.totals[name] / max(n, 1):.2f} ms/call"
                         f" x {n}")
        return "\n".join(lines)


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Trace the block with ``torch.profiler`` (host ops, and the GPU's
    kernels and copies when CUDA is available) and write it to
    ``log_dir/trace.json`` as a Chrome trace (chrome://tracing, Perfetto)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
