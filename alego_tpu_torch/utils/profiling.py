"""Host-side timers (SURVEY §5.1), a copy of the reference package's.

The reference wraps every phase in ``TicToc`` wall-clock timers and prints via
ROS logging (utility.h:99-120, e.g. LO.cpp:367-368, LM.cpp:250-269).  Here:
the same host-side timer and a stage-time aggregator, and
:func:`device_trace`, a ``torch.profiler`` trace of a block written as a
Chrome trace (where the reference writes a ``jax.profiler`` trace), and
:func:`device_window`, the counts of a profiled block on the card that
``chip_smoke.py`` and ``tools/profile_step.py`` report.
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


# runtime calls that block the host until the device has caught up
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize", "cudaMemcpy")


def device_window(run) -> dict:
    """Run ``run()`` under ``torch.profiler`` on the card, with one
    ``torch.cuda.synchronize()`` at the end of the window, and count from
    the raw trace (``prof.events()`` is ~40x slower): ``syncs``, the host's
    calls of :data:`SYNC_CALLS` less those of an empty window (the closing
    synchronise and the profiler's own); ``device_ops`` and
    ``device_busy_ms``, the number and summed time of the device's
    kernels, copies and fills; ``graph_launches`` (``cudaGraphLaunch``);
    ``async_copies`` (``cudaMemcpyAsync``); and ``kernels``, {name: [calls,
    ms]} of the device ops."""
    out = _window(run)
    out["syncs"] -= _window(lambda: None)["syncs"]
    return out


def _window(run) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    out = dict(syncs=0, device_ops=0, device_busy_ms=0.0, graph_launches=0,
               async_copies=0)
    kernels = defaultdict(lambda: [0, 0.0])
    cuda = torch.autograd.DeviceType.CUDA
    for ev in prof.profiler.kineto_results.events():
        name = ev.name()
        if ev.device_type() == cuda:
            ms = ev.duration_ns() / 1e6
            out["device_ops"] += 1
            out["device_busy_ms"] += ms
            kernels[name][0] += 1
            kernels[name][1] += ms
        elif name in SYNC_CALLS:
            out["syncs"] += 1
        elif name == "cudaGraphLaunch":
            out["graph_launches"] += 1
        elif name == "cudaMemcpyAsync":
            out["async_copies"] += 1
    out["kernels"] = dict(kernels)
    return out
