"""What a traced stretch of the window reads from ``torch.profiler``: the
device's operations and busy time, the host's synchronising calls, the
harness's own spans around each frame (``portbench.frame``) and around each
call into the program (``portbench.call``), and where the device sat idle.

Device time is the union of the device's operations (kernels, copies,
fills) over the traced window, which runs from the first frame span's start
to the last one's end; a frame's device work is the operations that start
inside its span (the frame's pose is read on the host before the span
ends).  Each idle gap of the device is named by the innermost host event
that covers its middle: a harness span, an ``aten`` op or a runtime call.
"""

from __future__ import annotations

import bisect
import collections

import numpy as np

# runtime calls that block the host until the device has caught up (the
# port's own utils/profiling.py keeps the same list)
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize", "cudaMemcpy")
# the port's kernels, by their names in csrc/*.cu
PORT_KERNELS = ("ccl_tiles", "ccl_seams", "ccl_flatten", "nn1_chunks",
                "nn1_reduce", "knn_chunks", "knn_merge", "gn_solve")
FRAME, CALL = "portbench.frame", "portbench.call"
# idle gaps shorter than this are summed under one name, not looked up
SHORT_GAP_NS = 10_000
SHORT = "gaps under 10 us (between device ops)"


def _union(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _inside(spans, t):
    """Index of the span (sorted, disjoint) holding time t, or -1."""
    i = bisect.bisect_right(spans, (t, float("inf"))) - 1
    return i if i >= 0 and spans[i][0] <= t <= spans[i][1] else -1


def read(prof) -> dict:
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    dev, host, frames, calls, syncs = [], [], [], [], []
    for ev in prof.profiler.kineto_results.events():
        s = ev.start_ns()
        e = s + ev.duration_ns()
        name = ev.name()
        if ev.device_type() == cuda:
            if ev.is_user_annotation():    # the harness's spans mirrored on the device
                continue
            dev.append((s, e, name))
            continue
        if name == FRAME:
            frames.append((s, e))
        elif name == CALL:
            calls.append((s, e))
        else:
            if name in SYNC_CALLS:
                syncs.append((s, e))
            host.append((s, e, name))
    frames.sort()
    calls.sort()
    if not frames:
        return {}
    w0, w1 = frames[0][0], frames[-1][1]
    dev = [d for d in dev if w0 <= d[0] <= w1]
    host = [h for h in host if h[1] >= w0 and h[0] <= w1]
    busy = _union([(max(s, w0), min(e, w1)) for s, e, _ in dev])
    per_frame = [[0, 0] for _ in frames]          # ops, ns
    by_name = collections.Counter()
    for s, e, name in dev:
        by_name[name] += e - s
        i = _inside(frames, s)
        if i >= 0:
            per_frame[i][0] += 1
            per_frame[i][1] += e - s
    sync_in_frames = sum(_inside(frames, s) >= 0 for s, _ in syncs)
    gaps = collections.Counter()
    marks = host + [(s, e, FRAME) for s, e in frames] + [(s, e, CALL) for s, e in calls]
    S = np.array([m[0] for m in marks], np.int64)
    E = np.array([m[1] for m in marks], np.int64)
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    for a, b in zip(edges[::2], edges[1::2]):
        if b - a < SHORT_GAP_NS:
            gaps[SHORT] += max(b - a, 0)
            continue
        mid = (a + b) // 2
        cover = np.nonzero((S <= mid) & (E >= mid))[0]
        name = marks[cover[np.argmin(E[cover] - S[cover])]][2] if cover.size else "no host event"
        gaps[name] += b - a
    port = sum(ns for n, ns in by_name.items() if any(k in n for k in PORT_KERNELS))
    return dict(
        window_s=(w1 - w0) / 1e9,
        busy_s=sum(e - s for s, e in busy) / 1e9,
        frame_ops=[o for o, _ in per_frame],
        frame_busy_s=[ns / 1e9 for _, ns in per_frame],
        syncs_in_frames=sync_in_frames,
        port_kernel_s=port / 1e9,
        device_ops=[[n[:160], ns / 1e9] for n, ns in by_name.most_common(10)],
        idle_gaps=[[n[:160], ns / 1e9] for n, ns in gaps.most_common(10)],
    )
