#!/usr/bin/env python3
"""Where the port's frame step spends its time on the GPU, replayed from
CUDA graphs and run eagerly.

Usage: ``python3 tools/profile_step.py [--frames N]`` from the
root of the repository, on a machine with a CUDA GPU.

Over the first frames of the bench circuit that ``chip_smoke.py`` renders,
at ``PipelineConfig(loop_in_step=False)`` (the full default geometry), two
ways: ``SlamPipeline`` (the step replayed from its CUDA graphs) and an
eager loop of ``slam_step`` on the card (the frames already on the device).
Each way: a warm-up pass (the graphed one captures its graphs there), a
timed pass without the profiler (host clock, one synchronise at the end),
then the same frames under ``torch.profiler``.  Prints one JSON object with,
for each way: ms/frame, device busy time per frame (the summed time of the
device's kernels, copies and fills), the device's idle share against the
unprofiled frame time, device operations, host synchronisations and graph
launches per frame, the kernels with the most device time, and the device
time of each of the port's own CUDA kernels (``csrc/*.cu``).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the port's own kernels, by the name each has in csrc/*.cu
PORT_KERNELS = ("ccl_tiles", "ccl_seams", "ccl_flatten", "nn1_chunks",
                "nn1_reduce", "knn_chunks", "knn_merge")


def summarize(win: dict, n: int, wall_s: float) -> dict:
    """Per-frame figures of a :func:`device_window` over ``n`` frames whose
    unprofiled pass took ``wall_s`` seconds."""
    busy_ms = win["device_busy_ms"]
    top = sorted(win["kernels"].items(), key=lambda kv: -kv[1][1])[:15]
    port = {k: [0, 0.0] for k in PORT_KERNELS}
    for name, (c, ms) in win["kernels"].items():
        for k in PORT_KERNELS:
            if k in name:
                port[k][0] += c
                port[k][1] += ms
    return {
        "ms_per_frame": wall_s / n * 1e3,
        "device_busy_ms_per_frame": busy_ms / n,
        "device_idle_share": (1.0 - busy_ms / 1e3 / wall_s) if busy_ms else None,
        "device_ops_per_frame": win["device_ops"] / n,
        "host_syncs_per_frame": win["syncs"] / n,
        "graph_launches_per_frame": win["graph_launches"] / n,
        "async_copies_per_frame": win["async_copies"] / n,
        "top_kernels": [{"name": k[:80], "calls_per_frame": c / n, "ms_per_frame": ms / n}
                        for k, (c, ms) in top],
        "port_kernels": {k: {"calls_per_frame": c / n, "ms_per_frame": ms / n}
                         for k, (c, ms) in port.items()},
    }


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--frames", type=int, default=16)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("profile_step: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from alego_tpu_torch import PipelineConfig
    from alego_tpu_torch.models.pipeline import SlamPipeline
    from alego_tpu_torch.utils.profiling import device_window
    from chip_smoke import eager_steps, render

    cfg = PipelineConfig().replace(loop_in_step=False)
    n = args.frames
    _, pts, mask = render(cfg, n)
    pipe = SlamPipeline(cfg, device="cuda")
    pts_d = torch.as_tensor(pts, device="cuda")
    mask_d = torch.as_tensor(mask, device="cuda")

    def graphed():
        for k in range(n):
            pipe.process(pts[k], mask[k])

    def eager():
        eager_steps(cfg, pts_d, mask_d)

    out = {}
    for name, run, before in (("graphed", graphed, pipe.reset), ("eager", eager, None)):
        walls = []
        for _ in range(2):                  # the warm-up pass, then the timed one
            if before:
                before()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        if before:
            before()
        out[name] = summarize(device_window(run), n, walls[-1])
    out["graphed"]["capture_seconds"] = pipe.graphs.capture_seconds
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(json.dumps(dict(device=smi, frames=n, **out), indent=1))
    return 0 if all(out[k]["device_busy_ms_per_frame"] for k in ("graphed", "eager")) else 1


if __name__ == "__main__":
    sys.exit(main())
