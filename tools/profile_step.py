#!/usr/bin/env python3
"""Where the port's frame step spends its time on the GPU.

Usage: ``python3 tools/profile_step.py [--frames N]`` from the
root of the repository, on a machine with a CUDA GPU.

Runs ``SlamPipeline(PipelineConfig(loop_in_step=False))`` (the full default
geometry) over the first frames of the bench circuit that ``chip_smoke.py``
renders: a warm-up pass, a timed pass without the profiler (host clock, one
synchronise at the end), then the same frames under ``torch.profiler``.
Prints one JSON object: ms/frame, device busy time per frame (the sum of
the CUDA kernel and copy times the profiler records), the device's idle
share against the unprofiled frame time, device operations and host
synchronisations per frame, the kernels with the most device time, and the
device time of each of the port's own CUDA kernels (``csrc/*.cu``).
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# runtime calls that block the host until the device has caught up
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize", "cudaMemcpy")
# the port's own kernels, by the name each has in csrc/*.cu
PORT_KERNELS = ("ccl_tiles", "ccl_seams", "ccl_flatten", "nn1_chunks",
                "nn1_reduce", "knn_chunks", "knn_merge")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--frames", type=int, default=16)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("profile_step: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from torch.profiler import ProfilerActivity, profile
    from alego_tpu_torch import PipelineConfig
    from alego_tpu_torch.models.pipeline import SlamPipeline
    from chip_smoke import render, timed_pass

    cfg = PipelineConfig().replace(loop_in_step=False)
    n = args.frames
    _, pts, mask = render(cfg, n)
    pipe = SlamPipeline(cfg, device="cuda")

    def run():
        pipe.reset()
        torch.cuda.synchronize()
        return timed_pass(pipe, pts, mask)

    run()                                   # warm-up
    wall_plain = run()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall_prof = run()

    kernels = collections.defaultdict(lambda: [0, 0.0])
    busy_us, ops, syncs, copies = 0.0, 0, 0, 0
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            us = ev.time_range.elapsed_us()
            busy_us += us
            ops += 1
            kernels[ev.name][0] += 1
            kernels[ev.name][1] += us
        elif ev.name in SYNC_CALLS:
            syncs += 1
        elif ev.name == "cudaMemcpyAsync":
            copies += 1

    top = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:15]
    port = {k: [0, 0.0] for k in PORT_KERNELS}
    for name, (c, us) in kernels.items():
        for k in PORT_KERNELS:
            if k in name:
                port[k][0] += c
                port[k][1] += us
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    summary = {
        "device": smi, "frames": n,
        "ms_per_frame": wall_plain / n * 1e3,
        "ms_per_frame_profiled": wall_prof / n * 1e3,
        "device_busy_ms_per_frame": busy_us / n / 1e3,
        "device_idle_share": (1.0 - busy_us / 1e6 / wall_plain) if busy_us else None,
        "device_ops_per_frame": ops / n,
        "host_syncs_per_frame": syncs / n,
        "async_copies_per_frame": copies / n,
        "top_kernels": [{"name": k[:80], "calls_per_frame": c / n,
                         "ms_per_frame": us / n / 1e3} for k, (c, us) in top],
        "port_kernels": {k: {"calls_per_frame": c / n, "ms_per_frame": us / n / 1e3}
                         for k, (c, us) in port.items()},
    }
    print(json.dumps(summary, indent=1))
    return 0 if busy_us else 1


if __name__ == "__main__":
    sys.exit(main())
