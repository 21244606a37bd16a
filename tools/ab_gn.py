#!/usr/bin/env python3
"""The ``gn`` kernel (``csrc/gn.cu``, one Gauss-Newton solve per launch) of
this tree against another tree's, on the frame step's own solves, in one
call, on one card.

Usage: ``python3 tools/ab_gn.py OTHER [--frames 32]`` from the root of the
repository, on a machine with a CUDA GPU.  ``OTHER`` is the root of the
other tree, for example the parent commit unpacked with ``git archive``:
``mkdir -p _scratch/parent && git archive HEAD~1 | tar -x -C _scratch/parent``
(``_scratch/`` is ignored by git).

The first ``--frames`` frames of ``chip_smoke.py``'s bench circuit run
eagerly on the card (``chip_smoke._record_solves``), which records the last
solve of each composition: odometry step A, step B and the mapping solve.
Each tree then runs in turns (other, this, this, other), each turn a
process of its own that imports that tree's ``alego_tpu_torch`` (building
its kernels) and times its ``solve_correspondences_cuda`` on the recorded
inputs.  A time is the device time of one launch (``graph_ms``): a CUDA
graph of ``GRAPH_LAUNCHES`` launches replayed, the median over 11
replays.  Per
composition:

- ``bare``: the solve as recorded (its iterations as the stop test ends
  them);
- ``forced1`` and ``forcedN``: ``param_tol = 0`` at 1 and at the
  composition's ``iters`` iterations, so ms per iteration is
  (forcedN - forced1) / (its iterations run - 1) (a step of exactly 0
  still stops a forced run);
- ``proj0`` and ``proj1``: ``eig_floor`` 0 and 1.0 (the degeneracy
  projector's cost is their difference);

and ``rows<n>``: the mapping batch cut or repeated to 512, 768, 4096 and
8192 rows, 5 iterations forced, no projector (the per-row cost).  Each
turn also checks its kernel against the plain solve on the recorded
compositions (within ``chip_smoke.GN_TOL``), two launches bit for bit, and
the graph's answer against the eager launch bit for bit.

The sync floor of a launch shape is a kernel of the same blocks and
threads that runs only the barriers of each iteration, for the same
iterations, timed the same way (``FLOOR_SOURCE``, ``SHAPES``: the
one-block design, 512 threads and 3 ``__syncthreads`` an iteration,
launched plainly; the cluster design, 256 threads a block, 2
``__syncthreads`` and, with more than one block, one cluster barrier,
launched as a cluster).

Prints one JSON object: per turn its times, blocks per launch, iterations
run, errors and answers; per measurement the two trees' mean times; ms
per iteration, the projector's ms and the sync floors; whether the two
trees' answers are equal bit for bit; the card's ``nvidia-smi`` name and
power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COMPOSITIONS = ("step_a", "step_b", "mapping")
ROWS = (512, 768, 4096, 8192)
ROWS_ITERS = 5
GRAPH_LAUNCHES = 10
# each design's threads a block and barriers an iteration: (threads,
# __syncthreads, cluster barriers)
SHAPES = {"one_block": (512, 3, 0), "cluster": (256, 2, 1)}

FLOOR_SOURCE = r"""
#include <cooperative_groups.h>
#include <cuda_runtime.h>
namespace cg = cooperative_groups;

// the barriers of a solve's iterations, and nothing else
__global__ void __launch_bounds__(512) sync_floor(int iters, int block_syncs,
                                                  int cluster_syncs, int* sink) {
  __shared__ int x;
  if (threadIdx.x == 0) x = 0;
  for (int it = 0; it < iters; ++it) {
    for (int k = 0; k < block_syncs; ++k) __syncthreads();
    for (int k = 0; k < cluster_syncs; ++k) cg::this_cluster().sync();
    if (threadIdx.x == 0) x += 1;
  }
  if (threadIdx.x == 0 && blockIdx.x == 0) *sink = x;
}

extern "C" int floor_launch(int blocks, int threads, int iters, int block_syncs,
                            int cluster_syncs, int as_cluster, int* sink, void* stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(threads);
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = blocks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = as_cluster ? 1 : 0;
  cudaError_t err = cudaLaunchKernelEx(&cfg, sync_floor, iters, block_syncs, cluster_syncs, sink);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}
"""


def graph_ms(fn):
    """Device ms of one call of ``fn``: a CUDA graph of ``GRAPH_LAUNCHES``
    calls (warmed up on the capture stream first), the median over 11
    replays; and the last call's output."""
    import torch
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fn()
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        outs = [fn() for _ in range(GRAPH_LAUNCHES)]
    graph.replay()
    times = []
    for _ in range(11):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / GRAPH_LAUNCHES)
    return sorted(times)[5], outs[-1].clone()


TURN = r"""
import json, sys
sys.path.insert(0, {tree!r})
sys.path.insert(1, {tools!r})
import torch
import chip_smoke
from ab_gn import graph_ms
from alego_tpu_torch import kernels
from alego_tpu_torch.ops import gauss_newton as gn

kernels.library("gn")
ROWS_ITERS = {rows_iters}
cases = torch.load({cases!r}, weights_only=False)
dev = torch.device("cuda")
plan = getattr(gn, "gn_plan", None)


def on_card(case):
    corr, p0, iters, dims, delta, kw = case
    kw = {{k: v.to(dev) if torch.is_tensor(v) else v for k, v in kw.items()}}
    return (type(corr)(*(t.to(dev) for t in corr)), p0.to(dev), iters, dims.to(dev), delta), kw


out = dict(design="cluster" if plan else "one_block", ms={{}}, blocks={{}}, iters_run={{}},
           err={{}}, answers={{}})
measures = []
for label in {compositions!r}:
    args, kw = on_card(cases[label])
    iters = args[2]
    measures += [(label, args, kw),
                 (label + "_forced1", args[:2] + (1,) + args[3:], dict(kw, param_tol=0.0)),
                 (label + "_forcedN", args, dict(kw, param_tol=0.0)),
                 (label + "_proj0", args, dict(kw, eig_floor=0.0)),
                 (label + "_proj1", args, dict(kw, eig_floor=1.0))]
for n in {rows!r}:
    args, kw = on_card(cases["rows%d" % n])
    measures.append(("rows%d" % n, args[:2] + (ROWS_ITERS,) + args[3:],
                     dict(kw, param_tol=0.0, eig_floor=0.0)))
for label, args, kw in measures:
    done = torch.zeros(1, dtype=torch.int32, device=dev)
    a = gn.solve_correspondences_cuda(*args, **kw, iters_out=done)
    b = gn.solve_correspondences_cuda(*args, **kw)
    ms, replayed = graph_ms(lambda: gn.solve_correspondences_cuda(*args, **kw))
    assert torch.equal(a, b), f"{{label}}: two launches differ"
    assert torch.equal(a, replayed), f"{{label}}: the graph's answer differs from the eager one"
    if label in {compositions!r}:
        want = gn.solve_correspondences_plain(*args, **kw)
        err = float((a - want).abs().max())
        assert err <= chip_smoke.GN_TOL, f"{{label}}: kernel and plain solve {{err:.3e}} apart"
        out["err"][label] = err
    out["ms"][label] = ms
    out["iters_run"][label] = int(done)
    out["answers"][label] = a.tolist()
    out["blocks"][label] = plan(args[0].cp.shape[0], kw.get("prior_weight", 0.0) > 0)[0] \
        if plan else 1
print("RESULT " + json.dumps(out))
"""


def _record(frames):
    """The recorded compositions and the per-row batches, on the CPU."""
    import torch
    import chip_smoke
    from alego_tpu_torch import PipelineConfig, kernels

    kernels.build()
    cfg = PipelineConfig().replace(loop_in_step=False)
    _, pts, mask = chip_smoke.render(cfg, frames)
    seen = chip_smoke._record_solves(cfg, pts, mask)
    cpu = lambda x: x.cpu() if torch.is_tensor(x) else x   # noqa: E731
    cases = {}
    for label, (corr, p0, iters, dims, delta, kw) in seen.items():
        cases[label] = (type(corr)(*(t.cpu() for t in corr)), p0.cpu(), iters, dims.cpu(),
                        delta, {k: cpu(v) for k, v in kw.items()})
    corr, p0, iters, dims, delta, kw = cases["mapping"]
    for n in ROWS:
        idx = torch.arange(n) % corr.cp.shape[0]
        cases[f"rows{n}"] = (type(corr)(*(t.index_select(0, idx).contiguous() for t in corr)),
                             p0, iters, dims, delta, kw)
    return cases


def _floor_library(tmp):
    from alego_tpu_torch import kernels
    src, lib = os.path.join(tmp, "floor.cu"), os.path.join(tmp, "libfloor.so")
    with open(src, "w") as f:
        f.write(FLOOR_SOURCE)
    subprocess.run([kernels.nvcc(), kernels.ARCH, "-std=c++17", "-O3", "-shared", "-Xcompiler",
                    "-fPIC", "-o", lib, src], check=True, capture_output=True, text=True)
    fn = ctypes.CDLL(lib).floor_launch
    fn.argtypes = [ctypes.c_int] * 6 + [ctypes.c_void_p] * 2
    fn.restype = ctypes.c_int
    return fn


def _floor_ms(launch, blocks, iters, design):
    """Device ms of the sync floor of ``design``'s launch shape."""
    import torch
    threads, block_syncs, cluster_syncs = SHAPES[design]
    cluster_syncs = cluster_syncs if blocks > 1 else 0
    sink = torch.zeros(1, dtype=torch.int32, device="cuda")

    def run():
        status = launch(blocks, threads, iters, block_syncs, cluster_syncs,
                        int(design == "cluster"), sink.data_ptr(),
                        torch.cuda.current_stream().cuda_stream)
        if status:
            raise RuntimeError(f"sync floor: launch failed with error {status}")
        return sink
    return graph_ms(run)[0]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("other", help="root of the other tree")
    ap.add_argument("--frames", type=int, default=32, help="frames whose solves are recorded")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("ab_gn: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    other = os.path.abspath(args.other)
    turns = []
    with tempfile.TemporaryDirectory(prefix="ab_gn_") as tmp:
        cases_path = os.path.join(tmp, "cases.pt")
        cases = _record(args.frames)
        torch.save(cases, cases_path)
        for name, tree in (("other", other), ("this", REPO), ("this", REPO), ("other", other)):
            code = TURN.format(tree=tree, tools=os.path.join(REPO, "tools"), cases=cases_path,
                               rows_iters=ROWS_ITERS, compositions=COMPOSITIONS, rows=ROWS)
            proc = subprocess.run([sys.executable, "-c", code], cwd=tree, capture_output=True,
                                  text=True)
            lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("RESULT ")]
            if proc.returncode or not lines:
                print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
                raise RuntimeError(f"the {name} turn failed ({proc.returncode})")
            turns.append(dict(tree=name, **json.loads(lines[-1][len("RESULT "):])))
            print(json.dumps(turns[-1]), flush=True)
        floor = _floor_library(tmp)
        summary = {}
        for name in ("other", "this"):
            mine = [t for t in turns if t["tree"] == name]
            ms = {k: sum(t["ms"][k] for t in mine) / len(mine) for k in mine[0]["ms"]}
            design, blocks = mine[0]["design"], mine[0]["blocks"]
            per = {}
            for c in COMPOSITIONS:
                run = mine[0]["iters_run"]
                # a forced run still stops at a step of exactly 0
                forced = run[c + "_forcedN"]
                it_ms = (ms[c + "_forcedN"] - ms[c + "_forced1"]) / max(forced - 1, 1)
                per[c] = dict(
                    bare_ms=ms[c], iters_run=run[c], max_iters=cases[c][2], forced_iters=forced,
                    blocks=blocks[c], ms_per_iter=it_ms, fixed_ms=ms[c + "_forced1"] - it_ms,
                    projector_ms=ms[c + "_proj1"] - ms[c + "_proj0"],
                    floor_ms=_floor_ms(floor, blocks[c], run[c], design),
                    floor_forcedN_ms=_floor_ms(floor, blocks[c], forced, design),
                    floor_empty_ms=_floor_ms(floor, blocks[c], 0, design))
                per[c]["floor_ms_per_iter"] = ((per[c]["floor_forcedN_ms"]
                                                - per[c]["floor_empty_ms"]) / max(forced, 1))
            for n in ROWS:
                per[f"rows{n}"] = dict(ms=ms[f"rows{n}"], blocks=blocks[f"rows{n}"],
                                       iters=ROWS_ITERS)
            summary[name] = dict(design=design, ms=ms, per=per,
                                 spread={k: [t["ms"][k] for t in mine] for k in ms})
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    speedup = {k: summary["other"]["ms"][k] / summary["this"]["ms"][k]
               for k in summary["this"]["ms"]}
    same = all(t["answers"] == turns[0]["answers"] for t in turns)
    print(json.dumps({"card": smi, "frames": args.frames, "summary": summary,
                      "speedup_other_over_this": speedup, "answers_equal": same}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
