"""The port's benchmark: one cell of ``BENCHMARK.json``, one run.

Usage, from the root of a checkout on a machine with the cell's cards::

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (``setup_s``, from the start of this script to the first timed
frame): imports, the drive rendered on the card from the seed and held on
the host as padded NumPy scans, ``SlamPipeline`` built, and a warm-up drive
that captures the frame step's CUDA graphs and, where the mix closes loops,
the loop attempt's.  The window then runs drives back to back, each on a
fresh map (``SlamPipeline.reset``), until ``--seconds`` have passed: every
sweep, or chunk of sweeps, is handed to the program as the mix says and its
poses are read to the host before the next.  ``fps`` is the frames
completed over the window's time, less the check's snapshots of the
program's state at a few calls of the first drive; ``frame_ms_p99`` the
99th percentile of the frames' latencies, from hand-over to the pose on the
host.

With ``--trace 1`` a stretch of the window (``cells/<cell>.json``) runs
under ``torch.profiler`` and the line carries the cell's per-layer metrics,
read by ``metrics/<metric>.py`` from the run's record, with the device's
busy and window seconds and a breakdown.

After the window the program's state is freed and ``check.py`` holds the
program's answers against the plain reference.  The last line of standard
output is one JSON object; the numbers compared and their limits are also
the last lines of standard error.  Exits non-zero, with no result, without
the cards the cell asks for, or if JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# build and kernel caches of the program stay inside the checkout, at fixed paths
CACHE = os.path.join(ROOT, ".portbench_cache")
os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
os.environ.setdefault("OMP_NUM_THREADS", "2")

FORBIDDEN = ("jax", "jaxlib", "flax", "alego_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def parse(argv):
    ap = argparse.ArgumentParser(description="the port's benchmark: one cell, one run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def pipeline_config(cls, fields: dict, laser_type):
    """A ``PipelineConfig`` (the program's or the reference's class) from a
    configuration file's ``pipeline_config``."""
    kw = {k: tuple(v) if isinstance(v, list) else v for k, v in fields.items()}
    kw["laser_type"] = laser_type(kw["laser_type"])
    return cls(**kw)


def plan_checks(plan: dict, n: int, chunk: int, loop_every: int, seed: int) -> list:
    """The calls of the first drive whose state the check snapshots: the
    first frame of each, drawn from the seed.  ``attempt``: calls after
    which a loop attempt is due, in the drive's second half; ``other``:
    the rest, after the start's frames."""
    import numpy as np
    rng = np.random.default_rng(seed)
    starts = list(range(0, n - chunk + 1, chunk))
    due = [k for k in starts if (k + chunk) // loop_every != k // loop_every and k >= n // 2]
    other = [k for k in starts if k >= plan["start_frames"] and k not in due]
    pick = []
    for pool, count in ((due, plan["attempt_steps"]), (other, plan["other_steps"])):
        pick += rng.choice(pool, size=min(count, len(pool)), replace=False).tolist() if pool else []
    return sorted(pick)


class Window:
    """The measured drives, and what the check and the readers need of them."""

    def __init__(self):
        self.frames = self.failed = 0
        self.calls = []           # per call: (drive, first frame)
        self.latency_s, self.enqueue_s, self.attempt = [], [], []
        self.traced = []          # per call: inside the profiled stretch
        self.clean = []           # per call: before the profiler first started
        self.sessions = []        # (frames, attempts, loops held, loops over the cap) per drive
        self.start_poses, self.steps = [], []
        self.seconds = 0.0
        self.trace = {}


def run_window(pipe, drive, cell, args, profiler_factory, attempts, launches):
    import numpy as np
    from torch.profiler import record_function
    import check

    plan = cell.plan
    n, chunk = drive.points.shape[0], drive.chunk
    cfg = pipe.cfg
    checks = set(plan_checks(plan["check"], n, chunk, cfg.loop_every_n_frames, args.seed))
    tr = plan["trace"]
    prof = None
    w = Window()
    t_start = time.perf_counter()
    paused = 0.0              # the check's snapshots, off the window's clock
    session = 0
    done = False
    while not done:
        pipe.reset()
        for k in range(0, n - chunk + 1, chunk):
            traced = profiler_factory is not None and session == tr["session"] and \
                tr["from_frame"] <= k < tr["from_frame"] + tr["frames"]
            if traced and prof is None:
                # the first profiler of the process: CUDA's tracing stays
                # hooked into the runtime after it stops, and slows the host
                prof = profiler_factory()
                prof.__enter__()
                launches.counting = True
            if not traced and prof:
                prof.__exit__(None, None, None)
                launches.counting = False
                w.trace, prof = prof, False
            pre = None
            if session == 0 and k in checks:
                tp = time.perf_counter()
                pre = check.snapshot(pipe.state)
                paused += time.perf_counter() - tp
            a0 = attempts[0]
            with record_function("portbench.frame"):
                t0 = time.perf_counter()
                with record_function("portbench.call"):
                    if chunk == 1:
                        out = pipe.process(drive.points[k], drive.mask[k])
                    else:
                        poses = pipe.run_scanned(drive.points[k:k + chunk], drive.mask[k:k + chunk])
                t1 = time.perf_counter()
                if chunk == 1:
                    poses = out.to("cpu", copy=True).numpy()[None]
                t2 = time.perf_counter()
            w.calls.append((session, k))
            w.latency_s.append(t2 - t0)
            w.enqueue_s.append(t1 - t0)
            w.attempt.append(attempts[0] > a0)
            w.traced.append(traced)
            w.clean.append(prof is None)
            w.frames += poses.shape[0]
            w.failed += int((~np.isfinite(poses).reshape(poses.shape[0], -1).all(1)).sum())
            if session == 0 and k < plan["check"]["start_frames"]:
                w.start_poses.append(poses)
            if pre is not None:
                tp = time.perf_counter()
                w.steps.append((k, chunk, pre, poses, check.outcome(pipe.state)))
                paused += time.perf_counter() - tp
            elapsed = time.perf_counter() - t_start - paused
            if elapsed >= args.seconds:
                w.seconds = elapsed
                done = True
                break
        ms = pipe.state.mapping
        w.sessions.append((k + chunk, int(ms.loop_attempts), int(ms.graph.loop_count),
                           int(ms.graph.loop_overflow)))
        session += 1
    if prof:
        prof.__exit__(None, None, None)
        launches.counting = False
        w.trace = prof
    return w


def main(argv=None, device="cuda", patch=None, root=None) -> int:
    """One run.  ``device``, ``patch`` and ``root`` are for the
    benchmark's own tests: ``device="cpu"`` skips the look for a card (and
    traces nothing), ``patch(alego_tpu_torch)`` may change the program
    before it runs, and ``root`` holds another ``BENCHMARK.json`` with a
    ``portbench/`` beside it."""
    args = parse(argv)
    import numpy as np
    import torch
    if device == "cuda":
        if not torch.cuda.is_available():
            print("portbench: no CUDA device", file=sys.stderr)
            return 2
    import manifest
    cell = (manifest.cell(args.workload) if root is None
            else manifest.cell(args.workload, root, os.path.join(root, "portbench")))
    if device == "cuda" and torch.cuda.device_count() < cell.chips:
        print(f"portbench: {cell.name} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    torch.set_num_threads(2)
    sys.path.insert(0, ROOT)
    import alego_tpu_torch
    from alego_tpu_torch.models.pipeline import SlamPipeline
    import check
    import roofline
    import profread
    import traffic
    from reference import config as rconfig

    if patch is not None:
        patch(alego_tpu_torch)
    fields = cell.config["pipeline_config"]
    cfg = pipeline_config(alego_tpu_torch.PipelineConfig, fields, alego_tpu_torch.LaserType)
    rcfg = pipeline_config(rconfig.PipelineConfig, fields, rconfig.LaserType)
    launches = roofline.Launches()
    if device == "cuda":
        launches.install()
    drive = traffic.drive(cell.traffic, cfg, args.seed, device)
    if device == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    pipe = SlamPipeline(cfg, device=device)

    # warm-up: every shape of this cell, the graphs captured
    attempts = [0]
    warm = drive.warmup
    n, chunk = drive.points.shape[0], drive.chunk
    for k in range(0, n - chunk + 1, chunk):
        if chunk == 1:
            pipe.process(drive.points[k], drive.mask[k]).cpu()
        else:
            pipe.run_scanned(drive.points[k:k + chunk], drive.mask[k:k + chunk])
        if warm["until_attempt"] and pipe.loop_graph is not None:
            break
        if not warm["until_attempt"] and k + chunk >= warm["frames"]:
            break
    if pipe.loop_graph is not None:
        replay = pipe.loop_graph.replay

        def counted_replay():
            attempts[0] += 1
            replay()
        pipe.loop_graph.replay = counted_replay
    capture_s = sum(g.capture_seconds for g in (pipe.graphs, pipe.loop_graph) if g is not None)

    profiler_factory = None
    if args.trace and device == "cuda":
        from torch.profiler import ProfilerActivity, profile

        def profiler_factory():
            return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    if device == "cuda":
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - T0

    win = run_window(pipe, drive, cell, args, profiler_factory, attempts, launches)
    if device == "cuda":
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        kind, count = torch.cuda.get_device_name(0), 1
    else:
        peak, kind, count = 0, "cpu", 0
    pipe_checks = (pipe._sync_every, pipe._overflow_every)
    del pipe
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()

    # the check, the window closed and the program's state freed
    feed = check.Feed(chunk, cfg.scan_period, cfg.map_frame_decimation, cfg.loop_every_n_frames)
    ref = check.Reference(rcfg, drive.points, drive.mask, feed, device)
    plan = cell.plan["check"]
    start = (np.concatenate(win.start_poses)[:plan["start_frames"]] if win.start_poses
             else np.zeros((0, 4, 4)))
    numbers = check.compare(ref, start, win.steps, plan.get("step_frames", 0))
    correct, rows = check.judge(numbers, cell.plan["check"]["limits"])
    correct = correct and win.failed == 0

    bad = forbidden_modules()
    if bad:
        print(f"portbench: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 3

    lat = np.asarray(win.latency_s) * 1e3
    out = {"correct": bool(correct), "attempted": win.frames, "failed": win.failed}
    device_info = {"platform": "gpu" if device == "cuda" else "cpu", "kind": kind,
                   "count": count, "memory_peak_bytes": int(peak)}
    metrics = {}
    if args.trace == 0:
        values = {"fps": win.frames / win.seconds,
                  "frame_ms_p99": float(np.percentile(lat, 99)),
                  "setup_s": setup_s}
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    else:
        tr = profread.read(win.trace) if win.trace else {}
        record = dict(window=win, trace=tr, capture_s=capture_s, chunk=chunk,
                      host_check_every=(pipe_checks[0], pipe_checks[1]),
                      kernel_bound_s=launches.bound_s(), latency_ms=lat,
                      traced_attempt=[a for a, t in zip(win.attempt, win.traced) if t])
        for m in cell.per_layer:
            v = cell.readers[m["name"]](record)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        if tr:
            device_info.update(busy_s=tr["busy_s"], window_s=tr["window_s"])
            out["breakdown"] = {"device_ops": tr["device_ops"], "idle_gaps": tr["idle_gaps"]}
    out["metrics"] = metrics
    out["device"] = device_info
    out["checks"] = {name: {"value": value, "limit": limit} for name, value, limit in rows}
    for name, value, limit in rows:
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
