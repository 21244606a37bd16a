#!/usr/bin/env python3
"""The loop path of ``chip_smoke.py`` on two trees of the repository in one
call, on one card: this tree and ``OTHER`` (for example the parent commit,
unpacked with ``git archive``), in turns: other, this, this, other.

Usage: ``python3 tools/ab_loop_path.py OTHER [--runs 2] [--ranks 4]
[--laps 1]`` from the root of the repository, on a machine with a CUDA GPU.

The 192-frame bench circuit (``--laps`` times; after the first, each lap
renders with another noise seed) is rendered once and handed to each turn
through a temporary file.  Each turn is a process of its own that imports
``chip_smoke`` and ``alego_tpu_torch`` from its tree (building that tree's
kernels on its first turn).  It runs the circuit ``--runs`` times, each on
a fresh ``SlamPipeline`` (so each pays the graphs' captures; the first also
loads the libraries): once with one synchronise at the end (ms/frame, peak
MiB, the captures' seconds where the tree reports them; on one lap the
pinned loop pairs, attempts and ATEs are asserted), then once more with a
synchronise after every frame (the frames' latencies).  With ``--ranks N``
the turn then runs the single map on N ranks sharing the card over
host-staged gloo (``chip_smoke``'s phase ``mesh_ranks``, without its
front-end and solver jobs), once, after a 2-frame warm-up.  Prints one
JSON object: per turn, the tree, and per run its ms/frame, the synchronised
run's ms/frame, its first frame and its five slowest others (frame, ms);
the single map's ms/frame and loop pairs; whether every turn gave the same
answers; the card's ``nvidia-smi`` name and power limit.  The tool stands
in for a benchmark of the port until one exists.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TURN = r"""
import json, os, sys, time
import numpy as np
sys.path.insert(0, {tree!r})
import torch
import chip_smoke
from alego_tpu_torch import PipelineConfig, kernels
from alego_tpu_torch.models.pipeline import SlamPipeline
kernels.build()
frames = np.load(os.path.join({tmp!r}, "frames.npz"))
gt, pts, mask = frames["gt"], frames["pts"], frames["mask"]
n = pts.shape[0]
cfg = PipelineConfig().replace(loop_in_step=False)
out = dict(runs=[])
for _ in range({runs}):
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    pipe = SlamPipeline(cfg, device="cuda")
    seconds = chip_smoke.timed_pass(pipe, pts, mask)
    res = chip_smoke._loop_results(pipe, gt)
    if {laps} == 1:
        chip_smoke._check_loop_results(res, "loop path")
    loop = getattr(pipe, "loop_graph", None)
    captures = pipe.graphs.capture_seconds + (loop.capture_seconds if loop else 0.0)
    run = dict(ms_per_frame=seconds / n * 1e3,
               ms_per_frame_less_captures=(seconds - captures) / n * 1e3,
               step_capture_s=pipe.graphs.capture_seconds,
               loop_capture_s=loop.capture_seconds if loop else None,
               loop_warmup_s=loop.warmup_seconds if loop else None,
               peak_mib=torch.cuda.max_memory_allocated() / 2 ** 20,
               **{{k: res[k] for k in ("attempts", "loops", "loop_pairs", "ate_m", "kf_ate_m")}})
    del pipe, loop
    pipe = SlamPipeline(cfg, device="cuda")
    lat = []
    for k in range(n):
        t0 = time.perf_counter()
        pipe.process(pts[k], mask[k])
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t0) * 1e3)
    worst = sorted(range(1, n), key=lambda k: -lat[k])[:5]
    run.update(synced_ms_per_frame=sum(lat) / n, first_frame_ms=lat[0],
               slowest_frames_ms=[[k, lat[k]] for k in worst])
    out["runs"].append(run)
    del pipe
if {ranks}:
    from alego_tpu_torch.parallel import launch, ranks
    path = ranks.save_frames(os.path.join({tmp!r}, "circuit"), pts, mask)
    torch.cuda.empty_cache()
    res = launch.launch(ranks.run_jobs, {ranks}, [(ranks.distributed_run, (cfg, path, 2))],
                        backend="gloo", device="cuda", cards=1, timeout=900)[0]
    out["single_map"] = dict(ranks={ranks}, ms_per_frame=res["seconds"] / n * 1e3,
                             loop_pairs=res["loop_pairs"], attempts=res["attempts"])
print("RESULT " + json.dumps(out))
"""


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("other", help="root of the other tree")
    ap.add_argument("--runs", type=int, default=2, help="loop-path runs per turn")
    ap.add_argument("--ranks", type=int, default=0,
                    help="ranks of the single-map run per turn (0: none)")
    ap.add_argument("--laps", type=int, default=1,
                    help="laps of the circuit (after the first, each lap renders with "
                         "another noise seed; only one lap has pinned answers)")
    args = ap.parse_args(argv)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("ab_loop_path: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import chip_smoke
    from alego_tpu_torch import PipelineConfig

    other = os.path.abspath(args.other)
    cfg = PipelineConfig().replace(loop_in_step=False)
    gt, pts, mask = chip_smoke.render(cfg, chip_smoke.N_CIRCUIT)
    if args.laps > 1:   # the circuit ends on its start pose: each later lap skips it
        from alego_tpu_torch.utils import synthetic
        world = synthetic.make_world(seed=100, clear_path=gt[:, :2, 3])
        laps = [(gt, pts, mask)]
        for lap in range(1, args.laps):
            laps.append((gt[1:],) + synthetic.render_sequence(world, gt[1:], cfg, noise=0.01,
                                                               seed=lap))
        gt, pts, mask = (np.concatenate(a) for a in zip(*laps))
        del laps
    turns = []
    with tempfile.TemporaryDirectory(prefix="ab_loop_") as tmp:
        np.savez(os.path.join(tmp, "frames.npz"), gt=gt, pts=pts, mask=mask)
        del gt, pts, mask
        for name, tree in (("other", other), ("this", REPO), ("this", REPO), ("other", other)):
            code = TURN.format(tree=tree, tmp=tmp, runs=args.runs, ranks=args.ranks,
                               laps=args.laps)
            proc = subprocess.run([sys.executable, "-c", code], cwd=tree, capture_output=True,
                                  text=True)
            lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("RESULT ")]
            if proc.returncode or not lines:
                print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
                raise RuntimeError(f"the {name} turn failed ({proc.returncode})")
            turns.append(dict(tree=name, **json.loads(lines[-1][len("RESULT "):])))
            print(json.dumps(turns[-1]), flush=True)
    answers = {json.dumps([{k: r[k] for k in ("attempts", "loop_pairs", "ate_m", "kf_ate_m")}
                           for r in t["runs"]]) for t in turns}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(json.dumps({"card": smi, "laps": args.laps, "answers_equal": len(answers) == 1,
                      "turns": turns}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
