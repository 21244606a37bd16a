#!/usr/bin/env python3
"""What moves the port's held answers when the frame step's Gauss-Newton
solves run as the ``gn`` kernel (``csrc/gn.cu``: H and g summed in f64 in
the kernel's own order) instead of the plain solve (``solve_gn`` over the
batch: H = J^T W J by cuBLAS in f32).

Usage: ``python3 tools/gn_attribution.py [--mesh] [--ways ...] [--paths
...]`` from the root of the repository, on a machine with a CUDA GPU.

Runs ``chip_smoke.py``'s held paths several ways, each as ``SlamPipeline``
runs it (the frame step replayed from CUDA graphs), and prints their
answers as one JSON object:

- ``plain``: the plain solve on the card (the solves as they ran before
  the kernel);
- ``reversed`` and ``perm<N>`` (``perm1`` to ``perm4`` by default): the
  plain solve over the batch's rows in reverse order, or in a fixed random
  order (numpy's generator seeded N, one permutation per row count): the
  same sums taken in other orders, perturbations of the size the kernel's
  own order makes;
- ``f64_sums``: the plain solve with H and g summed in f64 from the f32
  rows and rounded once (``gauss_newton.normal_equations``), as the
  kernel sums them;
- ``kernel``: the ``gn`` kernel (``solve_correspondences``);
- ``<way>_vs_plain`` (``kernel_vs_plain``, ``perm<N>_vs_plain``, ...):
  the answer of ``<way>``, with the plain solve run on the same inputs at
  every solve: each path also reports its solves (warm-ups included), the
  largest difference of the two answers and how many solves differ by
  more than 1e-5 (the size of the perturbation ``<way>`` makes).

The paths: the main path's 32 frames (unaligned ATE, keyframes); the
radius-mode map over them (two chunks of 16 through ``run_scanned``); the
192-frame loop path (loop pairs, attempts, ATE of the streamed and of the
corrected keyframe poses); the skewed circuit replayed from a ROS bag
through the CLI with ``--use-imu`` (TUM ATE, loop pairs) and through
``run_scanned`` without de-skew (ATE, loop pairs); with ``--mesh`` also the
single map on 4 gloo ranks sharing the card (ATEs, pairs).
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
from alego_tpu_torch.ops import gauss_newton as gn  # noqa: E402

NORMAL_EQUATIONS = gn.normal_equations
WAYS = ("plain", "reversed", "perm1", "perm2", "perm3", "perm4", "f64_sums", "kernel",
        "kernel_vs_plain")
PATHS = ("main", "radius", "loop", "deskew", "no_deskew")
_orders: dict = {}


def _reordered(way):
    """The plain solve over the batch's rows in the order of ``way``.  The
    order of each row count is made once, at the pipeline's warm-up (which
    runs every solve of a mapping frame), so the captures copy nothing from
    the host."""
    import numpy as np
    import torch

    def solve(corr, params0, *args, **kw):
        n = corr.cp.shape[0]
        idx = _orders.get((way, n, params0.device))
        if idx is None:
            order = (np.arange(n)[::-1] if way == "reversed"
                     else np.random.default_rng(int(way[4:])).permutation(n))
            idx = torch.from_numpy(order.copy()).to(params0.device)
            _orders[(way, n, params0.device)] = idx
        return gn.solve_correspondences_plain(
            type(corr)(*(t.index_select(0, idx) for t in corr)), params0, *args, **kw)
    return solve


def _way(text: str) -> str:
    base = text[:-len("_vs_plain")] if text.endswith("_vs_plain") else text
    if base in WAYS or (base.startswith("perm") and base[4:].isdigit()):
        return text
    raise argparse.ArgumentTypeError(f"unknown way {text!r}")


def _f64_sums(J, Jw, r):
    H, g = NORMAL_EQUATIONS(J.double(), Jw.double(), r.double())
    return H.to(J.dtype), g.to(J.dtype)


# kernel_vs_plain's running counts on the card: solves, largest difference,
# solves differing by more than 1e-5 (written in place, so a captured
# frame updates them at every replay)
STATS: dict = {}


def _compared(solve):
    def compared(corr, params0, *args, **kw):
        import torch
        got = solve(corr, params0, *args, **kw)
        d = (got - gn.solve_correspondences_plain(corr, params0, *args, **kw)).abs().max()
        st = STATS[params0.device.type]
        st[0:1].add_(1.0)
        st[1:2].copy_(torch.maximum(st[1:2], d[None]))
        st[2:3].add_((d > 1e-5).to(st.dtype))
        return got
    return compared


def read_stats(device) -> dict:
    """kernel_vs_plain's counts since the last read, which resets them."""
    import torch
    st = STATS.get(torch.device(device).type)
    if st is None:
        return {}
    n, worst, over = st.tolist()
    st.zero_()
    return dict(solves=int(n), max_diff=worst, over_1e5=int(over))


def use(way: str, device="cuda"):
    """Route the odometry and mapping solves of this process ``way``."""
    import torch
    from alego_tpu_torch.models import laser_mapping as lm, laser_odometry as lo
    gn.normal_equations = _f64_sums if way == "f64_sums" else NORMAL_EQUATIONS
    STATS.clear()
    base = way[:-len("_vs_plain")] if way.endswith("_vs_plain") else way
    solve = (gn.solve_correspondences_plain if base in ("plain", "f64_sums") else
             gn.solve_correspondences if base == "kernel" else _reordered(base))
    if base != way:
        STATS[torch.device(device).type] = torch.zeros(3, device=device)
        solve = _compared(solve)
    lo.solve_correspondences = lm.solve_correspondences = solve


def mesh_rank(comm, way, cfg, frames):
    """A rank of the single map with its solves routed ``way``."""
    from alego_tpu_torch.parallel import ranks
    use(way)
    return ranks.distributed_run(comm, cfg, frames, 2)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--mesh", action="store_true",
                    help="also the single map on 4 gloo ranks sharing the card")
    ap.add_argument("--ways", nargs="+", default=WAYS, type=_way,
                    help="plain, reversed, perm<N> (N a seed), f64_sums, kernel or "
                         "kernel_vs_plain")
    ap.add_argument("--paths", nargs="+", choices=PATHS, default=PATHS)
    args = ap.parse_args(argv)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("gn_attribution: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from alego_tpu_torch import PipelineConfig, cli
    from alego_tpu_torch.models.pipeline import SlamPipeline
    from alego_tpu_torch.parallel import launch, ranks
    from alego_tpu_torch.utils import rosbag
    from alego_tpu_torch.utils.metrics import ate_rmse

    cfg = PipelineConfig().replace(loop_in_step=False)
    n, n32 = cs.N_CIRCUIT, cs.N_FRAMES
    gt, pts, mask = cs.render(cfg, n)
    gt_s, pts_s, mask_s, imu = cs.render_skewed(cfg, n)
    gt_rel = np.einsum("ij,njk->nik", np.linalg.inv(gt_s[0]), gt_s)
    times = np.arange(n, dtype=np.float32) * np.float32(cfg.scan_period)
    tmp = tempfile.mkdtemp(prefix="gn_attribution_")
    bag = os.path.join(tmp, "circuit.bag")
    rosbag.write_bag_pointclouds(
        bag, [(k * cfg.scan_period, pts_s[k][mask_s[k]]) for k in range(n)], imu=imu)
    frames = ranks.save_frames(os.path.join(tmp, "circuit"), pts, mask) if args.mesh else None

    def ate(est, ref):
        return ate_rmse(est[:, :3, 3], ref[:, :3, 3], align=False)

    def pairs(g):
        k = int(g.loop_count)
        return [(int(i), int(j)) for i, j in zip(g.loop_i[:k].tolist(), g.loop_j[:k].tolist())]

    out = {}
    dev = torch.device("cuda")
    for way in args.ways:
        use(way)
        res = {}
        if "main" in args.paths:
            main_path = SlamPipeline(cfg, device="cuda")
            est = main_path.run(pts[:n32], mask[:n32])
            res.update(main_ate_m=ate(est, gt[:n32]),
                       main_keyframes=int(main_path.state.mapping.graph.count),
                       main_solves=read_stats(dev))
        if "radius" in args.paths:
            radius = SlamPipeline(cfg.replace(loop_closure_enabled=False), device="cuda")
            est = np.concatenate([radius.run_scanned(pts[i:i + 16], mask[i:i + 16])
                                  for i in range(0, n32, 16)])
            res.update(radius_ate_m=ate(est, gt[:n32]), radius_solves=read_stats(dev))
        if "loop" in args.paths:
            loop = SlamPipeline(cfg, device="cuda")
            loop.run(pts, mask)
            lr = cs._loop_results(loop, gt)
            res.update({f"loop_{k}": lr[k] for k in ("ate_m", "kf_ate_m", "loop_pairs",
                                                     "attempts", "keyframes")})
            res.update(loop_solves=read_stats(dev))
        if "deskew" in args.paths:
            dst = os.path.join(tmp, f"out_{way}")
            assert cli.main(["--bag", bag, "--use-imu", "--save-map", "--output", dst]) == 0
            tum = np.loadtxt(os.path.join(dst, "trajectory_tum.txt"))
            replay = SlamPipeline(cfg.replace(use_imu=True), device="cuda")
            replay.load_checkpoint(os.path.join(dst, "state.npz"))
            ms = replay.state.mapping
            res.update(deskew_ate_m=ate_rmse(tum[:, 1:4], gt_rel[:len(tum), :3, 3],
                                             align=False),
                       deskew_loop_pairs=pairs(ms.graph), deskew_keyframes=int(ms.graph.count),
                       deskew_attempts=int(ms.loop_attempts), deskew_solves=read_stats(dev))
        if "no_deskew" in args.paths:
            skew = SlamPipeline(cfg, device="cuda")
            est = np.concatenate([skew.run_scanned(pts_s[i:i + 16], mask_s[i:i + 16],
                                                   times=times[i:i + 16])
                                  for i in range(0, n, 16)])
            ms = skew.state.mapping
            res.update(no_deskew_ate_m=ate(est, gt_rel), no_deskew_loop_pairs=pairs(ms.graph),
                       no_deskew_keyframes=int(ms.graph.count),
                       no_deskew_attempts=int(ms.loop_attempts),
                       no_deskew_solves=read_stats(dev))
        if args.mesh:
            torch.cuda.empty_cache()
            m = launch.launch(mesh_rank, cs.MESH_RANKS, way, cfg, frames, backend="gloo",
                              device="cuda", cards=1, timeout=900)
            gt_idx = np.clip(np.round(m["kf_times"] / cfg.scan_period).astype(int), 0, n - 1)
            res.update(mesh_ate_m=ate(m["poses"], gt),
                       mesh_kf_ate_m=ate_rmse(m["kf_poses"][:, :3, 3], gt[gt_idx, :3, 3],
                                              align=False),
                       mesh_loop_pairs=m["loop_pairs"], mesh_attempts=m["attempts"])
        out[way] = res
        print(f"{way}: {json.dumps(res)}", flush=True)
    shutil.rmtree(tmp)
    use("kernel")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(json.dumps(dict(device=smi, **out)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
