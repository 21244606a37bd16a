#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``alego_tpu_torch``) on one GPU.

Usage: ``python3 chip_smoke.py`` from the root of the repository, on a
machine with an NVIDIA Hopper GPU (sm_90a) and the CUDA toolkit.

Phases (each failure raises and exits non-zero; there is no CPU path):

1. environment: torch/CUDA versions, ``nvcc --version``, the card's name and
   power limit;
2. build: every kernel of ``alego_tpu_torch/csrc`` with ``nvcc`` (one
   process per source, all started together);
3. the main path: ``SlamPipeline(PipelineConfig(loop_in_step=False))``
   over the first 32 frames of the 192-frame closed bench circuit, with the
   kernel launch counts asserted (counts set to 0 just before the timed
   pass), finite poses, and ATE against ground truth held at its known
   value (the kernels are exact);
4. kernels against their plain PyTorch versions on the card, at the shapes
   the frame step gives them at the full default geometry, fed from the
   run's last two frames and the local map it built (CCL also on a random
   maze): agreement, kernel time, bare launch time, plain time, the time of one PyTorch library computation of the
   same function where one exists, and the bound from the shapes;
5. a 4-frame tiny-config run on the card held against the same run on the
   CPU (the CPU path is what the tests hold against the JAX reference).

The last lines of standard output are the card's ``nvidia-smi`` name and
power limit, one JSON object with a row per kernel, and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

# NVIDIA H100 SXM data sheet peaks (dense), at the full 700 W power limit
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12

N_FRAMES = 32          # frames of the main-path run
# the main path's unaligned ATE over those frames; the kernels are exact, so
# a kernel change must leave it where it is
ATE_M, ATE_TOL_M = 0.1207, 1e-4
N_CIRCUIT = 192        # the bench circuit the frames are cut from
# timing: the median over *_WINDOWS windows of *_REPS back-to-back calls
KERNEL_WINDOWS, KERNEL_REPS = 21, 5
PLAIN_WINDOWS, PLAIN_REPS = 3, 1


def log(*a):
    print(*a, flush=True)


def _run(cmd):
    return subprocess.run(cmd, capture_output=True, text=True, check=True).stdout.strip()


def _median_ms(fn, windows=KERNEL_WINDOWS, reps=KERNEL_REPS):
    """Device time of one call of ``fn``: CUDA events around ``reps`` calls
    back to back, divided by ``reps``; the median over ``windows`` such
    windows, after one warm-up call.  Host launch overhead that the device
    cannot hide shows up in the time, as it does on the main path."""
    import torch
    fn()
    times = []
    for _ in range(windows):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return float(np.median(times))


def _bound(nbytes, nops):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = nops / PEAK_F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_environment():
    import torch
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"torch.version.cuda {torch.version.cuda}")
    from alego_tpu_torch import kernels
    log(_run([kernels.nvcc(), "--version"]))
    smi = _run(["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader"])
    log(f"device: {torch.cuda.get_device_name(0)}, count "
        f"{torch.cuda.device_count()}, capability "
        f"{torch.cuda.get_device_capability(0)}")
    return smi.splitlines()[0]


def phase_build():
    from alego_tpu_torch import kernels
    t0 = time.time()
    logs = kernels.build()
    for name, text in logs.items():
        log(f"--- nvcc {name}.cu ---\n{text.strip()}")
    for name in kernels.SOURCES:
        kernels.library(name)
    log(f"kernels built and loaded in {time.time() - t0:.1f} s")


def timed_pass(pipe, pts, mask):
    """Host seconds of one pass of ``pipe`` over the frames, from its current
    state, with one synchronise at the end."""
    import torch
    t0 = time.time()
    for k in range(pts.shape[0]):
        pipe.process(pts[k], mask[k])
    torch.cuda.synchronize()
    return time.time() - t0


def render(cfg, n_frames):
    """The first ``n_frames`` of the reference bench's 192-frame closed
    circuit: ground-truth poses [n, 4, 4], points and masks."""
    from alego_tpu_torch.utils import synthetic
    poses = synthetic.loop_trajectory(N_CIRCUIT, radius=30.0, speed=1.6,
                                      closed=True)
    world = synthetic.make_world(seed=100, clear_path=poses[:, :2, 3])
    t0 = time.time()
    pts, mask = synthetic.render_sequence(world, poses[:n_frames], cfg,
                                          noise=0.01, seed=0)
    log(f"rendered {n_frames} frames {cfg.n_scan}x{cfg.horizon_scan} in "
        f"{time.time() - t0:.1f} s")
    return poses[:n_frames], pts, mask


def _frame_features(cfg, pts, mask, dev):
    import torch
    from alego_tpu_torch.ops.projection import project_scan
    from alego_tpu_torch.ops.segmentation import segment_scan
    from alego_tpu_torch.ops.features import extract_features
    img = project_scan(torch.as_tensor(pts, device=dev),
                       torch.as_tensor(mask, device=dev), cfg)
    seg = segment_scan(img, cfg)
    return img, seg, extract_features(seg, cfg)


def phase_kernels(cfg, pts, mask, state):
    """Every kernel against its plain version at the main-path shapes."""
    import torch
    from alego_tpu_torch.ops import ccl, se3
    from alego_tpu_torch.ops.segmentation import _neighbor_connectivity
    from alego_tpu_torch.models import laser_mapping as lm

    dev = torch.device("cuda")
    rows = []

    # ---- CCL on the last rendered frame (frame 31) and on a random maze ----
    img, seg, fc = _frame_features(cfg, pts[-1], mask[-1], dev)
    conn_r, conn_u = _neighbor_connectivity(img.ranges, img.valid & ~img.ground, cfg)
    conn_r, conn_u = conn_r.contiguous(), conn_u.contiguous()
    R, H = conn_r.shape
    g = torch.Generator().manual_seed(0)   # the maze of test_torch_kernels_gpu.py
    maze_r = (torch.rand((R, H), generator=g) < 0.7).to(dev)
    maze_u = (torch.rand((R - 1, H), generator=g) < 0.5).to(dev)
    for what, cr, cu in (("frame", conn_r, conn_u), ("maze", maze_r, maze_u)):
        lab_k = ccl.ccl_cuda(cr, cu)
        lab_p = ccl.ccl_plain(cr, cu)
        torch.cuda.synchronize()
        err = int((lab_k != lab_p).sum())
        assert err == 0, f"CCL kernel disagrees with the plain fixpoint on {err} pixels ({what})"
    ms = _median_ms(lambda: ccl.ccl_cuda(conn_r, conn_u))
    maze_ms = _median_ms(lambda: ccl.ccl_cuda(maze_r, maze_u))
    # the bare launch (three CUDA kernels), without the wrapper's checks and
    # allocation
    labels, launch = torch.empty((R, H), dtype=torch.int32, device=dev), ccl._launcher()
    stream = torch.cuda.current_stream().cuda_stream
    kernel_only_ms = _median_ms(lambda: launch(conn_r.data_ptr(), conn_u.data_ptr(), R, H,
                                               labels.data_ptr(), stream))
    plain_ms = _median_ms(lambda: ccl.ccl_plain(conn_r, conn_u), PLAIN_WINDOWS, PLAIN_REPS)
    # the function's own work, whatever schedule reaches the fixpoint: both
    # edge masks read once, the int32 labels written once, and one pass of a
    # 4-neighbour min per pixel
    nbytes = conn_r.numel() + conn_u.numel() + 4 * R * H
    bound_ms, bound_by = _bound(nbytes, R * H * 4)
    log(f"ccl {R}x{H}: equal labels on the frame and the maze, kernel {ms:.4f} ms "
        f"(bare launch {kernel_only_ms:.4f} ms; maze {maze_ms:.4f} ms), plain "
        f"{plain_ms:.4f} ms, bound {bound_ms:.6f} ms ({bound_by})")
    rows.append(dict(name="ccl", route="cuda", source="alego_tpu_torch/csrc/ccl.cu",
                     replaces="alego_tpu/ops/pallas_ccl.py:103",
                     shapes=[f"{R}x{H}"], max_abs_err=0.0, ms=ms, maze_ms=maze_ms,
                     kernel_only_ms=kernel_only_ms, plain_ms=plain_ms,
                     bound_ms=bound_ms, bound_by=bound_by, library_ms=None))

    # ---- 1-NN: odometry association of the last frame against the one before ----
    _, _, fc_prev = _frame_features(cfg, pts[-2], mask[-2], dev)
    params = state.odo.params
    nn1_cases = [
        ("surf", se3.transform_points(params, fc.flat_pts), fc.flat_valid,
         fc_prev.less_flat_pts, fc_prev.less_flat_valid),
        ("corner", se3.transform_points(params, fc.sharp_pts), fc.sharp_valid,
         fc_prev.less_sharp_pts, fc_prev.less_sharp_valid),
    ]
    rows.append(_nn_row("nn1", "alego_tpu/ops/pallas_nn.py:108", nn1_cases, 1))

    # ---- k-NN: scan-to-map association against the real local map ----
    map_c, map_c_ok, map_s, map_s_ok = lm._build_local_map(state.mapping, cfg)
    c_ds, c_ok, _, _, _, _, st_ds, st_ok = lm._downsample_scan(
        fc.less_sharp_pts, fc.less_sharp_valid, fc.less_flat_pts,
        fc.less_flat_valid, seg.outlier_points, seg.outlier_valid, cfg)
    p = se3.mat_to_params(state.mapping.T_map2laser)
    knn_cases = [
        ("corner", se3.transform_points(p, c_ds), c_ok, map_c, map_c_ok),
        ("surf", se3.transform_points(p, st_ds), st_ok, map_s, map_s_ok),
    ]
    rows.append(_nn_row("knn", "alego_tpu/ops/pallas_nn.py:227", knn_cases,
                        cfg.map_knn))
    return rows


def _live(mask):
    """1 + index of the last True of ``mask`` (0 if none): the live length
    the bound counts."""
    idx = mask.nonzero()
    return int(idx[-1, 0]) + 1 if idx.numel() else 0


def _nn_row(name, replaces, cases, k):
    """Check and time one NN kernel over its main-path shapes.  The row's
    times are sums over the shapes (one launch of each)."""
    import torch
    from alego_tpu_torch.ops import nn

    tot = dict(ms=0.0, kernel_only_ms=0.0, plain_ms=0.0, library_ms=0.0,
               bytes_ms=0.0, ops_ms=0.0)
    max_err, shapes = 0.0, []
    for label, q, qm, r, rm in cases:
        q, r = q.contiguous(), r.contiguous()
        if k == 1:
            kern = lambda: nn.nn1_cuda(q, qm, r, rm)          # noqa: E731
            plain = lambda: nn.nn1_plain(q, qm, r, rm)        # noqa: E731
        else:
            kern = lambda: nn.knn_cuda(q, qm, r, rm, k)       # noqa: E731
            plain = lambda: nn.knn_plain(q, qm, r, rm, k)     # noqa: E731
        d_k, i_k = kern()
        d_p, i_p = plain()
        torch.cuda.synchronize()
        v = qm
        err = float((d_k[v] - d_p[v]).abs().max()) if bool(v.any()) else 0.0
        # held bit for bit, invalid queries and fill slots included
        assert torch.equal(d_k, d_p), f"{name} {label}: d2 differs from the plain version"
        n_idx = int((i_k != i_p).sum())
        assert n_idx == 0, f"{name} {label}: {n_idx} indices differ from the plain version"
        max_err = max(max_err, err)

        q_live, r_live = _live(qm), _live(rm)
        ms = _median_ms(kern)
        # the bare kernel launch, without the wrapper's checks and allocations
        Q, N = q.shape[0], r.shape[0]
        d_out, i_out = torch.empty_like(d_k), torch.empty_like(i_k)
        stream = torch.cuda.current_stream().cuda_stream
        ptrs = (q.data_ptr(), qm.data_ptr(), r.data_ptr(), rm.data_ptr())
        sms = nn._sm_count(q.device)
        if k == 1:
            chunk = nn.nn1_chunk(Q, N, sms)
            part = torch.empty((-(-N // chunk), Q), dtype=torch.int64, device=q.device)
            launch = nn._nn1_launcher()
            kernel_only_ms = _median_ms(lambda: launch(
                *ptrs, Q, N, chunk, part.data_ptr(), d_out.data_ptr(),
                i_out.data_ptr(), stream))
        else:
            chunk = nn.knn_chunk(Q, N, k, sms)
            part = torch.empty((-(-N // chunk), k, Q), dtype=torch.int64, device=q.device)
            launch = nn._launcher()
            kernel_only_ms = _median_ms(lambda: launch(
                *ptrs, Q, N, k, chunk, part.data_ptr(), d_out.data_ptr(),
                i_out.data_ptr(), stream))
        plain_ms = _median_ms(plain, PLAIN_WINDOWS, PLAIN_REPS)
        pen = torch.where(rm, 0.0, float("inf"))

        def library():
            d = torch.cdist(q, r, compute_mode="donot_use_mm_for_euclid_dist")
            d = d * d + pen[None, :]
            return torch.topk(d, k, dim=1, largest=False)
        lib_ms = _median_ms(library, KERNEL_WINDOWS, 1)
        nbytes = Q * 13 + N * 13 + Q * k * 8
        bytes_ms, _ = _bound(nbytes, 0)
        ops_ms, _ = _bound(0, q_live * r_live * 9)
        shapes.append(f"{label} {Q}x{N} (live {q_live}x{r_live})")
        log(f"{name} {label} {Q}x{N}, live {q_live}x{r_live}, {-(-N // chunk)} chunks "
            f"of {chunk}: max |d2 err| {err:.3e}, kernel {ms:.4f} ms (bare launch "
            f"{kernel_only_ms:.4f} ms), plain {plain_ms:.4f} ms, "
            f"library {lib_ms:.4f} ms, bound {max(bytes_ms, ops_ms):.6f} ms")
        for key, val in (("ms", ms), ("kernel_only_ms", kernel_only_ms),
                         ("plain_ms", plain_ms), ("library_ms", lib_ms),
                         ("bytes_ms", bytes_ms), ("ops_ms", ops_ms)):
            tot[key] += val
    bound_ms, bound_by = ((tot["bytes_ms"], "bytes") if tot["bytes_ms"] >= tot["ops_ms"]
                          else (tot["ops_ms"], "operations"))
    source = "alego_tpu_torch/csrc/nn1.cu" if k == 1 else "alego_tpu_torch/csrc/nn.cu"
    return dict(name=name, route="cuda", source=source, replaces=replaces,
                shapes=shapes, max_abs_err=max_err, ms=tot["ms"],
                kernel_only_ms=tot["kernel_only_ms"],
                plain_ms=tot["plain_ms"], bound_ms=bound_ms, bound_by=bound_by,
                library_ms=tot["library_ms"])


def phase_main_path(cfg, gt, pts, mask):
    """Two passes over the frames (the first warms up the allocator and the
    kernel libraries); the second is timed and counted."""
    import torch
    from alego_tpu_torch import kernels
    from alego_tpu_torch.models.pipeline import SlamPipeline
    from alego_tpu_torch.utils.metrics import ate_rmse

    pipe = SlamPipeline(cfg, device="cuda")
    pipe.run(pts, mask)
    pipe.reset()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.LAUNCHES.clear()
    total_s = timed_pass(pipe, pts, mask)
    launches = dict(kernels.LAUNCHES)
    est = torch.stack(pipe.poses).cpu().numpy()

    n = pts.shape[0]
    n_map = -(-n // cfg.map_frame_decimation)
    expected = {"ccl": n, "nn1": 2 * max(cfg.odom_outer_iters, 1) * n,
                "knn": 2 * cfg.map_outer_iters * n_map}
    log(f"launches {launches}, expected {expected}")
    assert launches == expected, f"launch counts {launches} != {expected}"
    assert np.isfinite(est).all(), "non-finite pose"
    ate = ate_rmse(est[:, :3, 3], gt[:, :3, 3], align=False)
    n_kf = int(pipe.state.mapping.graph.count)
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    ms_frame = total_s / n * 1e3
    log(f"main path: {n} frames in {total_s:.3f} s = {ms_frame:.3f} ms/frame "
        f"(host clock, one synchronise at the end), ATE {ate:.6f} m "
        f"(unaligned), {n_kf} keyframes, peak memory {peak:.1f} MiB")
    assert abs(ate - ATE_M) <= ATE_TOL_M, f"ATE {ate:.5f} m moved from {ATE_M} m"
    return pipe.state, launches, dict(frames=n, ms_per_frame=ms_frame, ate_m=ate,
                                      keyframes=n_kf, peak_mib=peak)


def phase_cpu_agreement():
    """4 tiny-config frames on the card against the same run on the CPU."""
    from alego_tpu_torch import tiny_config
    from alego_tpu_torch.models.pipeline import SlamPipeline
    from alego_tpu_torch.utils import synthetic

    cfg = tiny_config().replace(loop_in_step=False)
    world = synthetic.make_world(seed=3)
    poses = synthetic.loop_trajectory(4, radius=20.0, speed=1.0, closed=False)
    pts, mask = synthetic.render_sequence(world, poses, cfg, noise=0.01)
    gpu = SlamPipeline(cfg, device="cuda").run(pts, mask)
    cpu = SlamPipeline(cfg, device="cpu").run(pts, mask)
    dt = float(np.abs(gpu[:, :3, 3] - cpu[:, :3, 3]).max())
    dr = float(np.abs(gpu[:, :3, :3] - cpu[:, :3, :3]).max())
    log(f"tiny config, 4 frames, card vs CPU: max |dt| {dt:.3e} m, max |dR| {dr:.3e}")
    assert dt < 1e-4 and dr < 1e-5, "card and CPU disagree"
    return dt


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import warnings
    warnings.filterwarnings("ignore", message="loop closure is not ported",
                            category=RuntimeWarning)
    from alego_tpu_torch import PipelineConfig

    t_start = time.time()
    smi = phase_environment()
    phase_build()
    cfg = PipelineConfig().replace(loop_in_step=False)
    gt, pts, mask = render(cfg, N_FRAMES)

    state, launches, summary = phase_main_path(cfg, gt, pts, mask)
    # the kernels are checked on the frames and the local map of that run
    rows = phase_kernels(cfg, pts, mask, state)
    for row in rows:
        row["launches"] = launches.get(row["name"], 0)
    phase_cpu_agreement()
    log(f"summary {json.dumps(summary)}; total {time.time() - t_start:.1f} s")
    print(smi)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
