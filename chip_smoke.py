#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``alego_tpu_torch``) on one GPU.

Usage: ``python3 chip_smoke.py`` from the root of the repository, on a
machine with an NVIDIA Hopper GPU (sm_90a) and the CUDA toolkit.
``python3 chip_smoke.py --nccl-mesh``, on a machine with 4 such cards, runs
only the single map over 4 NCCL ranks, a card each, and the same 4 ranks
sharing card 0 over host-staged gloo, each against the single loop path of
the same call (phases 12 and 14's checks, without the kernel rows).

Phases (each failure raises and exits non-zero; there is no CPU path; each
phase prints its seconds):

1. environment: torch/CUDA versions, ``nvcc --version``, the card's name and
   power limit;
2. build: every kernel of ``alego_tpu_torch/csrc`` (CCL, 1-NN, k-NN and
   the Gauss-Newton solve ``gn``) with ``nvcc`` (one process per source,
   all started together);
3. the main path: ``SlamPipeline(PipelineConfig(loop_in_step=False))``
   over the first 32 frames of the 192-frame closed bench circuit, its
   frame step replayed from CUDA graphs (as in every single-card phase
   below), with the kernel launch counts asserted (counts set to 0 just
   before the timed pass; ``step_launches``: 32 / 192 / 64 / 224 for
   ``ccl`` / ``nn1`` / ``knn`` / ``gn``), finite poses, and ATE against
   ground truth held at its known value (no loop can close in 32 frames);
   ``graph_step``: the same 32 frames through the graphed pipeline and
   through an eager loop of ``slam_step`` on the card, held against each
   other (launches and keyframes equal, every pose within 1e-5 m), each
   with its ms/frame, host syncs per frame, device busy ms/frame and idle
   share (``torch.profiler``), capture seconds and peak MiB; and the
   device time, in a graph, of the local-map build the capture added on
   every mapping frame (the degeneracy projector runs inside ``gn``);
4. the loop path: the same pipeline over the whole circuit, where the hoisted
   loop-closure attempts (ICP on the 1-NN kernel, the acceptance gate on the
   k = 1 k-NN kernel, the pose-graph solve), each one host read of its gate
   and a replay of the attempt's CUDA graphs (one per ICP and GN iteration
   besides the five around those loops), must close the card's known
   loops, with its number of attempts, no loop factor rejected at capacity,
   and the ATE over the 192 frames and over the corrected keyframe path at
   its known values; one run as a user drives it (counted, counts set to 0
   just before it, and timed: launches in the attempts as the config gives
   them, peak MiB, capture seconds) and one that holds each replayed
   attempt bit for bit against ``loop_closure_step`` run eagerly on a copy
   of its state, and records its candidate pair, launches, host reads and
   seconds both ways (and writes a checkpoint for phase 7);
5. kernels against their plain PyTorch versions on the card, at the shapes
   the frame step gives them at the full default geometry, fed from the
   32-frame run's last two frames and the local map it built (CCL also on a
   random maze), and at the loop shapes on the inputs of the loop path's
   last attempt: agreement, kernel time, bare launch time, plain time, the
   time of one PyTorch library computation of the same function where one
   exists, and the bound from the shapes; the ``gn`` kernel on the last
   solve of each of its three compositions (odometry step A and step B,
   mapping) in an eager run of the 32 frames, against the plain solve
   (within ``GN_TOL``), with the plain solve's time also in a CUDA graph,
   the blocks of each solve's cluster, the bare time per iteration run and
   per iteration with every iteration forced (``param_tol = 0``), and the
   kernel's registers, stack frame and spills from ``nvcc -Xptxas -v``;
6. a 4-frame tiny-config run on the card held against the same run on the
   CPU (the CPU path is what the tests hold against the JAX reference), and
   tiny-config ``loop_closure_step`` on the card against the CPU on the loop
   scene of the tests, from identity and through the bird's-eye-view rescue;
7. ``in_step``: a few frames with ``loop_in_step=True`` (the attempt after
   the frame's replay, gated off), then phase 4's checkpoint resumed in
   that mode to the circuit's end: its attempts replay the loop graph, each
   held bit for bit against the eager attempt, with one host sync (the
   gate) and the loop graph's graph launches each (``torch.profiler``);
8. the radius-mode local map (``loop_closure_enabled=False``): the first 32
   frames through ``run_scanned`` in two chunks of 16, launch counts and the
   ATE held, and no host synchronisation inside a captured frame, in radius
   mode and in the main path's config (``torch.profiler``);
9. de-skew at tiny size, card against CPU, with an IMU stream and with
   odometry (``add_odom``), and a checkpoint saved, loaded and continued on
   the card;
10. the bag replay as a user runs it: the whole circuit rendered with each
   sweep's motion and a 40 Hz IMU stream along the same poses, written to a
   ROS bag and replayed through ``alego_tpu_torch.cli.main(["--bag", ...,
   "--use-imu", "--save-map", ...])`` (``PipelineConfig()`` with
   ``use_imu``, hoisted loop attempts, chunks of 16), counted and timed;
   frames, IMU messages, launches, keyframes, loops and their pairs, and the
   ATE of its TUM trajectory held at the card's answer, beside the ATE of
   the same frames without de-skew through ``run_scanned``;
11. ``mesh_nccl1``: ``DistributedSlamPipeline`` in a one-rank NCCL group
   over the main path's 32 frames: the launches and the ATE of the main
   path (one shard: the candidates' merge is the identity);
12. ``mesh_single_map``: ``DistributedSlamPipeline`` on 4 ranks sharing
   the card over gloo with host-staged collectives, over the whole circuit
   with loop closure (the 5-NN on each rank's quarter of the local map, the
   Schur solve across the ranks), held against the loop path of the same
   call (its loop pairs; trajectory and ATE within 5e-2 m) and at its own
   answer; ms/frame, per-rank launches, seconds in collectives, the largest
   all-gather and the peak memory per rank;
13. ``mesh_lanes``: ``ShardedSlamPipeline``, 2 lanes of 32 frames rendered
   as the CLI's ``--mesh`` renders them, each lane within 1e-6 m of a
   single ``SlamPipeline`` run of its sequence;
14. ``mesh_kernels_and_solver``: the k-NN at the 4-rank shard shapes of
   the local map against its plain version (timed like phase 5), the
   frame-parallel front end of the 4 ranks bit for bit the single front
   end's, and the Schur solve at N = 2048 with 32 loop slots on the 4
   ranks against the single-card ``optimize`` at the reference test's bar
   (tests/test_schur.py, ``test_distributed_fixed_point_at_2048``).

Timings print beside the card's ``nvidia-smi`` name and power limit (the
environment phase's line and the final summary's ``card``).  The last
lines of standard output are the card's ``nvidia-smi`` name and power
limit, one JSON object with a row per kernel, and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

# NVIDIA H100 SXM data sheet peaks (dense), at the full 700 W power limit
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12

N_FRAMES = 32          # frames of the main-path run
# graph_step: the graphed and the eager step over the main path's frames
# agree within this (m): the f64 voxel sums are atomics, whose order can
# move a pose by ~1e-7 m from run to run
GRAPH_POSE_TOL_M = 1e-5
PROFILE_FRAMES = 8     # frames under torch.profiler in graph_step
# the main path's unaligned ATE over those frames; the search kernels are
# exact, so a change of theirs must leave it where it is.  The gn kernel
# puts it at 0.121285 (the kernel at one block as well); its first design
# put it at 0.120759, and with FMA contraction off both designs give
# 0.120705: nvcc's fused multiply-adds round the same f32 operations
# differently in the two.  The plain solve gives 0.120718, and the plain
# solve over its rows in other orders lands in two places: 0.120693 to
# 0.120838 (30 orders) and 0.121283 / 0.121284 (2 of 32 orders), where the
# kernel lands (tools/gn_attribution.py)
ATE_M, ATE_TOL_M = 0.121285, 1e-4
N_CIRCUIT = 192        # the bench circuit the frames are cut from
# the loop path over the whole circuit, held where the card puts it (runs
# repeat it to the last digit): the loop factors (latest, closest keyframe),
# the attempts, and the unaligned ATE (m) of the streamed poses and of the
# corrected keyframe poses.  A sanity note, not the bound: the reference's
# bench on the same circuit reads 0.298 and 0.475 (render seed 0) and 0.569
# streamed at worst over five render seeds, all under 1 m.
LOOP_PAIRS = [(87, 0), (89, 0), (92, 0), (94, 0)]
LOOP_ATTEMPTS = 4
# (the gn kernel's redesign moved the ATEs from 0.32340 / 0.39118, as the
# 32-frame ATE above; the plain solve over the two row orders that reach
# the kernel's 32-frame answer gives 0.32394 / 0.39435 and 0.32396 /
# 0.39246)
LOOP_ATE_M, LOOP_KF_ATE_M, LOOP_ATE_TOL_M = 0.32391, 0.39222, 1e-3
N_IN_STEP = 6          # frames of the loop_in_step=True run
# the in-step mode resumes the loop path's recorded run from its checkpoint
# after this frame, before the first attempt that passes its gate
IN_STEP_FROM = 150
# the radius-mode run over the first N_FRAMES frames (two chunks of 16): its
# unaligned ATE, held like the main path's.  It equals ATE_M: all of those
# keyframes lie within the search radius, and the port's f64 voxel sums do
# not depend on the order in which the selection merges them
RADIUS_ATE_M = 0.121285
# the bag replay: a 40 Hz IMU along the circuit's poses with the noise of
# benchmarks/validate_simlidar.py's synth_imu (orientation sigma 0.3 deg,
# specific force sigma 0.05 m/s^2), from this seed
IMU_HZ, IMU_RPY_SIGMA, IMU_ACC_SIGMA, IMU_SEED = 40, float(np.radians(0.3)), 0.05, 7
# the replay's answer on the card (runs repeat it): loop factors, and the
# unaligned ATE (m) of the CLI's TUM trajectory with de-skew and of the same
# skewed frames through run_scanned without it.  The degeneracy projector's
# eigendecomposition (a fixed-sweep Jacobi in place of torch.linalg.eigh,
# which cannot be captured) moved both ATEs from 0.67855 / 0.94204 to
# 0.67994 / 0.91965 (tools/projector_attribution.py: a 1e-7 perturbation
# of the projector moves them as far).  The gn kernel's sums (f64, its own
# order) moved them to 0.67085 / 0.87136; the plain solve still gives
# 0.67994 / 0.91965 to the last digit, and the plain solve over its rows in
# other orders moves them as far (tools/gn_attribution.py: 0.67037-0.68321
# over 66 orders / 0.69915-0.95193 over 8, one closing (95, 1)); the loop
# factors did not move.  The kernel's redesign moved them to
# 0.68047 / 0.91871, inside those ranges (the two row orders that reach the
# kernel's 32-frame answer: 0.67956 / 0.83415 and 0.67652 / 0.84300)
DESKEW_PAIRS = [(95, 0)]
DESKEW_ATE_M, NO_DESKEW_ATE_M, DESKEW_ATE_TOL_M = 0.68047, 0.91871, 1e-3
# the single map on MESH_RANKS ranks sharing the card: the reference's bars
# against the single-device run (tests/test_distributed_pipeline.py), and
# the card's own answer (runs repeat it to the last digit): the loop
# factors and the unaligned ATE (m) of the streamed and corrected keyframe
# poses, held like the loop path's (moved from 0.32286 / 0.38900 by the
# projector's eigendecomposition, as the replay's above, and from
# 0.32270 / 0.39085 by the gn kernel's redesign: the two row orders
# that reach its 32-frame answer give 0.32382 / 0.39386 and 0.32378 /
# 0.39096)
MESH_RANKS = 4
MESH_TRAJ_TOL_M = MESH_ATE_TOL_M = 5e-2
MESH_LOOP_PAIRS = [(87, 0), (89, 0), (92, 0), (94, 0)]
MESH_ATE_M, MESH_KF_ATE_M = 0.32380, 0.39080
N_LANE = 32           # frames of each --mesh lane
# the gn kernel against its plain solve on the card (params, m and rad):
# the kernel sums H and g in f64 in its own order, the plain solve in f32
# by cuBLAS, so they agree to f32 rounding of the sums, carried through
# the iterations, not bit for bit
GN_TOL = 1e-4
# the gn kernel's arithmetic per row and iteration, counted from its
# source (csrc/gn.cu: the transform and its rpy partials ~63, a line row's
# residual and Jacobian ~72, the checks, Huber weight and weighted row ~17,
# the 27 f64 products and sums of H and g ~54)
GN_OPS_PER_ROW = 206
# timing: the median over *_WINDOWS windows of *_REPS back-to-back calls
KERNEL_WINDOWS, KERNEL_REPS = 21, 5
PLAIN_WINDOWS, PLAIN_REPS = 3, 1


def log(*a):
    print(*a, flush=True)


def step_launches(cfg, n, n_map):
    """The frame step's kernel launches over ``n`` frames, ``n_map`` of
    them mapping: per frame the CCL, and per odometry pass two 1-NN
    searches and two solves (``gn``); per mapping frame and mapping pass
    two k-NN searches and one solve."""
    odo = max(cfg.odom_outer_iters, 1)
    return {"ccl": n, "nn1": 2 * odo * n, "knn": 2 * cfg.map_outer_iters * n_map,
            "gn": 2 * odo * n + cfg.map_outer_iters * n_map}


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
    log(f"card: {smi.splitlines()[0]}")
    log(f"device: {torch.cuda.get_device_name(0)}, count "
        f"{torch.cuda.device_count()}, capability "
        f"{torch.cuda.get_device_capability(0)}")
    return smi.splitlines()[0]


def phase_build():
    """Builds and loads every kernel; returns ``nvcc -Xptxas -v``'s report
    for ``csrc/gn.cu`` (kept beside its library)."""
    from alego_tpu_torch import kernels
    t0 = time.time()
    logs = kernels.build()
    for name, text in logs.items():
        log(f"--- nvcc {name}.cu ---\n{text.strip()}")
    for name in kernels.SOURCES:
        kernels.library(name)
    log(f"kernels built and loaded in {time.time() - t0:.1f} s")
    return kernels.build_log("gn")


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


def phase_kernels(cfg, pts, mask, state, gn_log):
    """Every kernel against its plain version at the main-path shapes
    (``gn_log``: the gn kernel's build report)."""
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
    rows.append(_nn_row("nn1", "nn1", "alego_tpu/ops/pallas_nn.py:108", nn1_cases, 1))

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
    rows.append(_nn_row("knn", "knn", "alego_tpu/ops/pallas_nn.py:227", knn_cases,
                        cfg.map_knn))

    # ---- gn: the last solve of each composition over the 32 frames ----
    rows.append(_gn_row(_record_solves(cfg, pts, mask), gn_log))
    return rows


def _record_solves(cfg, pts, mask):
    """The inputs of the last solve of each composition, odometry step A
    (no column mask), step B (its column masks) and the mapping solve, in
    an eager run of ``slam_step`` over the frames on the card (a graphed
    frame's solves run inside its replay)."""
    import torch
    from alego_tpu_torch.models import laser_mapping as lm, laser_odometry as lo
    from alego_tpu_torch.ops import gauss_newton as gn

    real, seen = gn.solve_correspondences, {}

    def recorder(module):
        def solve(corr, params0, iters, dim_mask, huber_delta, **kw):
            kind = module if module == "mapping" else (
                "step_a" if kw.get("kind_cols") is None else "step_b")
            seen[kind] = (type(corr)(*(t.clone() for t in corr)), params0.clone(), iters,
                          dim_mask.clone(), huber_delta,
                          {k: v.clone() if torch.is_tensor(v) else v for k, v in kw.items()})
            return real(corr, params0, iters, dim_mask, huber_delta, **kw)
        return solve

    lo.solve_correspondences, lm.solve_correspondences = recorder("odometry"), recorder("mapping")
    try:
        eager_steps(cfg, torch.as_tensor(pts, device="cuda"), torch.as_tensor(mask, device="cuda"))
    finally:
        lo.solve_correspondences = lm.solve_correspondences = real
    torch.cuda.synchronize()
    return seen


def _ptxas(log, kernel):
    """Registers, stack frame and spills of ``kernel`` in an ``nvcc -Xptxas
    -v`` log."""
    import re
    lines = log.splitlines()
    out = {}
    for k, line in enumerate(lines):
        if kernel not in line:
            continue
        if "Function properties" in line and k + 1 < len(lines):
            nums = re.findall(r"(\d+) bytes", lines[k + 1])
            out.update(stack_bytes=int(nums[0]), spill_store_bytes=int(nums[1]),
                       spill_load_bytes=int(nums[2]))
        if "Compiling entry function" in line:
            for nxt in lines[k + 1:k + 4]:
                m = re.search(r"Used (\d+) registers", nxt)
                if m:
                    out["registers"] = int(m.group(1))
                    break
    return out


def _gn_row(cases, build_log):
    """The gn kernel against its plain solve (``solve_gn`` over the batch)
    on the recorded solves: agreement, kernel ms, bare launch ms (also per
    iteration run, and per iteration with every iteration forced by
    ``param_tol = 0``, from 1 and ``iters`` iterations; a step of exactly
    0 still stops a forced run, so its iterations are counted), the cluster's
    blocks, plain ms eager and in a CUDA graph, and the bound: the batch's
    bytes read once, or ``GN_OPS_PER_ROW`` operations per row and iteration
    run.  No one PyTorch call computes a GN solve: library none.  Times are
    sums over the three compositions (one launch of each).  ``ptxas``: the
    kernel's registers, stack frame and spills from its build log."""
    import torch
    from alego_tpu_torch.ops import gauss_newton as gn

    tot = dict(ms=0.0, kernel_only_ms=0.0, plain_ms=0.0, plain_graph_ms=0.0,
               bytes_ms=0.0, ops_ms=0.0)
    max_err, shapes, detail = 0.0, [], {}
    for label in ("step_a", "step_b", "mapping"):
        corr, p0, iters, dims, delta, kw = cases[label]
        args = (corr, p0, iters, dims, delta)
        done = torch.zeros(1, dtype=torch.int32, device="cuda")
        got = gn.solve_correspondences_cuda(*args, **kw, iters_out=done)
        want = gn.solve_correspondences_plain(*args, **kw)
        torch.cuda.synchronize()
        err, it = float((got - want).abs().max()), int(done)
        assert bool(torch.isfinite(got).all()), f"gn {label}: non-finite params"
        assert err <= GN_TOL, f"gn {label}: kernel and plain solve {err:.3e} apart"
        max_err = max(max_err, err)
        ms = _median_ms(lambda: gn.solve_correspondences_cuda(*args, **kw))
        out, launch = torch.empty(6, device="cuda"), gn._gn_launcher()
        stream = torch.cuda.current_stream().cuda_stream
        cols = kw.get("kind_cols")
        ptrs = [t.data_ptr() for t in corr]
        n, prior = corr.cp.shape[0], kw.get("prior_weight", 0.0)
        blocks, chunk = gn.gn_plan(n, prior > 0.0)

        def bare(its, tol, done_ptr=None):
            return launch(*ptrs, n, blocks, chunk, None if cols is None else cols.data_ptr(),
                          dims.data_ptr(), p0.data_ptr(), out.data_ptr(), done_ptr, its, delta,
                          kw.get("damping", 1e-6), kw.get("min_count", 0), tol,
                          kw.get("eig_floor", 0.0), prior, kw.get("max_step", 1.0), stream)
        kernel_only_ms = _median_ms(lambda: bare(iters, kw.get("param_tol", 1e-4)))
        forced1_ms = _median_ms(lambda: bare(1, 0.0))
        forced_ms = _median_ms(lambda: bare(iters, 0.0))
        bare(iters, 0.0, done.data_ptr())   # a step of exactly 0 still stops it
        forced = int(done)
        plain = lambda: gn.solve_correspondences_plain(*args, **kw)   # noqa: E731
        plain_ms = _median_ms(plain, PLAIN_WINDOWS, PLAIN_REPS)
        plain_graph_ms = _graph_ms(plain, reps=2)
        live = int((corr.weight > 0).sum())
        nbytes = n * 60 + 6 * 4 * 2 + 6 + (0 if cols is None else 18 * 4)
        bytes_ms, _ = _bound(nbytes, 0)
        ops_ms, _ = _bound(0, it * (n + (6 if prior > 0 else 0)) * GN_OPS_PER_ROW)
        per_iter_forced = (forced_ms - forced1_ms) / max(forced - 1, 1)
        shapes.append(f"{label} {n} rows ({live} weighted), {it} of {iters} iterations, "
                      f"{blocks} blocks")
        detail[label] = dict(rows=n, weighted=live, iters=it, max_iters=iters, blocks=blocks,
                             err=err, ms=ms, kernel_only_ms=kernel_only_ms,
                             ms_per_iter_run=kernel_only_ms / max(it, 1),
                             forced1_ms=forced1_ms, forced_ms=forced_ms, forced_iters=forced,
                             ms_per_iter_forced=per_iter_forced, plain_ms=plain_ms,
                             plain_graph_ms=plain_graph_ms, bound_ms=max(bytes_ms, ops_ms))
        log(f"gn {label} {n} rows ({live} weighted) on {blocks} blocks, {it} of {iters} "
            f"iterations: max |params err| {err:.3e}, kernel {ms:.4f} ms (bare launch "
            f"{kernel_only_ms:.4f} ms, {kernel_only_ms / max(it, 1):.4f} per iteration run; "
            f"forced: {forced1_ms:.4f} ms at 1 and {forced_ms:.4f} at {forced} iterations, "
            f"{per_iter_forced:.4f} per iteration), plain {plain_ms:.4f} ms (in a graph "
            f"{plain_graph_ms:.4f} ms), bound {max(bytes_ms, ops_ms):.6f} ms")
        for key, val in (("ms", ms), ("kernel_only_ms", kernel_only_ms), ("plain_ms", plain_ms),
                         ("plain_graph_ms", plain_graph_ms), ("bytes_ms", bytes_ms),
                         ("ops_ms", ops_ms)):
            tot[key] += val
    bound_ms, bound_by = ((tot["bytes_ms"], "bytes") if tot["bytes_ms"] >= tot["ops_ms"]
                          else (tot["ops_ms"], "operations"))
    ptxas = _ptxas(build_log, "gn_solve")
    log(f"gn ptxas: {ptxas}")
    return dict(name="gn", route="cuda", source="alego_tpu_torch/csrc/gn.cu",
                replaces="alego_tpu/ops/gauss_newton.py:90 (solve_gn's lax.while_loop; "
                         "no Pallas kernel)",
                shapes=shapes, cases=detail, max_abs_err=max_err, ms=tot["ms"],
                kernel_only_ms=tot["kernel_only_ms"], plain_ms=tot["plain_ms"],
                plain_graph_ms=tot["plain_graph_ms"], bound_ms=bound_ms, bound_by=bound_by,
                library_ms=None, cluster_blocks={k: v["blocks"] for k, v in detail.items()},
                ptxas=ptxas)


def _live(mask):
    """1 + index of the last True of ``mask`` (0 if none): the live length
    the bound counts."""
    idx = mask.nonzero()
    return int(idx[-1, 0]) + 1 if idx.numel() else 0


def _nn_row(name, kernel, replaces, cases, k):
    """Check and time one NN kernel (``kernel``: "nn1" or "knn") over its
    shapes on a path.  The row's times are sums over the shapes (one launch
    of each)."""
    import torch
    from alego_tpu_torch.ops import nn

    tot = dict(ms=0.0, kernel_only_ms=0.0, plain_ms=0.0, library_ms=0.0,
               bytes_ms=0.0, ops_ms=0.0)
    max_err, shapes = 0.0, []
    for label, q, qm, r, rm in cases:
        q, r = q.contiguous(), r.contiguous()
        if kernel == "nn1":
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
        if kernel == "nn1":
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
    source = f"alego_tpu_torch/csrc/{'nn1' if kernel == 'nn1' else 'nn'}.cu"
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
    expected = step_launches(cfg, n, -(-n // cfg.map_frame_decimation))
    log(f"launches {launches}, expected {expected}")
    assert launches == expected, f"launch counts {launches} != {expected}"
    assert np.isfinite(est).all(), "non-finite pose"
    ate = ate_rmse(est[:, :3, 3], gt[:, :3, 3], align=False)
    n_kf = int(pipe.state.mapping.graph.count)
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    ms_frame = total_s / n * 1e3
    log(f"main path: {n} frames in {total_s:.3f} s = {ms_frame:.3f} ms/frame "
        f"(host clock, one synchronise at the end), ATE {ate:.6f} m "
        f"(unaligned), {n_kf} keyframes, peak memory {peak:.1f} MiB, graphs "
        f"captured in {pipe.graphs.capture_seconds:.3f} s")
    assert abs(ate - ATE_M) <= ATE_TOL_M, f"ATE {ate:.5f} m moved from {ATE_M} m"
    return pipe.state, launches, dict(frames=n, ms_per_frame=ms_frame, ate_m=ate,
                                      keyframes=n_kf, peak_mib=peak,
                                      capture_s=pipe.graphs.capture_seconds)


def eager_steps(cfg, pts_d, mask_d, n=None):
    """An eager loop of ``slam_step`` on the card over the first ``n``
    frames (all by default) from ``init_state``, the frames already on the
    device: the step as it runs without graphs.  Returns (state, poses)."""
    import torch
    from alego_tpu_torch.models.pipeline import init_state, slam_step

    st, out = init_state(cfg, "cuda"), []
    for k in range(pts_d.shape[0] if n is None else n):
        t = torch.full((), k * cfg.scan_period, device="cuda")
        st, pose = slam_step(st, pts_d[k], mask_d[k], t, cfg,
                             do_map_static=k % cfg.map_frame_decimation == 0,
                             do_loop_static=False)
        out.append(pose)
    return st, torch.stack(out)


def _graph_ms(fn, reps=10):
    """Device ms of one call of ``fn``, replayed from a CUDA graph of
    ``reps`` calls (warmed up on the capture stream first)."""
    import torch
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fn()
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        for _ in range(reps):
            fn()
    return _median_ms(graph.replay, windows=11, reps=1) / reps


def phase_graph_step(cfg, pts, mask):
    """The main path's frames through the graphed ``SlamPipeline`` and
    through :func:`eager_steps`, held against each other: launch and
    keyframe counts equal (no loop attempt can run in them), every pose
    within GRAPH_POSE_TOL_M.  For both: ms/frame of a timed pass (host
    clock, one synchronise at the end, after a warm-up pass that also
    captures the graphs), and over the first PROFILE_FRAMES frames under
    ``torch.profiler`` the host syncs and graph launches per frame and the
    device busy ms/frame, whose idle share is against the timed pass (the
    graphed pipeline's syncs there are the hoisted loop gate's reads after
    frame 4: its frames read nothing, as phase 8 asserts);
    capture seconds; peak MiB (allocated, capture included, and reserved).
    Then the device ms, in a graph, of a local-map build (the capture builds
    it on every mapping frame and selects it on the device)."""
    import torch
    from alego_tpu_torch import kernels
    from alego_tpu_torch.models import laser_mapping as lm
    from alego_tpu_torch.models.pipeline import SlamPipeline
    from alego_tpu_torch.utils.profiling import device_window

    n, m = pts.shape[0], PROFILE_FRAMES
    out = {}
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    pipe = SlamPipeline(cfg, device="cuda")
    pipe.run(pts, mask)                           # captures the graphs
    pipe.reset()
    torch.cuda.synchronize()
    kernels.LAUNCHES.clear()
    wall = timed_pass(pipe, pts, mask)
    launches = dict(kernels.LAUNCHES)
    est_g = torch.stack(pipe.poses)
    kf_g, attempts = int(pipe.state.mapping.graph.count), int(pipe.state.mapping.loop_attempts)
    pipe.reset()
    win = device_window(lambda: [pipe.process(pts[k], mask[k]) for k in range(m)])
    out["graphed"] = dict(
        ms_per_frame=wall / n * 1e3, launches=launches, keyframes=kf_g,
        capture_s=pipe.graphs.capture_seconds,
        captured_launches={("map" if k else "no_map"): v for k, v in pipe.graphs.launches.items()},
        peak_mib=torch.cuda.max_memory_allocated() / 2 ** 20,
        reserved_mib=torch.cuda.max_memory_reserved() / 2 ** 20)
    out["local_map_build_ms"] = _graph_ms(lambda: lm._build_local_map(pipe.state.mapping, cfg))
    del pipe
    torch.cuda.empty_cache()

    pts_d, mask_d = torch.as_tensor(pts, device="cuda"), torch.as_tensor(mask, device="cuda")
    eager_steps(cfg, pts_d, mask_d, 2)            # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.LAUNCHES.clear()
    t0 = time.time()
    st_e, est_e = eager_steps(cfg, pts_d, mask_d)
    torch.cuda.synchronize()
    wall_e = time.time() - t0
    launches_e = dict(kernels.LAUNCHES)
    kf_e = int(st_e.mapping.graph.count)
    out["eager"] = dict(ms_per_frame=wall_e / n * 1e3, launches=launches_e, keyframes=kf_e,
                        capture_s=None, peak_mib=torch.cuda.max_memory_allocated() / 2 ** 20,
                        reserved_mib=torch.cuda.max_memory_reserved() / 2 ** 20)
    win_e = device_window(lambda: eager_steps(cfg, pts_d, mask_d, m))
    for way, w in (("graphed", win), ("eager", win_e)):
        busy = w["device_busy_ms"] / m
        out[way].update(host_syncs_per_frame=w["syncs"] / m,
                        graph_launches_per_frame=w["graph_launches"] / m,
                        device_ops_per_frame=w["device_ops"] / m,
                        device_busy_ms_per_frame=busy,
                        device_idle_share=1.0 - busy / out[way]["ms_per_frame"])

    diff = (est_g - est_e).abs()
    out["max_pose_diff_m"] = float(diff[:, :3, 3].max())
    out["max_rot_diff"] = float(diff[:, :3, :3].max())
    log(f"graph_step: {json.dumps(out)}")
    assert attempts == 0, "a loop attempt ran in the main path's frames"
    assert launches == launches_e, f"launches {launches} (graphed) != {launches_e} (eager)"
    assert kf_g == kf_e, f"keyframes {kf_g} (graphed) != {kf_e} (eager)"
    assert out["max_pose_diff_m"] <= GRAPH_POSE_TOL_M, \
        f"graphed and eager poses {out['max_pose_diff_m']} m apart"
    assert win["graph_launches"] == m, f"{win['graph_launches']} graph launches in {m} frames"
    assert win["device_busy_ms"] > 0 and win_e["device_busy_ms"] > 0, "no device time traced"
    return out


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


def attempt_launches(cfg):
    """The kernel launches of one loop attempt past its gate, from the
    config: every ICP iteration and each ICP's fitness pass search once
    (the masked loop runs its whole budget), the rescue's ICP included, and
    the acceptance gate scores the identity result and the picked one."""
    rescue = min(cfg.icp_iters, cfg.loop_rescue_icp_iters) + 1 if cfg.loop_coarse_align else 0
    return {"nn1": cfg.icp_iters + 1 + rescue, "knn": 2 if cfg.loop_coarse_align else 1}


class _AttemptLog:
    """Records each loop-closure attempt of ``pipe`` (graphed on the card):
    wraps its ``_loop_attempt``.  Where the gate passes (read once more, by
    the recorder), ``loop_closure_step`` first runs eagerly on a copy of the
    mapping state (its launches taken out of the counts again, its search
    inputs kept for the kernel rows), then the pipeline's own attempt (the
    gate's read and the graph's replay; its first call also captures); each
    is timed with one synchronise before and after it, and its host reads
    are counted (``read``).  The replayed state must equal the eager one,
    leaf by leaf, bit for bit.  With ``profile``, each replayed attempt but
    the one that captures runs under ``device_window`` (syncs and graph
    launches; its seconds then include the profiler's)."""

    def __init__(self, pipe, profile=False):
        import torch
        from alego_tpu_torch import kernels
        from alego_tpu_torch.models import laser_mapping as lm, pipeline
        from alego_tpu_torch.ops import icp
        self.torch, self.kernels, self.lm, self.icp = torch, kernels, lm, icp
        self.pipeline, self.pipe, self.profile = pipeline, pipe, profile
        self.attempts, self.inputs = [], {}
        self._real = (pipe._loop_attempt, icp._nn1, lm.knn)

    def _eager(self, ms, cfg):
        """``loop_closure_step`` on a copy of ``ms``, its searches' inputs
        kept: (state, closed, fitness, seconds, launches, reads)."""
        import collections
        torch, lm, icp, kernels = self.torch, self.lm, self.icp, self.kernels
        _, real_nn1, real_knn = self._real
        first = []

        def nn1(q, qm, r, rm):
            if not first:           # the identity ICP's first search
                self.inputs["nn1"] = tuple(t.clone() for t in (q, qm, r, rm))
                first.append(True)
            return real_nn1(q, qm, r, rm)

        def knn(q, qm, r, rm, k):
            if k == 1:              # the acceptance gate (mapping runs k = 5)
                self.inputs["knn"] = tuple(t.clone() for t in (q, qm, r, rm))
            return real_knn(q, qm, r, rm, k)

        copy = self.pipeline._unflatten(ms, [t.clone() for _, t in self.pipeline._flatten(ms)])
        reads, out = [], []
        icp._nn1, lm.knn = nn1, knn
        try:
            torch.cuda.synchronize()
            t0 = time.time()
            mark = collections.Counter(kernels.LAUNCHES)
            out.extend(lm.loop_closure_step(copy, cfg,
                                            read=lambda f: reads.append(f) or bool(f)))
            torch.cuda.synchronize()
            dt = time.time() - t0
        finally:
            icp._nn1, lm.knn = real_nn1, real_knn
        launches = dict(kernels.LAUNCHES - mark)
        kernels.LAUNCHES.clear()
        kernels.LAUNCHES.update(mark)
        return tuple(out) + (dt, launches, len(reads))

    def _attempt(self):
        from alego_tpu_torch.utils.profiling import device_window
        torch, kernels, lm, pipe = self.torch, self.kernels, self.lm, self.pipe
        real = self._real[0]
        ms, cfg = pipe.state.mapping, pipe.cfg
        do, closest, latest = lm.loop_gate(ms, cfg)
        if not bool(do):
            return real()
        want, closed, fitness, eager_s, eager_launches, eager_reads = self._eager(ms, cfg)
        reads = []
        pipe._read = lambda f: reads.append(f) or bool(f)
        captured = pipe.loop_graph is None
        before = dict(kernels.LAUNCHES)
        try:
            torch.cuda.synchronize()
            t0 = time.time()
            win = None
            if self.profile and not captured:
                win = device_window(real)
            else:
                real()
            torch.cuda.synchronize()
            dt = time.time() - t0
        finally:
            del pipe._read
        g = pipe.loop_graph
        launches = {k: v - before.get(k, 0) for k, v in kernels.LAUNCHES.items()
                    if v != before.get(k, 0)}
        diff = [p for (p, a), (_, b) in zip(self.pipeline._flatten(pipe.state.mapping),
                                            self.pipeline._flatten(want))
                if not torch.equal(a, b)]
        rec = dict(frame=pipe._frame, latest=int(latest), closest=int(closest),
                   closed=bool(g.closed), fitness=float(g.fitness),
                   inlier=float(pipe.state.mapping.loop_best_inlier), launches=launches,
                   seconds=dt, capture_s=g.capture_seconds if captured else None,
                   replay_s=dt - g.capture_seconds if captured else dt, host_reads=len(reads),
                   eager_seconds=eager_s, eager_launches=eager_launches,
                   eager_host_reads=eager_reads, state_equal=not diff,
                   closed_equal=torch.equal(g.closed, closed),
                   fitness_equal=torch.equal(g.fitness, fitness))
        if win is not None:
            rec.update(syncs=win["syncs"], graph_launches=win["graph_launches"])
        elif self.profile:
            rec.update(syncs=None, graph_launches=None)
        self.attempts.append(rec)
        log(f"loop attempt: {json.dumps(rec)}")
        assert not diff, f"replayed and eager attempts differ in {diff}"
        assert rec["closed_equal"] and rec["fitness_equal"], "closed or fitness differ"

    def __enter__(self):
        self.pipe._loop_attempt = self._attempt
        return self

    def __exit__(self, *exc):
        del self.pipe._loop_attempt


def _loop_results(pipe, gt):
    """Poses, loop factors and ATEs of a finished run over the circuit."""
    import torch
    from alego_tpu_torch.utils.metrics import ate_rmse

    est = torch.stack(pipe.poses).cpu().numpy()
    ms = pipe.state.mapping
    g = ms.graph
    n = est.shape[0]
    n_loops, n_kf = int(g.loop_count), int(g.count)
    pairs = [(int(i), int(j)) for i, j in zip(g.loop_i[:n_loops].tolist(),
                                             g.loop_j[:n_loops].tolist())]
    assert np.isfinite(est).all(), "non-finite pose"
    ate = ate_rmse(est[:, :3, 3], gt[:, :3, 3], align=False)
    # corrected-keypose ATE: the solve retro-corrects keyframe poses; each
    # keyframe's ground truth is the frame of its time stamp
    kf_t = ms.kf_times[:n_kf].cpu().numpy()
    gt_idx = np.clip(np.round(kf_t / pipe.cfg.scan_period).astype(int), 0, n - 1)
    kf_ate = ate_rmse(g.poses[:n_kf, :3, 3].cpu().numpy(), gt[gt_idx, :3, 3], align=False)
    return dict(frames=n, ate_m=ate, kf_ate_m=kf_ate, keyframes=n_kf, loops=n_loops,
                loop_pairs=pairs, attempts=int(ms.loop_attempts), overflow=int(g.overflow),
                loop_overflow=int(g.loop_overflow), compactions=pipe.compactions)


def _check_loop_results(res, what):
    assert res["loops"] == len(LOOP_PAIRS) and res["loop_pairs"] == LOOP_PAIRS, \
        f"{what}: loop pairs {res['loop_pairs']} != {LOOP_PAIRS}"
    assert res["attempts"] == LOOP_ATTEMPTS, f"{what}: {res['attempts']} attempts"
    assert res["loop_overflow"] == 0 and res["overflow"] == 0, f"{what}: capacity reached"
    assert abs(res["ate_m"] - LOOP_ATE_M) <= LOOP_ATE_TOL_M and \
        abs(res["kf_ate_m"] - LOOP_KF_ATE_M) <= LOOP_ATE_TOL_M, \
        f"{what}: ATE {res['ate_m']:.5f} / {res['kf_ate_m']:.5f} m moved from " \
        f"{LOOP_ATE_M} / {LOOP_KF_ATE_M} m"


def _counted_loop_run(cfg, gt, pts, mask):
    """The whole circuit through ``SlamPipeline`` with hoisted loop closure
    as a user drives it, nothing wrapped: counted (counts set to 0 just
    before it) and timed, with one synchronise at the end (ms/frame also
    without the step graphs' and the loop graph's captures, which this run
    pays).  Its summary, checked, and its poses."""
    import torch
    from alego_tpu_torch import kernels
    from alego_tpu_torch.models.pipeline import SlamPipeline

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    pipe = SlamPipeline(cfg, device="cuda")
    kernels.LAUNCHES.clear()
    total_s = timed_pass(pipe, pts, mask)
    launches = dict(kernels.LAUNCHES)
    res = _loop_results(pipe, gt)
    est = torch.stack(pipe.poses).cpu().numpy()
    n = pts.shape[0]
    n_map = -(-n // cfg.map_frame_decimation)
    # the attempts' launches: all of the run's less the frame step's
    in_attempts = {"nn1": launches["nn1"] - 2 * max(cfg.odom_outer_iters, 1) * n,
                   "knn": launches["knn"] - 2 * cfg.map_outer_iters * n_map}
    per_attempt = attempt_launches(cfg)
    captures_s = pipe.graphs.capture_seconds + pipe.loop_graph.capture_seconds
    summary = dict(res, ms_per_frame=total_s / n * 1e3,
                   ms_per_frame_less_captures=(total_s - captures_s) / n * 1e3,
                   launches=launches, attempt_launches_total=in_attempts,
                   launches_per_attempt=per_attempt,
                   peak_mib=torch.cuda.max_memory_allocated() / 2 ** 20,
                   step_capture_s=pipe.graphs.capture_seconds,
                   loop_capture_s=pipe.loop_graph.capture_seconds,
                   loop_graph_launches=pipe.loop_graph.launches,
                   loop_graph_graph_launches=pipe.loop_graph.graph_launches)
    log(f"loop path: {json.dumps(summary)}")
    step = step_launches(cfg, n, n_map)
    assert launches["ccl"] == n, f"ccl launches {launches['ccl']} != {n}"
    assert launches["gn"] == step["gn"], f"gn launches {launches['gn']} != {step['gn']}"
    _check_loop_results(res, "loop path")
    assert in_attempts == {k: v * LOOP_ATTEMPTS for k, v in per_attempt.items()}, \
        f"attempt launches {in_attempts}, not {LOOP_ATTEMPTS} x {per_attempt}"
    return summary, est


def _attempt_pieces_ms(cfg, pipe, inputs):
    """Device ms, in a graph, of an attempt's pieces at the last attempt's
    shapes: the identity ICP and the rescue's ICP (the whole masked
    budget, on the identity ICP's inputs), the bird's-eye-view alignment
    (on the acceptance gate's source and the history cloud), and one
    pose-graph solve over the run's final graph (the attempt runs two)."""
    import torch
    from alego_tpu_torch.models import pose_graph as pg
    from alego_tpu_torch.ops.bev_align import bev_align
    from alego_tpu_torch.ops.icp import icp_point_to_point

    src_i, src_i_ok, tgt, tgt_ok = inputs["nn1"]
    src, src_ok = inputs["knn"][:2]
    centre = torch.zeros(2, device="cuda")
    g = pipe.state.mapping.graph

    def icp(iters):
        return lambda: icp_point_to_point(src_i, src_i_ok, tgt, tgt_ok, iters,
                                          cfg.icp_max_corr_dist, cfg.icp_translation_eps)

    return dict(
        icp_ms=_graph_ms(icp(cfg.icp_iters), reps=2),
        rescue_icp_ms=_graph_ms(icp(min(cfg.icp_iters, cfg.loop_rescue_icp_iters)), reps=2),
        bev_align_ms=_graph_ms(lambda: bev_align(src, src_ok, tgt, tgt_ok, centre, centre,
                                                 grid=cfg.loop_bev_grid, res=cfg.loop_bev_res,
                                                 n_yaw=cfg.loop_bev_yaws)),
        graph_solve_ms=_graph_ms(lambda: pg.optimize(g, cfg.pose_graph_chain_sigma,
                                                     iters=cfg.pose_graph_gn_iters), reps=2))


def phase_loop_path(cfg, gt, pts, mask, checkpoint):
    """The whole circuit through ``SlamPipeline`` with hoisted loop closure,
    twice.  The first run is the path as a user drives it, nothing wrapped:
    counted (counts set to 0 just before it) and timed, with one
    synchronise at the end; its attempts replay the loop graph.  The second
    records each attempt (:class:`_AttemptLog`: the replayed attempt held
    bit for bit against ``loop_closure_step`` run eagerly on a copy of the
    same state, each timed, with its launches and host reads); it must give
    the first run's loops and attempts' launches.  The second run also
    writes ``checkpoint`` after frame IN_STEP_FROM, where phase ``in_step``
    resumes."""
    from alego_tpu_torch.models.pipeline import SlamPipeline

    summary, est_first = _counted_loop_run(cfg, gt, pts, mask)
    in_attempts = summary["attempt_launches_total"]
    pipe = SlamPipeline(cfg, device="cuda")
    with _AttemptLog(pipe) as rec:
        timed_pass(pipe, pts[:IN_STEP_FROM], mask[:IN_STEP_FROM])
        pipe.save_checkpoint(checkpoint)
        timed_pass(pipe, pts[IN_STEP_FROM:], mask[IN_STEP_FROM:])
    _check_loop_results(_loop_results(pipe, gt), "recorded run")
    assert len(rec.attempts) == LOOP_ATTEMPTS, "an attempt went unrecorded"
    assert all(a["frame"] > IN_STEP_FROM for a in rec.attempts), \
        "an attempt passed its gate before the in-step phase's checkpoint"
    per_attempt = summary["launches_per_attempt"]
    for a in rec.attempts:
        assert a["launches"] == a["eager_launches"] == per_attempt, \
            f"attempt launches {a['launches']} / {a['eager_launches']} != {per_attempt}"
        assert a["host_reads"] == 1 and a["eager_host_reads"] == 1, "reads besides the gate"
    recorded = {k: sum(a["launches"][k] for a in rec.attempts) for k in per_attempt}
    assert recorded == in_attempts, f"attempt launches {recorded} != {in_attempts}"
    assert set(rec.inputs) == {"nn1", "knn"}, "an attempt ran without its searches"
    summary["attempt_pieces_ms"] = _attempt_pieces_ms(cfg, pipe, rec.inputs)
    summary.update(
        attempt_launches=[(a["launches"]["nn1"], a["launches"]["knn"]) for a in rec.attempts],
        attempt_seconds=[a["seconds"] for a in rec.attempts],
        attempt_replay_seconds=[a["replay_s"] for a in rec.attempts],
        attempt_eager_seconds=[a["eager_seconds"] for a in rec.attempts],
        attempt_capture_s=rec.attempts[0]["capture_s"],
        host_reads_per_attempt=[a["host_reads"] for a in rec.attempts],
        attempts_equal_eager=all(a["state_equal"] for a in rec.attempts))
    return summary, rec.inputs, est_first


def phase_loop_kernels(summary, inputs):
    """The two NN kernels at the loop shapes, on the last attempt's inputs;
    ``launches`` counts the kernel's launches inside the attempts of the
    loop path's counted run."""
    rows = [_nn_row("nn1_loop_icp", "nn1", "alego_tpu/ops/pallas_nn.py:108",
                    [("icp",) + inputs["nn1"]], 1),
            _nn_row("knn_loop_acceptance", "knn", "alego_tpu/ops/pallas_nn.py:227",
                    [("acceptance",) + inputs["knn"]], 1)]
    rows[0]["launches"] = summary["attempt_launches_total"]["nn1"]
    rows[1]["launches"] = summary["attempt_launches_total"]["knn"]
    return rows


def _loop_scene(cfg, device):
    """The loop-closure scene of the tests (tests/test_sharded_mapping.py):
    twelve keyframes on a 3 m ring, 10 s apart, each holding its view of two
    walls and a ground patch, the latest revisiting keyframe 0."""
    import torch
    from alego_tpu_torch.models import laser_mapping as lm, pose_graph as pg
    from alego_tpu_torch.utils import synthetic

    rng = np.random.default_rng(4)
    g = np.stack(np.meshgrid(np.linspace(-8, 8, 24), np.linspace(-8, 8, 24)), -1).reshape(-1, 2)
    ground = np.concatenate([g, np.full((len(g), 1), -1.5)], 1)
    w1 = np.stack(np.meshgrid(np.linspace(-8, 8, 24), np.linspace(-1.5, 2.5, 10)), -1).reshape(-1, 2)
    wall1 = np.stack([w1[:, 0], np.full(len(w1), 8.0), w1[:, 1]], 1)
    wall2 = np.stack([np.full(len(w1), -8.0), w1[:, 0], w1[:, 1]], 1)
    W = np.concatenate([ground, wall1, wall2]).astype(np.float32)
    W += rng.normal(0, 0.01, W.shape).astype(np.float32)
    ring = synthetic.loop_trajectory(12, radius=3.0, closed=True)
    ms = lm.init_state(cfg, device)
    graph = ms.graph
    yes = torch.ones((), dtype=torch.bool, device=device)
    for k in range(12):
        T = ring[k].astype(np.float32)
        graph = pg.add_keyframe(graph, torch.from_numpy(T).to(device), yes)
        local = (W - T[:3, 3]) @ T[:3, :3]
        m = min(len(local), cfg.kf_surf_cap)
        ms.kf_surf[k, :m] = torch.from_numpy(local[:m]).to(device)
        ms.kf_surf_valid[k, :m] = True
        ms.kf_times[k] = k * 10.0
    return ms._replace(graph=graph)


def phase_loop_cpu_agreement():
    """Tiny-config loop closure on the card against the CPU: the identity
    attempt closes, and the latest keyframe yawed by 75 degrees closes
    through the bird's-eye-view rescue."""
    import torch
    from alego_tpu_torch import tiny_config
    from alego_tpu_torch.models import laser_mapping as lm

    cfg = tiny_config(max_keyframes=64, loop_time_gap=30.0, history_search_num=3,
                      history_fitness_score=0.1, icp_iters=40)
    worst = 0.0
    for yaw_deg in (0.0, 75.0):
        out = {}
        for dev in ("cuda", "cpu"):
            ms = _loop_scene(cfg, dev)
            if yaw_deg:
                c, s_ = np.cos(np.radians(yaw_deg)), np.sin(np.radians(yaw_deg))
                Tz = torch.eye(4, device=dev)
                Tz[:2, :2] = torch.tensor([[c, -s_], [s_, c]], dtype=torch.float32)
                ms.graph.poses[11] = Tz @ ms.graph.poses[11]
            out[dev] = lm.loop_closure_step(ms, cfg)
        (m_g, c_g, f_g), (m_c, c_c, f_c) = out["cuda"], out["cpu"]
        assert bool(c_g) and bool(c_c), f"yaw {yaw_deg}: the loop did not close"
        for name in ("loop_count", "loop_i", "loop_j", "count"):
            assert torch.equal(getattr(m_g.graph, name).cpu(), getattr(m_c.graph, name)), name
        assert abs(float(f_g) - float(f_c)) <= 1e-5 * abs(float(f_c)) + 1e-9, (float(f_g), float(f_c))
        n = int(m_c.graph.count)
        P_g, P_c = m_g.graph.poses[:n].cpu(), m_c.graph.poses[:n]
        dt = float((P_g[:, :3, 3] - P_c[:, :3, 3]).abs().max())
        dr = float((P_g[:, :3, :3] - P_c[:, :3, :3]).abs().max())
        log(f"tiny loop closure, yaw {yaw_deg}: card vs CPU fitness {float(f_g):.6g} / "
            f"{float(f_c):.6g}, max |dt| {dt:.3e} m, max |dR| {dr:.3e}")
        assert dt < 1e-4 and dr < 1e-5, "card and CPU loop closures disagree"
        worst = max(worst, dt)
    return worst


def phase_in_step(cfg, gt, pts, mask, checkpoint):
    """``loop_in_step=True``: the attempt runs after the frame's graph
    replay on its cadence.  Over the first N_IN_STEP frames no candidate
    passes the age gate, so the attempts launch nothing and the poses are
    the hoisted run's.  Then the recorded loop run's checkpoint (after frame
    IN_STEP_FROM) resumed in the in-step mode to the circuit's end: each
    attempt that passes its gate replays the loop graph (captured at the
    first), held bit for bit against the eager attempt on a copy of its
    state (:class:`_AttemptLog`; each attempt after the capturing one under
    ``device_window``: one host sync, the gate's, and the loop graph's
    graph launches)."""
    import torch
    from alego_tpu_torch import kernels
    from alego_tpu_torch.models.pipeline import SlamPipeline
    from alego_tpu_torch.utils.metrics import ate_rmse

    cfg_in = cfg.replace(loop_in_step=True)
    pipe = SlamPipeline(cfg_in, device="cuda")
    calls = []
    pipe._loop_attempt = lambda real=pipe._loop_attempt: calls.append(len(pipe.poses)) or real()
    kernels.LAUNCHES.clear()
    est = pipe.run(pts[:N_IN_STEP], mask[:N_IN_STEP])
    launches = dict(kernels.LAUNCHES)
    ref = SlamPipeline(cfg, device="cuda").run(pts[:N_IN_STEP], mask[:N_IN_STEP])
    dt = float(np.abs(est[:, :3, 3] - ref[:, :3, 3]).max())
    expected = step_launches(cfg, N_IN_STEP, -(-N_IN_STEP // cfg.map_frame_decimation))
    log(f"loop_in_step=True, {N_IN_STEP} frames: attempts at frames {calls}, launches "
        f"{launches}, max |dt| against the hoisted run {dt:.3e} m")
    assert calls == list(range(0, N_IN_STEP, cfg.loop_every_n_frames)), calls
    assert launches == expected, f"launch counts {launches} != {expected}"
    assert dt < 1e-4, "in-step and hoisted runs disagree"
    assert pipe.loop_graph is None, "a gated-off attempt captured the loop graph"

    pipe = SlamPipeline(cfg_in, device="cuda")
    pipe.load_checkpoint(checkpoint)
    n = pts.shape[0] - IN_STEP_FROM
    with _AttemptLog(pipe, profile=True) as rec:
        kernels.LAUNCHES.clear()
        wall = timed_pass(pipe, pts[IN_STEP_FROM:], mask[IN_STEP_FROM:])
        launches = dict(kernels.LAUNCHES)
    est = torch.stack(pipe.poses).cpu().numpy()
    g = pipe.state.mapping.graph
    n_loops = int(g.loop_count)
    per_attempt = attempt_launches(cfg)
    n_map = len(range(IN_STEP_FROM, pts.shape[0], cfg.map_frame_decimation))
    k = len(rec.attempts)
    expected = step_launches(cfg, n, n_map)
    for name, v in per_attempt.items():
        expected[name] += k * v
    res = dict(frames=n, from_frame=IN_STEP_FROM, attempts=k,
               attempt_frames=[a["frame"] for a in rec.attempts],
               loops=n_loops, loop_pairs=[(int(i), int(j)) for i, j in zip(
                   g.loop_i[:n_loops].tolist(), g.loop_j[:n_loops].tolist())],
               launches=launches, recorded_ms_per_frame=wall / n * 1e3,
               attempt_seconds=[a["seconds"] for a in rec.attempts],
               attempt_eager_seconds=[a["eager_seconds"] for a in rec.attempts],
               capture_s=pipe.loop_graph.capture_seconds if pipe.loop_graph else None,
               syncs_per_attempt=[a["syncs"] for a in rec.attempts],
               graph_launches_per_attempt=[a["graph_launches"] for a in rec.attempts],
               ate_m=ate_rmse(est[:, :3, 3], gt[IN_STEP_FROM:, :3, 3], align=False))
    log(f"in-step attempts from frame {IN_STEP_FROM}: {json.dumps(res)}")
    # the first attempt captures (outside the profiler); the others replay
    assert k >= 2, f"{k} in-step attempts passed their gates"
    assert launches == expected, f"launch counts {launches} != {expected}"
    assert np.isfinite(est).all(), "non-finite pose"
    for a in rec.attempts:
        assert a["launches"] == per_attempt and a["host_reads"] == 1, a
    for a in rec.attempts[1:]:
        assert a["syncs"] == 1 and a["graph_launches"] == pipe.loop_graph.graph_launches, \
            f"an in-step attempt synchronised {a['syncs']} times in {a['graph_launches']} replays"
    return res


def render_skewed(cfg, n_frames):
    """The bench circuit of :func:`render` rendered with each sweep's motion
    (frame k sweeps from pose k to pose k + 1), and its IMU stream."""
    from alego_tpu_torch.utils import synthetic
    poses = synthetic.loop_trajectory(N_CIRCUIT, radius=30.0, speed=1.6, closed=True)
    world = synthetic.make_world(seed=100, clear_path=poses[:, :2, 3])
    t0 = time.time()
    pts, mask = synthetic.render_sequence_skewed(world, poses[:n_frames], cfg,
                                                 noise=0.01, seed=0)
    imu = synthetic.imu_stream(poses[:n_frames], cfg.scan_period, hz=IMU_HZ,
                               rpy_noise=IMU_RPY_SIGMA, acc_noise=IMU_ACC_SIGMA,
                               seed=IMU_SEED)
    log(f"rendered {n_frames} skewed frames and {len(imu)} IMU samples in "
        f"{time.time() - t0:.1f} s")
    return poses[:n_frames], pts, mask, imu


def _frame_syncs(cfg, pts, mask):
    """``device_window`` of ``process`` over the frames, from a pipeline
    that captured its graphs in a pass over the same frames and was reset:
    no hoisted loop gate, compaction or overflow check falls in the window,
    so what it counts is the frames' own."""
    from alego_tpu_torch.models.pipeline import SlamPipeline
    from alego_tpu_torch.utils.profiling import device_window

    pipe = SlamPipeline(cfg, device="cuda")
    pipe.run(pts, mask)
    pipe.reset()
    return device_window(lambda: [pipe.process(pts[k], mask[k]) for k in range(len(pts))])


def phase_radius_path(cfg, gt, pts, mask):
    """``loop_closure_enabled=False``: the local map is the K nearest
    keyframes within the search radius, rebuilt on every mapping frame.
    Two chunks of 16 through ``run_scanned``, counted (counts set to 0 just
    before) and timed; then the host synchronisations and graph launches of
    the radius and the main-path config over the first 2 frames (one
    mapping frame)."""
    import torch
    from alego_tpu_torch import kernels
    from alego_tpu_torch.models.pipeline import SlamPipeline
    from alego_tpu_torch.utils.metrics import ate_rmse

    cfg_r = cfg.replace(loop_closure_enabled=False)
    n = pts.shape[0]
    pipe = SlamPipeline(cfg_r, device="cuda")
    kernels.LAUNCHES.clear()
    t0 = time.time()
    est = np.concatenate([pipe.run_scanned(pts[i:i + 16], mask[i:i + 16])
                          for i in range(0, n, 16)])
    total_s = time.time() - t0
    launches = dict(kernels.LAUNCHES)
    expected = step_launches(cfg, n, -(-n // cfg.map_frame_decimation))
    assert np.isfinite(est).all(), "non-finite pose"
    ate = ate_rmse(est[:, :3, 3], gt[:, :3, 3], align=False)
    m = 2
    wins = {"radius": _frame_syncs(cfg_r, pts[:m], mask[:m]),
            "main_path": _frame_syncs(cfg, pts[:m], mask[:m])}
    res = dict(frames=n, ms_per_frame=total_s / n * 1e3, ate_m=ate,
               keyframes=int(pipe.state.mapping.graph.count), launches=launches,
               host_syncs_per_frame={k: w["syncs"] / m for k, w in wins.items()},
               graph_launches_per_frame={k: w["graph_launches"] / m for k, w in wins.items()})
    log(f"radius path: {json.dumps(res)}")
    assert launches == expected, f"launch counts {launches} != {expected}"
    # a captured frame reads nothing on the host, in either mode: each frame
    # is one graph launch and no synchronisation
    for k, w in wins.items():
        assert w["syncs"] == 0 and w["graph_launches"] == m, (k, w["syncs"], w["graph_launches"])
    assert abs(ate - RADIUS_ATE_M) <= ATE_TOL_M, f"ATE {ate:.6f} m moved from {RADIUS_ATE_M} m"
    return res


def _odom_feed(poses, imu, scan_period):
    """The odometry samples of the tiny de-skew runs: at the IMU's stamps,
    the IMU's orientation with the interpolated ground-truth position and
    the frame's velocity."""
    out = []
    for t, rpy, _ in imu:
        k = min(int(t / scan_period + 1e-9), len(poses) - 1)
        k1 = min(k + 1, len(poses) - 1)
        a = min(t / scan_period - k, 1.0)
        pos = (1 - a) * poses[k][:3, 3] + a * poses[k1][:3, 3]
        out.append((t, rpy, pos, (poses[k1][:3, 3] - poses[k][:3, 3]) / scan_period))
    return out


def phase_deskew_cpu_agreement():
    """Tiny config, 6 skewed frames: de-skew on the card against the CPU
    with an IMU stream, then with odometry through ``add_odom``; then a
    checkpoint on the card, saved after 3 frames, loaded into a fresh
    pipeline and continued, against the uninterrupted run."""
    import torch
    from alego_tpu_torch import tiny_config
    from alego_tpu_torch.models.pipeline import SlamPipeline
    from alego_tpu_torch.utils import synthetic

    cfg = tiny_config().replace(use_imu=True, loop_closure_enabled=False)
    world = synthetic.make_world(seed=3)
    poses = synthetic.loop_trajectory(6, radius=20.0, speed=1.0, closed=False)
    pts, mask = synthetic.render_sequence_skewed(world, poses, cfg, noise=0.01)
    imu = synthetic.imu_stream(poses, cfg.scan_period, hz=IMU_HZ, rpy_noise=IMU_RPY_SIGMA,
                               acc_noise=IMU_ACC_SIGMA, seed=IMU_SEED)
    odom = _odom_feed(poses, imu, cfg.scan_period)

    def imu_pipe(dev, c=cfg):
        pipe = SlamPipeline(c, device=dev)
        for t, rpy, acc in imu:
            pipe.add_imu(t, rpy, acc)
        return pipe

    def odom_pipe(dev):
        pipe = SlamPipeline(cfg.replace(use_imu=False, use_odom=True), device=dev)
        for t, rpy, pos, velo in odom:
            pipe.add_odom(t, rpy, pos, velo)
        return pipe

    worst = {}
    for what, make in (("imu", imu_pipe), ("odom", odom_pipe)):
        gpu, cpu = make("cuda"), make("cpu")
        est_g, est_c = gpu.run(pts, mask), cpu.run(pts, mask)
        dt = float(np.abs(est_g[:, :3, 3] - est_c[:, :3, 3]).max())
        dr = float(np.abs(est_g[:, :3, :3] - est_c[:, :3, :3]).max())
        n_buf = int(gpu.state.imu.count)
        log(f"tiny de-skew ({what}), 6 frames, card vs CPU: max |dt| {dt:.3e} m, "
            f"max |dR| {dr:.3e}, buffer count {n_buf}")
        assert n_buf == int(cpu.state.imu.count) == len(imu), "samples lost"
        assert dt < 1e-4 and dr < 1e-5, f"card and CPU disagree ({what})"
        worst[what] = dt

    with tempfile.TemporaryDirectory() as tmp:
        ck = os.path.join(tmp, "state.npz")
        full = imu_pipe("cuda")
        for k in range(6):
            if k == 3:
                full.save_checkpoint(ck)
            full.process(pts[k], mask[k])
        est_full = torch.stack(full.poses).cpu().numpy()
        resumed = SlamPipeline(cfg, device="cuda")
        resumed.load_checkpoint(ck)
        est_res = resumed.run(pts[3:], mask[3:])
    d_ck = float(np.abs(est_res[:, :3, 3] - est_full[3:, :3, 3]).max())
    kf = (int(resumed.state.mapping.graph.count), int(full.state.mapping.graph.count))
    log(f"checkpoint after 3 frames, resumed on the card: max |dt| {d_ck:.3e} m "
        f"against the uninterrupted run, keyframes {kf}")
    assert d_ck <= 1e-6 and kf[0] == kf[1], "the resumed run differs"
    worst["checkpoint"] = d_ck
    return worst


def phase_deskew_path(cfg, gt, pts, mask, imu):
    """The bag replay as a user runs it, then the same frames without
    de-skew through ``run_scanned`` (chunks of 16, the scans' stamps)."""
    import tempfile
    import torch
    from alego_tpu_torch import cli, kernels, PipelineConfig
    from alego_tpu_torch.models.image_projection import image_projection
    from alego_tpu_torch.models.pipeline import SlamPipeline
    from alego_tpu_torch.ops import deskew
    from alego_tpu_torch.utils import profiling, rosbag
    from alego_tpu_torch.utils.metrics import ate_rmse

    n = pts.shape[0]
    with tempfile.TemporaryDirectory() as tmp:
        bag, out = os.path.join(tmp, "circuit.bag"), os.path.join(tmp, "out")
        t0 = time.time()
        rosbag.write_bag_pointclouds(
            bag, [(k * cfg.scan_period, pts[k][mask[k]]) for k in range(n)], imu=imu)
        log(f"bag of {n} clouds and {len(imu)} IMU messages, "
            f"{os.path.getsize(bag) / 2 ** 20:.1f} MiB, written in {time.time() - t0:.1f} s")
        # the CLI's own stage timer, kept to read its slam_chunk time
        timers, real_timer = [], profiling.StageTimer

        class Recording(real_timer):
            def __init__(self):
                super().__init__()
                timers.append(self)

        profiling.StageTimer = Recording
        try:
            torch.cuda.synchronize()
            kernels.LAUNCHES.clear()
            t0 = time.time()
            rc = cli.main(["--bag", bag, "--use-imu", "--save-map", "--output", out])
            torch.cuda.synchronize()
            total_s = time.time() - t0
            launches = dict(kernels.LAUNCHES)
        finally:
            profiling.StageTimer = real_timer
        assert rc == 0, f"the replay returned {rc}"
        timer = timers[-1]
        tum = np.loadtxt(os.path.join(out, "trajectory_tum.txt"))
        cfg_imu = PipelineConfig().replace(use_imu=True, loop_in_step=False)
        pipe = SlamPipeline(cfg_imu, device="cuda")
        pipe.load_checkpoint(os.path.join(out, "state.npz"))
        assert os.path.exists(os.path.join(out, "map", "surf.pcd")), "no map written"

    g = pipe.state.mapping.graph
    n_loops = int(g.loop_count)
    pairs = [(int(i), int(j)) for i, j in zip(g.loop_i[:n_loops].tolist(),
                                             g.loop_j[:n_loops].tolist())]
    gt_rel = np.einsum("ij,njk->nik", np.linalg.inv(gt[0]), gt)
    ate = ate_rmse(tum[:, 1:4], gt_rel[:len(tum), :3, 3], align=False)

    # de-skew moved the points: a late frame (its IMU still in the ring)
    # through the frame's projection and the replay's final buffer
    k = n - 8
    seg = image_projection(torch.as_tensor(pts[k], device="cuda"),
                           torch.as_tensor(mask[k], device="cuda"), cfg_imu)
    moved = deskew.deskew(seg.points, seg.cols, seg.valid,
                          torch.full((), k * cfg.scan_period, device="cuda"), pipe.state.imu,
                          cfg_imu, orient_start=seg.orient_start, orient_diff=seg.orient_diff)
    shift = float((moved - seg.points).abs().max())
    # what de-skew adds to a frame, on the card (CUDA events, as the kernel
    # rows): the two de-skew calls, and the integration of one frame's IMU
    # samples (scan_period * IMU_HZ of them)
    t_k = torch.full((), k * cfg.scan_period, device="cuda")
    deskew_ms = _median_ms(lambda: (
        deskew.deskew(seg.points, seg.cols, seg.valid, t_k, pipe.state.imu, cfg_imu,
                      orient_start=seg.orient_start, orient_diff=seg.orient_diff),
        deskew.deskew(seg.outlier_points, seg.outlier_cols, seg.outlier_valid, t_k,
                      pipe.state.imu, cfg_imu, orient_start=seg.orient_start,
                      orient_diff=seg.orient_diff)))
    per_frame = int(round(cfg.scan_period * IMU_HZ))
    rows = torch.as_tensor(np.array([[t, *r, *a] for t, r, a in imu[:per_frame]],
                                    np.float32), device="cuda")
    imu_ms = _median_ms(lambda: deskew.integrate_imu_chunk(
        pipe.state.imu, rows[:, 0], rows[:, 1:4], rows[:, 4:7], per_frame))

    plain = SlamPipeline(cfg, device="cuda")
    times = np.arange(n, dtype=np.float32) * np.float32(cfg.scan_period)
    t0 = time.time()
    est = np.concatenate([plain.run_scanned(pts[i:i + 16], mask[i:i + 16], times=times[i:i + 16])
                          for i in range(0, n, 16)])
    plain_s = time.time() - t0
    ate_plain = ate_rmse(est[:, :3, 3], gt_rel[:, :3, 3], align=False)

    n_map = -(-n // cfg.map_frame_decimation)
    chunk_ms = timer.totals["slam_chunk"]
    res = dict(frames=n, imu_messages=len(imu), tum_rows=int(len(tum)), seconds=total_s,
               slam_chunk_ms=chunk_ms, slam_chunks=timer.counts["slam_chunk"],
               ms_per_frame=chunk_ms / n, launches=launches,
               keyframes=int(g.count), loops=n_loops, loop_pairs=pairs,
               attempts=int(pipe.state.mapping.loop_attempts), overflow=int(g.overflow),
               loop_overflow=int(g.loop_overflow), imu_count=int(pipe.state.imu.count),
               ate_m=ate, no_deskew_ate_m=ate_plain, no_deskew_ms_per_frame=plain_s / n * 1e3,
               no_deskew_loops=int(plain.state.mapping.graph.loop_count),
               deskew_max_shift_m=shift, deskew_calls_ms_per_frame=deskew_ms,
               imu_integration_ms_per_frame=imu_ms)
    log(f"deskew path: {json.dumps(res)}")
    assert launches["ccl"] == n, f"ccl launches {launches['ccl']} != {n}"
    assert launches["nn1"] >= 2 * max(cfg.odom_outer_iters, 1) * n, launches
    assert launches["knn"] >= 2 * n_map, launches
    assert launches["gn"] == step_launches(cfg, n, n_map)["gn"], launches
    assert res["imu_count"] == len(imu), "IMU samples lost"
    assert shift > 1e-3, "de-skew moved no point"
    assert res["overflow"] == 0 and res["loop_overflow"] == 0, "capacity reached"
    assert res["tum_rows"] == n, "TUM rows != frames"
    assert np.isfinite(tum).all() and np.isfinite(est).all(), "non-finite pose"
    assert pairs == DESKEW_PAIRS, f"loop pairs {pairs} != {DESKEW_PAIRS}"
    assert abs(ate - DESKEW_ATE_M) <= DESKEW_ATE_TOL_M and \
        abs(ate_plain - NO_DESKEW_ATE_M) <= DESKEW_ATE_TOL_M, \
        f"ATE {ate:.5f} / {ate_plain:.5f} m moved from {DESKEW_ATE_M} / {NO_DESKEW_ATE_M} m"
    return res


def phase_mesh_nccl1(cfg, gt, pts, mask, tmp):
    """``DistributedSlamPipeline`` in a one-rank NCCL group over the main
    path's frames (the only NCCL group one card allows): the rank's counts
    are set to 0 just before its run, and must be the main path's, as must
    the ATE."""
    from alego_tpu_torch.parallel import launch, ranks
    from alego_tpu_torch.utils.metrics import ate_rmse

    frames = ranks.save_frames(os.path.join(tmp, "main_path"), pts, mask)
    res = launch.launch(ranks.distributed_run, 1, cfg, frames, 2, device="cuda",
                        backend="nccl", timeout=600)
    n = pts.shape[0]
    r0 = res["ranks"][0]
    launches = {k: int(r0[k]) for k in ("ccl", "nn1", "knn", "gn")}
    expected = step_launches(cfg, n, -(-n // cfg.map_frame_decimation))
    est = res["poses"]
    assert np.isfinite(est).all(), "non-finite pose"
    ate = ate_rmse(est[:, :3, 3], gt[:, :3, 3], align=False)
    out = dict(frames=n, backend=res["backend"], ms_per_frame=res["seconds"] / n * 1e3,
               ate_m=ate, launches=launches, collective_calls=int(r0["collective_calls"]),
               peak_mib=r0["peak_mib"])
    log(f"mesh_nccl1: {json.dumps(out)}")
    assert res["backend"] == "nccl", res["backend"]
    assert launches == expected, f"launch counts {launches} != {expected}"
    assert abs(ate - ATE_M) <= ATE_TOL_M, f"ATE {ate:.5f} m moved from {ATE_M} m"
    return out


def _schur_case():
    """tests/test_schur.py's ``test_distributed_fixed_point_at_2048`` graph
    at the production loop capacity: N = 2048, 2000 poses with 1 mm chain
    noise, 12 loops, 32 loop slots."""
    from alego_tpu_torch.utils import synthetic
    return synthetic.circuit_graph(2048, 2000, 12, loop_cap=32, seed=2, noise=0.001,
                                   loop_stride=167)


SCHUR_SIGMA, SCHUR_ITERS, SCHUR_MAX_STEP = (1e-4,) * 6, 8, 5.0


def _chain_case():
    """A 60-pose chain in 64 slots whose estimates were pushed off its
    measurements, for the multichip step's solve."""
    import torch
    from alego_tpu_torch.ops import se3
    from alego_tpu_torch.utils import synthetic
    g = synthetic.circuit_graph(64, 60, 0, loop_cap=8, seed=3)[0]
    kick = np.random.default_rng(5).uniform(-0.05, 0.05, (59, 6)).astype(np.float32)
    g.poses[1:60] = g.poses[1:60] @ se3.se3_exp(torch.from_numpy(kick))
    return g.poses.numpy(), g.chain_rel.numpy(), np.arange(64) < 60


def phase_mesh_ranks(cfg, pts, mask, tmp, backend="gloo", cards=1):
    """One group of MESH_RANKS ranks: sharing card 0 over gloo with the
    collectives staged through host memory (``cards=1``), or over NCCL with
    a card per rank.  The single-map run over the circuit (a 2-frame
    warm-up, then counted and timed), the frame-parallel front end on the
    first 4 frames, and the Schur solve of :func:`_schur_case`."""
    import torch
    from alego_tpu_torch.parallel import launch, ranks

    frames = ranks.save_frames(os.path.join(tmp, "circuit"), pts, mask)
    g, _ = _schur_case()
    graph = type(g)(*(x.numpy() for x in g))
    torch.cuda.empty_cache()
    return launch.launch(ranks.run_jobs, MESH_RANKS, [
        (ranks.distributed_run, (cfg, frames, 2)),
        (ranks.multichip_step, (cfg, pts[:4], mask[:4], *_chain_case())),
        (ranks.schur_solve, (graph, SCHUR_SIGMA, SCHUR_ITERS, SCHUR_MAX_STEP))],
        backend=backend, device="cuda", cards=cards, timeout=900)


def phase_mesh_single_map(cfg, gt, res, loop_summary, loop_est, backend="gloo"):
    """The single map on the ranks against the loop path of this call (its
    loop pairs; trajectory and ATE within the reference's 5e-2 m), then at
    its own answer; every rank must end with rank 0's graph and poses."""
    from alego_tpu_torch.parallel import ranks
    from alego_tpu_torch.utils.metrics import ate_rmse

    est = res["poses"]
    n = est.shape[0]
    assert np.isfinite(est).all(), "non-finite pose"
    ate = ate_rmse(est[:, :3, 3], gt[:, :3, 3], align=False)
    gt_idx = np.clip(np.round(res["kf_times"] / cfg.scan_period).astype(int), 0, n - 1)
    kf_ate = ate_rmse(res["kf_poses"][:, :3, 3], gt[gt_idx, :3, 3], align=False)
    traj = float(np.linalg.norm(est[:, :3, 3] - loop_est[:, :3, 3], axis=1).max())
    per_rank = [dict(knn=int(r["knn"]), nn1=int(r["nn1"]), ccl=int(r["ccl"]), gn=int(r["gn"]),
                     collective_s_per_frame=r["collective_seconds"] / n,
                     collective_calls=int(r["collective_calls"]),
                     max_gather_bytes=int(r["max_gather_bytes"]), peak_mib=r["peak_mib"],
                     poses_checksum=r["poses_checksum"],
                     kf_poses_checksum=r["kf_poses_checksum"])
                for r in res["ranks"]]
    agree = ranks.ranks_agree(res["ranks"])
    out = dict(ranks=MESH_RANKS, frames=n, staged=res["staged"], backend=res["backend"],
               ms_per_frame=res["seconds"] / n * 1e3,
               single_ms_per_frame=loop_summary["ms_per_frame"], ate_m=ate, kf_ate_m=kf_ate,
               single_ate_m=loop_summary["ate_m"], max_traj_diff_m=traj,
               keyframes=res["keyframes"], loops=res["loops"], loop_pairs=res["loop_pairs"],
               attempts=res["attempts"], compactions=res["compactions"], ranks_agree=agree,
               per_rank=per_rank)
    log(f"mesh_single_map: {json.dumps(out)}")
    assert res["backend"] == backend and res["staged"] == (backend == "gloo"), \
        f"transport {res['backend']} (staged {res['staged']}), not {backend}"
    assert agree, "the ranks' replicated graphs or poses differ"
    assert res["overflow"] == 0 and res["loop_overflow"] == 0, "capacity reached"
    assert [tuple(p) for p in res["loop_pairs"]] == LOOP_PAIRS, \
        f"loop pairs {res['loop_pairs']} != the single path's {LOOP_PAIRS}"
    assert traj <= MESH_TRAJ_TOL_M, f"trajectory {traj:.4f} m from the single path's"
    assert abs(ate - loop_summary["ate_m"]) <= MESH_ATE_TOL_M, \
        f"ATE {ate:.5f} m against the single path's {loop_summary['ate_m']:.5f} m"
    n_map = -(-n // cfg.map_frame_decimation)
    for r in per_rank:   # every rank ran its shard of every mapping search
        assert r["ccl"] == n and r["knn"] >= 2 * cfg.map_outer_iters * n_map, r
        assert r["gn"] == step_launches(cfg, n, n_map)["gn"], r
    assert [tuple(p) for p in res["loop_pairs"]] == MESH_LOOP_PAIRS
    assert res["attempts"] == LOOP_ATTEMPTS, f"{res['attempts']} attempts"
    assert abs(ate - MESH_ATE_M) <= LOOP_ATE_TOL_M and \
        abs(kf_ate - MESH_KF_ATE_M) <= LOOP_ATE_TOL_M, \
        f"ATE {ate:.5f} / {kf_ate:.5f} m moved from {MESH_ATE_M} / {MESH_KF_ATE_M} m"
    return out


def phase_mesh_lanes(tmp):
    """``ShardedSlamPipeline``: 2 lanes sharing the card over gloo, each a
    N_LANE-frame sequence rendered as ``cli --mesh`` renders it, against a
    single ``SlamPipeline`` run of the same sequence in this process."""
    from alego_tpu_torch import PipelineConfig
    from alego_tpu_torch.models.pipeline import SlamPipeline
    from alego_tpu_torch.parallel import launch, ranks
    from alego_tpu_torch.utils import synthetic

    cfg = PipelineConfig()
    radius = max(4.0, N_LANE * 0.25 / (2 * 3.14159))
    gt = synthetic.loop_trajectory(N_LANE, radius=radius, closed=True)
    seqs = [synthetic.render_sequence(synthetic.make_world(seed=7 + b, clear_path=gt[:, :2, 3]),
                                      gt, cfg, noise=0.01, seed=b) for b in range(2)]
    frames = ranks.save_frames(os.path.join(tmp, "lanes"), np.stack([p for p, _ in seqs], 1),
                               np.stack([m for _, m in seqs], 1))
    res = launch.launch(ranks.lanes_run, 2, cfg, frames, backend="gloo", device="cuda",
                        timeout=600)
    traj = res["trajectories"]
    diffs = []
    for b, (p, m) in enumerate(seqs):
        single = SlamPipeline(cfg, device="cuda").run(p, m)
        diffs.append(float(np.abs(traj[:, b, :3, 3] - single[:, :3, 3]).max()))
    out = dict(lanes=2, frames=N_LANE, seconds=res["seconds"],
               keyframes=[int(k) for k in res["keyframes"]], max_diff_m=diffs)
    log(f"mesh_lanes: {json.dumps(out)}")
    assert np.isfinite(traj).all(), "non-finite pose"
    assert max(diffs) <= 1e-6, f"a lane differs from its single run by {max(diffs)} m"
    return out


def phase_mesh_kernels_and_solver(cfg, pts, mask, state, res_ranks):
    """The k-NN at the shard shapes of the 32-frame run's local map (the
    last frame's scan against each rank's quarter), timed and held bit for
    bit against its plain version; then :func:`_check_mesh_front_and_solver`."""
    import torch
    from alego_tpu_torch.models import laser_mapping as lm
    from alego_tpu_torch.ops import se3

    dev = torch.device("cuda")
    _, seg, fc = _frame_features(cfg, pts[-1], mask[-1], dev)
    map_c, map_c_ok, map_s, map_s_ok = lm._build_local_map(state.mapping, cfg)
    c_ds, c_ok, _, _, _, _, st_ds, st_ok = lm._downsample_scan(
        fc.less_sharp_pts, fc.less_sharp_valid, fc.less_flat_pts,
        fc.less_flat_valid, seg.outlier_points, seg.outlier_valid, cfg)
    p = se3.mat_to_params(state.mapping.T_map2laser)
    q_c, q_s = se3.transform_points(p, c_ds), se3.transform_points(p, st_ds)
    cases = []
    for r in range(MESH_RANKS):
        nc, ns = map_c.shape[0] // MESH_RANKS, map_s.shape[0] // MESH_RANKS
        cases += [(f"corner rank {r}", q_c, c_ok, map_c[r * nc:(r + 1) * nc],
                   map_c_ok[r * nc:(r + 1) * nc]),
                  (f"surf rank {r}", q_s, st_ok, map_s[r * ns:(r + 1) * ns],
                   map_s_ok[r * ns:(r + 1) * ns])]
    row = _nn_row("knn_map_shard_d4", "knn", "alego_tpu/ops/pallas_nn.py:227", cases,
                  cfg.map_knn)
    # the k-NN launches of the MESH_RANKS ranks on the single-map path
    row["launches"] = sum(int(r["knn"]) for r in res_ranks[0]["ranks"])
    out = _check_mesh_front_and_solver(cfg, pts, mask, res_ranks)
    out.update(knn_shard_ms=row["ms"], knn_shard_kernel_only_ms=row["kernel_only_ms"])
    log(f"mesh_kernels_and_solver: {json.dumps(out)}")
    return [row], out


def _check_mesh_front_and_solver(cfg, pts, mask, res_ranks):
    """The ranks' front end against the single front end, bit for bit; the
    ranks' Schur solve against ``optimize`` on the card at the reference
    test's bar."""
    import torch
    from alego_tpu_torch.device import vector
    from alego_tpu_torch.models import pose_graph as pg
    from alego_tpu_torch.models.image_projection import image_projection
    from alego_tpu_torch.ops.features import extract_features

    dev = torch.device("cuda")
    _, (fc_ranks, _), schur = res_ranks
    for b in range(4):
        one = extract_features(image_projection(torch.as_tensor(pts[b], device=dev),
                                                torch.as_tensor(mask[b], device=dev), cfg), cfg)
        for name, got, want in zip(one._fields, fc_ranks, one):
            assert np.array_equal(got[b], want.cpu().numpy()), \
                f"frame {b}: the ranks' front end differs in {name}"

    g, truth = _schur_case()
    count = truth.shape[0]
    gc = type(g)(*(x.to(dev) for x in g))
    torch.cuda.synchronize()
    t0 = time.time()
    gg = pg.optimize(gc, SCHUR_SIGMA, SCHUR_ITERS, max_step=SCHUR_MAX_STEP)
    torch.cuda.synchronize()
    single_s = time.time() - t0
    pd, pgl = schur["poses"][:count], gg.poses[:count].cpu().numpy()
    drift = float(np.abs(g.poses[:count, :3, 3].numpy() - truth[:, :3, 3]).max())
    gap = float(np.abs(pd[:, :3, 3] - pgl[:, :3, 3]).max())
    err = float(np.abs(pd[:, :3, 3] - truth[:, :3, 3]).max())
    sigma = vector(SCHUR_SIGMA, torch.float32, dev)
    grad0 = float(pg._gn_parts(gc, sigma)[3].abs().max())
    gd = gc._replace(poses=torch.as_tensor(schur["poses"], device=dev))
    grad = float(pg._gn_parts(gd, sigma)[3].abs().max())
    out = dict(frontend_frames=4, schur_s_per_iter=schur["seconds"] / SCHUR_ITERS,
               schur_collective_s=schur["collective_seconds"],
               optimize_s_per_iter=single_s / SCHUR_ITERS, schur_vs_optimize_m=gap,
               drift_m=drift, schur_err_m=err, gradient=(grad0, grad))
    assert np.isfinite(pd).all(), "non-finite Schur poses"
    assert gap < 2e-3, f"Schur solve {gap} m from optimize"
    assert drift > 1.0 and err < 0.2 * drift, (err, drift)
    assert grad < 0.01 * grad0, (grad0, grad)
    return out


def nccl_mesh():
    """``--nccl-mesh``, on a machine with MESH_RANKS cards or more: the
    single map over NCCL with a card per rank, then the same ranks sharing
    card 0 over host-staged gloo, each held like ``mesh_single_map`` against
    the single loop path of the same call, with the ranks' front end and
    Schur solve checked as in ``mesh_kernels_and_solver``."""
    import torch
    from alego_tpu_torch import PipelineConfig

    if torch.cuda.device_count() < MESH_RANKS:
        print(f"chip_smoke --nccl-mesh: needs {MESH_RANKS} cards", file=sys.stderr)
        return 2
    smi = phase_environment()
    phase_build()
    cfg = PipelineConfig().replace(loop_in_step=False)
    gt, pts, mask = render(cfg, N_CIRCUIT)
    phase_main_path(cfg, gt[:N_FRAMES], pts[:N_FRAMES], mask[:N_FRAMES])   # the warm-up
    loop_summary, loop_est = _counted_loop_run(cfg, gt, pts, mask)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        for backend, cards in (("nccl", MESH_RANKS), ("gloo", 1)):
            t0 = time.time()
            res = phase_mesh_ranks(cfg, pts, mask, tmp, backend, cards)
            log(f"{backend} on {cards} card(s): launch and run {time.time() - t0:.1f} s")
            phase_mesh_single_map(cfg, gt, res[0], loop_summary, loop_est, backend)
            log(f"mesh front end and solver ({backend}): "
                f"{json.dumps(_check_mesh_front_and_solver(cfg, pts, mask, res))}")
    print(_run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"]))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--nccl-mesh", action="store_true",
                    help=f"only the single map over NCCL, one card per rank "
                         f"({MESH_RANKS} cards), beside the single loop path and the ranks "
                         "on card 0 over host-staged gloo")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    if args.nccl_mesh:
        return nccl_mesh()
    from alego_tpu_torch import PipelineConfig

    t_start = time.time()
    seconds = {}

    def phase(name, fn, *args):
        t0 = time.time()
        out = fn(*args)
        seconds[name] = time.time() - t0
        log(f"phase {name}: {seconds[name]:.1f} s")
        return out

    smi = phase("environment", phase_environment)
    gn_log = phase("build", phase_build)
    cfg = PipelineConfig().replace(loop_in_step=False)
    gt, pts, mask = phase("render", render, cfg, N_CIRCUIT)

    state, launches, summary = phase("main_path", phase_main_path, cfg, gt[:N_FRAMES],
                                     pts[:N_FRAMES], mask[:N_FRAMES])
    graph_step = phase("graph_step", phase_graph_step, cfg, pts[:N_FRAMES], mask[:N_FRAMES])
    checkpoint = os.path.join(tempfile.mkdtemp(prefix="chip_smoke_"), "in_step.npz")
    loop_summary, loop_inputs, loop_est = phase("loop_path", phase_loop_path, cfg, gt, pts,
                                                mask, checkpoint)
    # the kernels are checked on the frames and the local map of the 32-frame
    # run, and at the loop shapes on the last attempt's inputs
    rows = phase("kernels", phase_kernels, cfg, pts[:N_FRAMES], mask[:N_FRAMES], state, gn_log)
    for row in rows:
        row["launches"] = launches.get(row["name"], 0)
    rows += phase("loop_kernels", phase_loop_kernels, loop_summary, loop_inputs)
    phase("cpu_agreement", phase_cpu_agreement)
    phase("loop_cpu_agreement", phase_loop_cpu_agreement)
    in_step = phase("in_step", phase_in_step, cfg, gt, pts, mask, checkpoint)
    os.remove(checkpoint)
    os.rmdir(os.path.dirname(checkpoint))
    radius = phase("radius_path", phase_radius_path, cfg, gt[:N_FRAMES], pts[:N_FRAMES],
                   mask[:N_FRAMES])
    phase("deskew_cpu_agreement", phase_deskew_cpu_agreement)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        nccl1 = phase("mesh_nccl1", phase_mesh_nccl1, cfg, gt[:N_FRAMES], pts[:N_FRAMES],
                      mask[:N_FRAMES], tmp)
        mesh_out = phase("mesh_ranks", phase_mesh_ranks, cfg, pts, mask, tmp)
        single_map = phase("mesh_single_map", phase_mesh_single_map, cfg, gt, mesh_out[0],
                           loop_summary, loop_est)
        lanes = phase("mesh_lanes", phase_mesh_lanes, tmp)
    mesh_rows, solver = phase("mesh_kernels_and_solver", phase_mesh_kernels_and_solver, cfg,
                              pts[:N_FRAMES], mask[:N_FRAMES], state, mesh_out)
    rows += mesh_rows
    del pts, mask          # the skewed frames take their place in host memory
    gt_s, pts_s, mask_s, imu = phase("render_skewed", render_skewed, cfg, N_CIRCUIT)
    replay = phase("deskew_path", phase_deskew_path, cfg, gt_s, pts_s, mask_s, imu)
    summary.update(card=smi, graph_step=graph_step, loop_path=loop_summary, in_step=in_step,
                   radius_path=radius, deskew_path=replay,
                   mesh_nccl1=nccl1,
                   mesh_single_map=single_map, mesh_lanes=lanes, mesh_solver=solver)
    log(f"summary {json.dumps(summary)}; phase seconds {json.dumps(seconds)}; "
        f"total {time.time() - t_start:.1f} s")
    print(smi)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
