"""Command-line runner of the port, the counterpart of ``alego_tpu.cli``
(the launch-file equivalent, C16).

The reference is started with ``roslaunch alego test2.launch`` + a rosbag
replay (README.md:27-41).  Here the same role is one command:

    python -m alego_tpu_torch.cli --input /path/to/frames --output out/
    python -m alego_tpu_torch.cli --bag robo_0529.bag --use-imu --output out/
    python -m alego_tpu_torch.cli --synthetic 8 --tiny --device cpu --output out/

``--input`` accepts a directory of ``.pcd`` or KITTI ``.bin`` frames (sorted
by name, prefetched by the native C++ loader); ``--bag`` replays
PointCloud2 (and, with ``--use-imu``, Imu) messages straight out of a ROS
bag (utils/rosbag.py, no ROS install).  Outputs: TUM-format trajectory,
timing report, the /save_map-equivalent PCD map and ``state.npz``.  The run
is on the GPU unless ``--device cpu`` asks for the CPU.  ``--mesh N``
runs N synthetic sequences at once, one ``SlamPipeline`` lane per rank
(``parallel.multichip.ShardedSlamPipeline``): over NCCL with one card per
rank on the GPU, over gloo on the CPU.
"""

from __future__ import annotations

import argparse
import os
import sys
import time


def _tum_line(t, T):
    """One TUM row ``t x y z qx qy qz qw`` of a [4, 4] pose (numpy)."""
    import numpy as np
    import torch
    from .ops import se3

    T = np.asarray(T, np.float32)
    q = se3.rot_to_quat(torch.from_numpy(np.ascontiguousarray(T[:3, :3]))).numpy()
    return (f"{t:.6f} {T[0,3]:.6f} {T[1,3]:.6f} {T[2,3]:.6f} "
            f"{q[1]:.6f} {q[2]:.6f} {q[3]:.6f} {q[0]:.6f}")


def _run_mesh(args, cfg, ap):
    """``--mesh B --synthetic n``: B sequences of one circuit through B
    worlds (world seed 7 + b, noise seed b), one lane per rank; per-lane
    ATE, keyframe and loop lines and ``trajectory_tum_{b}.txt``."""
    import tempfile
    import numpy as np
    import torch
    from .parallel import launch, ranks
    from .utils import synthetic
    from .utils.metrics import ate_rmse

    B, n = args.mesh, args.synthetic
    device = torch.device(args.device).type
    if device == "cuda" and torch.cuda.is_available() and torch.cuda.device_count() < B:
        ap.error(f"--mesh {B} on the GPU needs {B} cards (one NCCL rank per card), "
                 f"but {torch.cuda.device_count()} are visible")
    radius = args.radius or max(4.0, n * 0.25 / (2 * 3.14159))
    gt = synthetic.loop_trajectory(n, radius=radius, closed=True)
    seqs, masks = [], []
    for b in range(B):
        world = synthetic.make_world(seed=7 + b, clear_path=gt[:, :2, 3])
        p, m = synthetic.render_sequence(world, gt, cfg, noise=0.01, seed=b)
        seqs.append(p)
        masks.append(m)
    with tempfile.TemporaryDirectory(prefix="alego_mesh_") as tmp:
        ranks.save_frames(tmp, np.stack(seqs, 1), np.stack(masks, 1))
        res = launch.launch(ranks.lanes_run, B, cfg, tmp, device=device)
    traj, wall = res["trajectories"], res["seconds"]
    print(f"{B} sequences x {n} frames in {wall:.1f}s "
          f"({B * n / max(wall, 1e-9):.1f} frames/s aggregate)")
    for b in range(B):
        ate = ate_rmse(traj[:, b, :3, 3], gt[:, :3, 3], align=False)
        print(f"  sequence {b}: ATE {ate:.3f} m, "
              f"keyframes {int(res['keyframes'][b])}, loops {int(res['loops'][b])}")
    os.makedirs(args.output, exist_ok=True)
    for b in range(B):
        with open(os.path.join(args.output, f"trajectory_tum_{b}.txt"), "w") as f:
            for k in range(traj.shape[0]):
                f.write(_tum_line(k * cfg.scan_period, traj[k, b]) + "\n")
    print(f"trajectories -> {args.output}/trajectory_tum_*.txt")
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser(description="alego_tpu_torch SLAM runner")
    ap.add_argument("--input", help="directory of .pcd/.bin scans")
    ap.add_argument("--bag", help="ROS bag (v2.0) to replay — the reference's "
                                  "`rosbag play` input path, no ROS needed")
    ap.add_argument("--topic", help="PointCloud2 topic inside --bag "
                                    "(default: every PointCloud2 topic)")
    ap.add_argument("--use-imu", action="store_true",
                    help="enable IMU-aided de-skew (utility.h:68) and feed "
                         "sensor_msgs/Imu messages from --bag")
    ap.add_argument("--imu-topic", default="/imu/data",
                    help="Imu topic inside --bag (default /imu/data, the "
                         "reference's subscription LO.cpp:116); use '' to "
                         "accept any single IMU stream")
    ap.add_argument("--synthetic", type=int, default=0,
                    help="run N synthetic frames instead of real data")
    ap.add_argument("--output", default="alego_out", help="output directory")
    ap.add_argument("--tiny", action="store_true", help="use the small test config")
    ap.add_argument("--preset", choices=["standalone", "nodelet"],
                    default="standalone",
                    help="parameter preset: 'standalone' (LM.cpp) or "
                         "'nodelet' (laserMapping.cpp drift: loop radius 20, "
                         "fitness 0.4, history leaf 1.0)")
    ap.add_argument("--no-loop-closure", action="store_true")
    ap.add_argument("--loop-time-gap", type=float, default=None,
                    help="min age (s) of a loop candidate (LM.cpp:934; "
                         "default 30; short synthetic circuits need less)")
    ap.add_argument("--loop-fitness", type=float, default=None,
                    help="ICP acceptance fitness gate (LM.cpp:212)")
    ap.add_argument("--loop-search-num", type=int, default=None,
                    help="+-K keyframes in the loop history cloud (LM.cpp:211)")
    ap.add_argument("--radius", type=float, default=None,
                    help="synthetic loop radius in metres (default scales "
                         "with frame count)")
    ap.add_argument("--tf-b2l", default=None, metavar="X,Y,Z,R,P,Y",
                    help="laser-in-base-link extrinsic (m, rad) — the "
                         "reference's tf_b2l_ launch param (LO.cpp:591); "
                         "trajectory poses are reported in base-link")
    ap.add_argument("--max-frames", type=int, default=0)
    ap.add_argument("--loop-in-scan", action="store_true",
                    help="run the loop-closure attempt inside the frame step "
                         "(loop_in_step=True) instead of between chunks "
                         "(hoisted is the default for --bag/--input: the "
                         "reference's separate loop thread, LM.cpp:779)")
    ap.add_argument("--chunk", type=int, default=16, metavar="C",
                    help="streaming window for --bag/--input: C buffered "
                         "scans go to the device in one copy and run as one "
                         "run_scanned call (latency bound C x scan_period; "
                         "C=16 is 3.2 s at 5 Hz); 0 disables chunking")
    ap.add_argument("--save-map", action="store_true", help="export PCD map")
    ap.add_argument("--checkpoint", help="resume from a checkpoint .npz")
    ap.add_argument("--dump-debug", action="store_true",
                    help="write first-frame segmented/feature clouds as PCDs "
                         "(the reference's debug topics, LO.cpp:123-127)")
    ap.add_argument("--viz", action="store_true",
                    help="write an interactive standalone viewer.html of the "
                         "map + trajectory (the rviz session equivalent)")
    ap.add_argument("--dump-every", type=int, default=0, metavar="K",
                    help="every K frames, export the surround map + pose "
                         "(the 0.2 Hz /laser_cloud_surround publisher, "
                         "LM.cpp:744-777)")
    ap.add_argument("--mesh", type=int, default=0, metavar="N",
                    help="run N concurrent synthetic SLAM sequences, one rank "
                         "per sequence (with --device cuda: one card each)")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the run (default cuda; cpu runs "
                         "every kernel's plain PyTorch version)")
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    from .config import PipelineConfig, tiny_config, nodelet_config
    from .models.pipeline import SlamPipeline
    from .utils.profiling import StageTimer
    from .utils import io as pio

    if args.tiny:
        cfg = tiny_config()
    elif args.preset == "nodelet":
        cfg = nodelet_config()
    else:
        cfg = PipelineConfig()
    if args.no_loop_closure:
        cfg = cfg.replace(loop_closure_enabled=False)
    if args.use_imu:
        cfg = cfg.replace(use_imu=True)
    if args.loop_time_gap is not None:
        cfg = cfg.replace(loop_time_gap=args.loop_time_gap)
    if args.loop_fitness is not None:
        cfg = cfg.replace(history_fitness_score=args.loop_fitness)
    if args.loop_search_num is not None:
        cfg = cfg.replace(history_search_num=args.loop_search_num)
    if args.tf_b2l:
        vals = tuple(float(v) for v in args.tf_b2l.split(","))
        if len(vals) != 6:
            ap.error("--tf-b2l needs 6 comma-separated values (x,y,z,r,p,y)")
        cfg = cfg.replace(tf_b2l=vals)
    if ((args.bag or args.input) and cfg.loop_closure_enabled
            and not args.loop_in_scan):
        # hoisted loop mode (see --loop-in-scan): the attempt runs as its
        # own call between chunks
        cfg = cfg.replace(loop_in_step=False)

    if args.mesh:
        if not args.synthetic:
            ap.error("--mesh currently requires --synthetic N frames")
        return _run_mesh(args, cfg, ap)

    pipe = SlamPipeline(cfg, device=args.device)
    if args.checkpoint:
        pipe.load_checkpoint(args.checkpoint)
        print(f"resumed from {args.checkpoint} at frame {int(pipe.state.frame)}")

    os.makedirs(args.output, exist_ok=True)
    timer = StageTimer()

    def maybe_dump_surround():
        """Periodic surround-map export — the 0.2 Hz /laser_cloud_surround
        publisher (LM.cpp:744-777) as files an operator can watch."""
        k = len(pipe.poses)
        if not args.dump_every or k == 0 or k % args.dump_every:
            return
        sdir = os.path.join(args.output, "surround")
        os.makedirs(sdir, exist_ok=True)
        m = pipe.export_map()
        cloud = np.concatenate([m["corner"], m["surf"], m["outlier"]], 0)
        pio.write_pcd(os.path.join(sdir, f"surround_{k:06d}.pcd"), cloud)
        np.save(os.path.join(sdir, f"pose_{k:06d}.npy"), pipe.poses[-1].cpu().numpy())

    # chunked streaming (see --chunk): scans buffer host-side and go to the
    # device as one run_scanned window — bounded latency, one copy per C
    # frames
    chunk = max(0, args.chunk)
    ready_pts, ready_msk, ready_t = [], [], []

    def _dispatch(C):
        pts = np.stack(ready_pts[:C])
        msk = np.stack(ready_msk[:C])
        # a mixed chunk (some scans stamped, some not) must still produce a
        # MONOTONIC ts vector — de-skew interpolates against sorted times.
        # Unstamped entries therefore extend from the last known stamp by
        # one scan period instead of falling back to the frame clock (whose
        # origin can sit before/after real bag stamps).
        last = _dispatch.last_stamp
        if last is None:
            last = pipe._frame * cfg.scan_period - cfg.scan_period
        ts = np.empty(C, np.float32)
        for i, t in enumerate(ready_t[:C]):
            last = last + cfg.scan_period if t is None else float(t)
            ts[i] = last
        _dispatch.last_stamp = last
        del ready_pts[:C], ready_msk[:C], ready_t[:C]
        _run_chunk(pts, msk, ts)

    _dispatch.last_stamp = None

    def _run_chunk(pts, msk, ts):
        with timer.stage("slam_chunk"):
            pipe.run_scanned(pts, msk, times=ts)
        maybe_dump_surround()

    def flush_chunks(force=False):
        while chunk >= 2 and len(ready_pts) >= chunk:
            _dispatch(chunk)
        if force and ready_pts:
            # tail shorter than a chunk: one more run_scanned call
            _dispatch(len(ready_pts))

    def feed(points4, t=None):
        pts = points4[:, :3].astype(np.float32)
        good = np.isfinite(pts).all(-1)
        pad = np.zeros((cfg.max_raw_points, 3), np.float32)
        msk = np.zeros(cfg.max_raw_points, bool)
        n = min(good.sum(), cfg.max_raw_points)
        pad[:n] = pts[good][:n]
        msk[:n] = True
        if dump_first:
            dump_first.pop()(pad, msk)
        if chunk >= 2:
            ready_pts.append(pad)
            ready_msk.append(msk)
            ready_t.append(t)
            flush_chunks()
            return None
        with timer.stage("slam_step"):
            out = pipe.process(pad, msk, time=t)
        maybe_dump_surround()
        return out

    if args.dump_debug:
        from .models.image_projection import image_projection
        from .ops.features import extract_features

        def dump_first_frame(points, msk):
            seg = image_projection(torch.as_tensor(points, device=pipe.device),
                                   torch.as_tensor(msk, device=pipe.device), cfg)
            fc = extract_features(seg, cfg)
            dbg = os.path.join(args.output, "debug")
            os.makedirs(dbg, exist_ok=True)
            v = seg.valid.cpu().numpy()
            pio.write_pcd(os.path.join(dbg, "segmented.pcd"),
                          seg.points.cpu().numpy()[v])
            for name in ("sharp", "less_sharp", "flat", "less_flat"):
                pts_ = getattr(fc, f"{name}_pts").cpu().numpy()
                ok_ = getattr(fc, f"{name}_valid").cpu().numpy()
                pio.write_pcd(os.path.join(dbg, f"{name}.pcd"), pts_[ok_])
            print(f"debug clouds -> {dbg}/")

        dump_first = [dump_first_frame]
    else:
        dump_first = []

    t_start = time.time()
    gt = None
    if args.synthetic:
        from .utils import synthetic

        # ~0.25 m/frame (1.25 m/s at 5 Hz); loop circumference scales with n
        radius = args.radius or max(4.0, args.synthetic * 0.25 / (2 * 3.14159))
        gt = synthetic.loop_trajectory(args.synthetic, radius=radius, closed=True)
        world = synthetic.make_world(seed=7, clear_path=gt[:, :2, 3])
        pts_seq, mask_seq = synthetic.render_sequence(world, gt, cfg, noise=0.01)
        for k in range(args.synthetic):
            if k == 0 and dump_first:
                dump_first.pop()(pts_seq[0], mask_seq[0])
            with timer.stage("slam_step"):
                pipe.process(pts_seq[k], mask_seq[k])
            maybe_dump_surround()
    elif args.bag:
        from .utils.rosbag import read_bag_messages, IMU_TYPE

        n_fed = 0
        n_imu = 0
        t0_bag = None
        # de-skew interpolates IMU over the scan's WHOLE sweep [t, t+T], so
        # each cloud is held until an IMU sample at >= t + T has been fed —
        # the reference does the same with its sync'd queues (LO.cpp:155-178)
        pending = []
        last_imu_t = -1e18

        def drain(force=False):
            nonlocal n_fed
            while pending and (force or not args.use_imu
                               or pending[0][0] + cfg.scan_period
                               <= last_imu_t):
                # respect --max-frames BEFORE feeding, so repeated drain()
                # calls never overshoot the cap
                if args.max_frames and n_fed >= args.max_frames:
                    pending.clear()
                    return True
                trel, arr = pending.pop(0)
                feed(arr, t=trel)
                n_fed += 1
            return args.max_frames and n_fed >= args.max_frames

        stop = False
        for t, _topic, mtype, msg in read_bag_messages(
                args.bag, args.topic, imu_topic=args.imu_topic or None):
            t0_bag = msg.stamp if t0_bag is None else t0_bag
            if mtype == IMU_TYPE:
                if args.use_imu:
                    # the reference's imuHandler (LO.cpp:840-881): rpy from
                    # the orientation quaternion + body-frame acceleration
                    last_imu_t = msg.stamp - t0_bag
                    pipe.add_imu(last_imu_t, msg.rpy(), msg.lin_acc)
                    n_imu += 1
                    stop = stop or drain()
            else:
                pending.append((msg.stamp - t0_bag,
                                msg.array(("x", "y", "z"))))
                if not args.use_imu:
                    stop = stop or drain()
            if stop:
                break
        if not stop:
            drain(force=True)
        flush_chunks(force=True)
        print(f"{n_fed} PointCloud2 + {n_imu} Imu messages from {args.bag}")
    else:
        if not args.input:
            ap.error("either --input, --bag or --synthetic is required")
        from .runtime.io_native import FrameLoader

        paths = sorted(
            os.path.join(args.input, f) for f in os.listdir(args.input)
            if f.endswith((".pcd", ".bin")))
        if args.max_frames:
            paths = paths[: args.max_frames]
        print(f"{len(paths)} frames from {args.input}")
        loader = FrameLoader(paths, n_threads=2)
        for frame in loader:
            feed(frame)
        loader.close()
        flush_chunks(force=True)

    n = len(pipe.poses)
    wall = time.time() - t_start
    print(f"{n} frames in {wall:.1f}s ({n / max(wall, 1e-9):.1f} fps)")
    print(timer.report())

    est = (torch.stack(pipe.poses).cpu().numpy() if n
           else np.zeros((0, 4, 4), np.float32))
    traj_path = os.path.join(args.output, "trajectory_tum.txt")
    with open(traj_path, "w") as f:
        for k in range(n):
            f.write(_tum_line(k * cfg.scan_period, est[k]) + "\n")
    print(f"trajectory -> {traj_path}")

    if gt is not None:
        from .utils.metrics import ate_rmse

        print(f"ATE vs synthetic ground truth: "
              f"{ate_rmse(est[:, :3, 3], gt[:, :3, 3], align=False):.3f} m")

    ms = pipe.state.mapping
    print(f"keyframes: {int(ms.graph.count)}, loops: {int(ms.graph.loop_count)}")

    if args.save_map:
        pio.save_map(os.path.join(args.output, "map"), pipe.export_map())
        print(f"map -> {args.output}/map/*.pcd")

    if args.viz:
        from .utils.viewer import write_html_viewer

        m = pipe.export_map()
        cloud = np.concatenate([m["corner"], m["surf"], m["outlier"]], 0)
        viz_path = os.path.join(args.output, "viewer.html")
        write_html_viewer(viz_path, est, cloud)
        print(f"viewer -> {viz_path}")

    pipe.save_checkpoint(os.path.join(args.output, "state.npz"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
