"""The port's de-skew branch, radius-mode local map, chunked ``run_scanned``
and checkpoints, against the JAX reference where it has a counterpart.

* 6 frames rendered with their sweep's motion and a 40 Hz IMU stream,
  ``use_imu=True``, ``loop_closure_enabled=False`` (the reference's
  ``test_pipeline_imu`` configuration, which maps in radius mode): the
  port's ``run_scanned`` in chunks of 4 + 2 with the scans' stamps against
  the reference's ``SlamPipeline.run_scanned`` over the 6 frames in one
  chunk (its jitted ``lax.scan`` of ``slam_step``), poses within 1e-3 m /
  1e-4 rad as ``test_six_frame_trajectory`` holds them, the IMU buffers
  within 1e-5 relative;
* the radius-mode local map from a state carried across, with more
  eligible keyframes than ``recent_keyframe_search_num`` and ties in
  distance across the K-th place: validity masks equal, centroids within
  1e-5 m of exact f64 centroids of the reference's selection, and within
  1e-3 of the leaf of the reference's (its blocked f32 prefix sums are off
  by up to ~2e-4 m, ROADMAP §3);
* ``run_scanned`` in chunks of 4 against ``process`` frame by frame:
  poses equal, one hoisted loop attempt per chunk that crosses a boundary;
  checkpoints saved, loaded into a fresh pipeline and continued give the
  same poses, their leaf list is the reference's ``tree_flatten`` layout,
  and another capacity is refused; ``use_odom`` through ``add_odom``; the
  capacity warning fires once when a chunk fills the pose graph.

The reference's run is traced and compiled on a worker thread while the
port-only tests run, and its neighbour searches run its Pallas kernels in
interpret mode (see test_torch_mapping).
"""

import warnings
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from alego_tpu.models import laser_mapping as jlm, pipeline as jpipe

from alego_tpu_torch.models import laser_mapping as tlm, pipeline as tpipe
from alego_tpu_torch.models.image_projection import image_projection
from alego_tpu_torch.models.pipeline import tree_from_reference
from alego_tpu_torch.ops import deskew as tdk
from alego_tpu_torch.utils import synthetic as tsyn

from test_torch_mapping import pallas_search
from test_torch_odometry import assert_pose_close

# one intra-op thread: the suite runs in several test processes at once,
# where more threads per process only contend for the cores
torch.set_num_threads(1)

N_FRAMES = 6


@pytest.fixture(scope="module")
def skewed(cfg, world):
    """6 frames with their sweep's motion, the stamps, and a 40 Hz IMU
    stream along the same poses (noise-free)."""
    cfg = cfg.replace(use_imu=True, loop_closure_enabled=False)
    poses = tsyn.loop_trajectory(N_FRAMES, radius=20.0, speed=1.0, closed=False)
    pts, mask = tsyn.render_sequence_skewed(world, poses, cfg, noise=0.01)
    times = np.arange(N_FRAMES, dtype=np.float32) * np.float32(cfg.scan_period)
    return cfg, poses, pts, mask, times, tsyn.imu_stream(poses, cfg.scan_period)


@pytest.fixture(scope="module", autouse=True)
def reference_run(skewed):
    """The reference's run of the skewed frames, started on a worker thread
    with the file's first test; the de-skew test waits for it."""
    cfg, _, pts, mask, times, imu = skewed

    def run():
        with pytest.MonkeyPatch.context() as mp:
            pallas_search(mp)
            pipe = jpipe.SlamPipeline(cfg)
            for t, rpy, acc in imu:
                pipe.add_imu(t, rpy, acc)
            est = pipe.run_scanned(pts, mask, times=times)
            return est, jax.tree_util.tree_map(np.asarray, pipe.state.imu)

    with ThreadPoolExecutor(1) as pool:
        yield pool.submit(run)


@pytest.fixture(scope="module")
def loop_frames(cfg, world):
    """Unskewed frames for the hoisted-loop config, with the attempt on
    every frame boundary (no candidate can pass the 30 s age gate)."""
    cfg = cfg.replace(loop_in_step=False, loop_every_n_frames=1)
    poses = tsyn.loop_trajectory(N_FRAMES, radius=20.0, speed=1.0, closed=False)
    pts, mask = tsyn.render_sequence(world, poses, cfg, noise=0.01)
    return cfg, pts, mask


def _count_attempts(monkeypatch):
    calls = []
    real = tlm.loop_closure_step

    def counted(ms, c, **kw):
        calls.append(1)
        return real(ms, c, **kw)
    monkeypatch.setattr(tlm, "loop_closure_step", counted)
    return calls


@pytest.fixture(scope="module")
def process_run(loop_frames, tmp_path_factory):
    """``process`` frame by frame, with a checkpoint after frame 4 and the
    odometry poses collected."""
    cfg, pts, mask = loop_frames
    ck = str(tmp_path_factory.mktemp("ck") / "state.npz")
    with pytest.MonkeyPatch.context() as mp:
        calls = _count_attempts(mp)
        pipe = tpipe.SlamPipeline(cfg, device="cpu", collect_odom_poses=True)
        for k in range(N_FRAMES):
            if k == 4:
                pipe.save_checkpoint(ck)
            pipe.process(pts[k], mask[k])
    return torch.stack(pipe.poses).numpy(), len(calls), ck, pipe


def test_run_scanned_matches_process(loop_frames, process_run, monkeypatch):
    cfg, pts, mask = loop_frames
    est_p, calls_p, _, pipe_p = process_run
    calls = _count_attempts(monkeypatch)
    pipe = tpipe.SlamPipeline(cfg, device="cpu")
    est = np.concatenate([pipe.run_scanned(pts[:4], mask[:4]),
                          pipe.run_scanned(pts[4:], mask[4:])])
    np.testing.assert_array_equal(est, est_p)
    np.testing.assert_array_equal(torch.stack(pipe.poses).numpy(), est_p)
    # process attempts on every boundary once the graph has two keyframes
    # (frames 3-6), run_scanned once per chunk however many it crossed
    assert calls_p == 4 and len(calls) == 2
    assert pipe._frame == N_FRAMES
    assert int(pipe.state.mapping.graph.count) == int(pipe_p.state.mapping.graph.count)
    # the process run kept each frame's odometry pose; run_scanned keeps none
    assert len(pipe_p.odom_poses) == N_FRAMES and pipe.odom_poses == []
    np.testing.assert_array_equal(pipe_p.odom_poses[-1], pipe.state.T_odom2laser.numpy())


def test_checkpoint_resume(loop_frames, process_run):
    cfg, pts, mask = loop_frames
    est_p, _, ck, pipe_p = process_run
    pipe = tpipe.SlamPipeline(cfg, device="cpu")
    pipe.load_checkpoint(ck)
    assert pipe._frame == 4 and int(pipe.state.frame) == 4
    est = pipe.run_scanned(pts[4:], mask[4:])
    np.testing.assert_allclose(est, est_p[4:], rtol=0, atol=1e-6)
    assert int(pipe.state.mapping.graph.count) == int(pipe_p.state.mapping.graph.count)


def test_checkpoint_layout_is_the_reference(cfg, process_run):
    """The npz holds the reference's leaves in the reference's order; a
    pipeline of other capacities refuses it."""
    ck, cfg_p = process_run[2], process_run[3].cfg
    ref = jax.tree_util.tree_leaves(jpipe.init_state(cfg_p))
    with np.load(ck) as data:
        assert len([f for f in data.files if f.startswith("arr_")]) == len(ref)
        for i, leaf in enumerate(ref):
            a = data[f"arr_{i}"]
            assert (a.shape, a.dtype) == (tuple(leaf.shape), np.dtype(leaf.dtype)), i
        assert int(data["frame"]) == 4
    with pytest.raises(ValueError, match="incompatible"):
        tpipe.SlamPipeline(cfg_p.replace(max_keyframes=128), device="cpu").load_checkpoint(ck)


def _kf_state(cfg):
    """A reference mapping state with 12 keyframes: 9 within the 50 m
    search radius of the origin at squared distances 1, 4, 4, 9, 9, 9, 9,
    16, 25 (the four at 9 straddle the 6th place, so the tie order decides
    the set), 3 beyond it; random clouds and masks."""
    rng = np.random.default_rng(8)
    ms = jax.tree_util.tree_map(np.array, jlm.init_state(cfg))
    xy = [(1, 0), (0, 2), (-2, 0), (3, 0), (0, -3), (0, 3), (-3, 0), (4, 0), (0, 5),
          (60, 0), (0, -70), (70, 0)]
    poses = ms.graph.poses
    for k, (x, y) in enumerate(xy):
        c, s = np.cos(0.3 * k), np.sin(0.3 * k)
        poses[k, :2, :2] = [[c, -s], [s, c]]
        poses[k, :2, 3] = [x, y]
    for name, cap in (("corner", cfg.kf_corner_cap), ("surf", cfg.kf_surf_cap),
                      ("outlier", cfg.kf_outlier_cap)):
        getattr(ms, f"kf_{name}")[:] = rng.uniform(-15, 15, (cfg.max_keyframes, cap, 3))
        getattr(ms, f"kf_{name}_valid")[:] = rng.random((cfg.max_keyframes, cap)) < 0.5
    return ms._replace(graph=ms.graph._replace(count=np.int32(len(xy))))


def _exact_centroids(pts, leaf):
    cells = {}
    for p in pts.astype(np.float64):
        acc = cells.setdefault(tuple(np.floor(p / leaf).astype(int)), [0.0, 0])
        acc[0] = acc[0] + p
        acc[1] += 1
    return cells


def test_radius_local_map_matches_reference(cfg):
    cfg = cfg.replace(loop_closure_enabled=False, recent_keyframe_search_num=6,
                      max_keyframes=16)
    ms = _kf_state(cfg)
    T = np.eye(4, dtype=np.float32)
    out_j = jax.jit(lambda m, t: jlm._build_local_map(m, cfg, t))(ms, jnp.asarray(T))
    out_j = [np.asarray(a) for a in out_j]
    ms_t = tree_from_reference(tlm.MappingState, ms, "cpu")
    out_t = [a.numpy() for a in tlm._build_local_map(ms_t, cfg, torch.from_numpy(T))]

    # the reference's selection: the 6 nearest eligible, ties lower index first
    sel = [0, 1, 2, 3, 4, 5]
    for (pts_t, ok_t), (pts_j, ok_j), leaf, names in (
            ((out_t[0], out_t[1]), (out_j[0], out_j[1]), cfg.corner_leaf, ("corner",)),
            ((out_t[2], out_t[3]), (out_j[2], out_j[3]), cfg.surf_leaf, ("surf", "outlier"))):
        np.testing.assert_array_equal(ok_t, ok_j)
        np.testing.assert_allclose(pts_t[ok_t], pts_j[ok_j], rtol=0, atol=1e-3 * leaf)
        world = []
        for k in sel:
            P = ms.graph.poses[k]
            for name in names:
                v = getattr(ms, f"kf_{name}_valid")[k]
                world.append(getattr(ms, f"kf_{name}")[k][v] @ P[:3, :3].T + P[:3, 3])
        cells = _exact_centroids(np.concatenate(world), leaf)
        got = pts_t[ok_t]
        assert len(got) == len(cells)
        for c in got:
            s, n = cells[tuple(np.floor(c / leaf).astype(int))]
            np.testing.assert_allclose(c, s / n, rtol=0, atol=1e-5)


def test_use_odom_deskews(skewed):
    """``use_odom=True`` fed through ``add_odom`` (the IMU stream's
    orientation, the ground-truth position of each sample's frame, the
    frames' 5 m/s forward speed): the buffer counts every sample and the
    de-skew moves the points."""
    cfg, poses, pts, mask, _, imu = skewed
    cfg = cfg.replace(use_imu=False, use_odom=True)
    pipe = tpipe.SlamPipeline(cfg, device="cpu")
    n = 4
    fed = [s for s in imu if s[0] <= n * cfg.scan_period + 1e-6]
    for t, rpy, _ in fed:
        k = min(int(t / cfg.scan_period + 1e-9), N_FRAMES - 1)
        pipe.add_odom(t, rpy, poses[k][:3, 3], (1.0 / cfg.scan_period, 0.0, 0.0))
    est = pipe.run_scanned(pts[:n], mask[:n])
    assert est.shape == (n, 4, 4) and np.isfinite(est).all()
    assert int(pipe.state.imu.count) == len(fed)
    seg = image_projection(torch.from_numpy(pts[1]), torch.from_numpy(mask[1]), cfg)
    moved = tdk.deskew(seg.points, seg.cols, seg.valid, torch.tensor(0.2), pipe.state.imu, cfg,
                       orient_start=seg.orient_start, orient_diff=seg.orient_diff)
    assert float((moved - seg.points).abs().max()) > 0.01


def test_overflow_warns_once_per_run(skewed):
    """A chunk that fills a 2-keyframe graph warns once; the next chunk,
    which overflows again, does not warn again."""
    cfg = skewed[0].replace(use_imu=False, max_keyframes=2, recent_keyframe_search_num=1)
    pts, mask = skewed[2], skewed[3]
    pipe = tpipe.SlamPipeline(cfg, device="cpu")
    with warnings.catch_warnings(record=True) as got:
        warnings.simplefilter("always")
        pipe.run_scanned(pts, mask)
        ov = int(pipe.state.mapping.graph.overflow)
        pipe.run_scanned(pts[:2], mask[:2])
    caps = [w for w in got if issubclass(w.category, RuntimeWarning) and "capacity" in str(w.message)]
    assert ov >= 1 and int(pipe.state.mapping.graph.overflow) > ov
    assert len(caps) == 1


def test_deskew_pipeline_matches_reference(skewed, reference_run):
    cfg, gt, pts, mask, times, imu = skewed
    pipe = tpipe.SlamPipeline(cfg, device="cpu")
    for t, rpy, acc in imu:
        pipe.add_imu(t, rpy, acc)
    est = np.concatenate([pipe.run_scanned(pts[:4], mask[:4], times=times[:4]),
                          pipe.run_scanned(pts[4:], mask[4:], times=times[4:])])
    est_j, imu_j = reference_run.result()
    assert int(pipe.state.imu.count) == int(imu_j.count) == len(imu)
    for name in ("times", "rpy", "velo", "shift"):
        want = getattr(imu_j, name)
        np.testing.assert_allclose(getattr(pipe.state.imu, name).numpy(), want, rtol=1e-5,
                                   atol=1e-5 * max(1.0, np.abs(want[np.abs(want) < 1e17]).max()),
                                   err_msg=name)
    assert_pose_close(est, est_j, t_tol=1e-3, r_tol=1e-4)
    assert np.abs(est[:, :3, 3] - gt[:, :3, 3]).max() < 0.5
