"""The port's command-line runner (``alego_tpu_torch.cli``) case by case
after tests/test_cli.py, with ``--device cpu``; a bag replay with
``--use-imu``; the round trips of tests/test_rosbag.py and the PCD cases of
tests/test_io_runtime.py on the port's copies (bags also read across with
the reference's reader and writer); and the TUM lines, which must equal the
reference's ``_tum_line`` character for character.

One synthetic run serves the output, viewer, resume and schema cases.
"""

import bz2
import os
import struct

import numpy as np
import pytest
import torch

from alego_tpu import cli as jcli
from alego_tpu.config import nodelet_config as j_nodelet_config
from alego_tpu.utils import rosbag as jrb

from alego_tpu_torch import cli as tcli, tiny_config
from alego_tpu_torch.config import nodelet_config
from alego_tpu_torch.models.pipeline import SlamPipeline
from alego_tpu_torch.runtime import io_native
from alego_tpu_torch.utils import io as pio, rosbag as rb, synthetic

# one intra-op thread: the suite runs in several test processes at once,
# where more threads per process only contend for the cores
torch.set_num_threads(1)


def main(*args):
    return tcli.main([*args, "--device", "cpu"])


def _tum(out):
    return open(os.path.join(out, "trajectory_tum.txt")).read().splitlines()


@pytest.fixture(scope="module")
def synthetic_run(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("cli") / "out")
    rc = main("--synthetic", "4", "--tiny", "--output", out, "--no-loop-closure",
              "--save-map", "--viz", "--dump-every", "2")
    return rc, out


def test_cli_synthetic_run(synthetic_run):
    rc, out = synthetic_run
    assert rc == 0
    assert os.path.exists(os.path.join(out, "state.npz"))
    assert os.path.exists(os.path.join(out, "map", "surf.pcd"))
    lines = _tum(out)
    assert len(lines) == 4
    assert len(lines[0].split()) == 8  # TUM: t x y z qx qy qz qw
    assert np.isfinite(np.loadtxt(os.path.join(out, "trajectory_tum.txt"))).all()


def test_cli_viz_and_surround_dumps(synthetic_run):
    out = synthetic_run[1]
    html = open(os.path.join(out, "viewer.html")).read()
    assert "<canvas" in html and "const PTS" in html
    sdir = os.path.join(out, "surround")
    for k in (2, 4):
        assert os.path.exists(os.path.join(sdir, f"surround_{k:06d}.pcd"))
    assert np.load(os.path.join(sdir, "pose_000002.npy")).shape == (4, 4)


def test_cli_resume(synthetic_run, tmp_path):
    out = str(tmp_path / "b")
    rc = main("--synthetic", "2", "--tiny", "--output", out, "--no-loop-closure",
              "--checkpoint", os.path.join(synthetic_run[1], "state.npz"))
    assert rc == 0
    assert len(_tum(out)) == 2
    with np.load(os.path.join(out, "state.npz")) as data:
        assert int(data["frame"]) == 6


def test_checkpoint_schema_mismatch_rejected(synthetic_run):
    cfg = tiny_config().replace(loop_closure_enabled=False)
    ck = os.path.join(synthetic_run[1], "state.npz")
    SlamPipeline(cfg, device="cpu").load_checkpoint(ck)
    with pytest.raises(ValueError, match="incompatible"):
        SlamPipeline(cfg.replace(max_keyframes=128), device="cpu").load_checkpoint(ck)


def test_nodelet_preset_values():
    cfg = nodelet_config()
    assert cfg.history_search_radius == 20.0    # laserMapping.cpp:76
    assert cfg.history_fitness_score == 0.4     # laserMapping.cpp:78
    assert cfg.history_leaf == 1.0              # laserMapping.cpp:41
    ref = j_nodelet_config()
    for name in ("history_search_radius", "history_fitness_score", "history_leaf",
                 "history_search_num", "loop_time_gap"):
        assert getattr(cfg, name) == getattr(ref, name), name


def test_cli_frame_dir(tmp_path):
    """.bin frames through the native prefetching loader."""
    cfg = tiny_config()
    world = synthetic.make_world(seed=2)
    poses = synthetic.loop_trajectory(3, radius=20, speed=0.5, closed=False)
    d = tmp_path / "frames"
    d.mkdir()
    for k in range(3):
        pts = synthetic.render_scan(world, poses[k], cfg)
        pts = pts[np.isfinite(pts).all(-1)][:4000]
        np.concatenate([pts, np.zeros((len(pts), 1), np.float32)], 1).tofile(
            str(d / f"{k:04d}.bin"))
    out = str(tmp_path / "out")
    assert main("--input", str(d), "--tiny", "--output", out, "--no-loop-closure") == 0
    assert len(_tum(out)) == 3


def test_cli_loop_flags(tmp_path):
    out = str(tmp_path / "out")
    rc = main("--synthetic", "4", "--tiny", "--output", out, "--loop-time-gap", "3",
              "--loop-fitness", "0.5", "--loop-search-num", "10", "--radius", "8")
    assert rc == 0
    assert len(_tum(out)) == 4


def test_cli_mesh_is_not_ported(capsys):
    """``--mesh`` runs synthetic sequences only, as the reference's: other
    inputs exit with its error."""
    with pytest.raises(SystemExit):
        main("--tiny", "--mesh", "2")
    assert "--mesh currently requires --synthetic" in capsys.readouterr().err


def test_cli_mesh_lanes(tmp_path, capsys):
    """``--mesh 2 --synthetic 4 --device cpu``: two gloo ranks, one lane
    each; a TUM file and the reference's ATE / keyframes / loops line per
    sequence."""
    out = str(tmp_path / "out")
    assert main("--synthetic", "4", "--tiny", "--mesh", "2", "--output", out) == 0
    text = capsys.readouterr().out
    for b in range(2):
        rows = np.loadtxt(os.path.join(out, f"trajectory_tum_{b}.txt"))
        assert rows.shape == (4, 8) and np.isfinite(rows).all()
        assert f"sequence {b}: ATE" in text
    assert "2 sequences x 4 frames" in text


def test_cli_needs_a_gpu_unless_asked(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tcli.main(["--synthetic", "1", "--tiny", "--output", str(tmp_path)])


def test_cli_bag_replay_with_imu(tmp_path, capsys):
    """8 frames rendered with their sweep's motion and a 40 Hz IMU stream,
    written by the port's bag writer with stamps from 100 s, replayed with
    ``--use-imu`` in chunks of 4 (hoisted loop attempts between them)."""
    cfg = tiny_config()
    n = 8
    poses = synthetic.loop_trajectory(n, radius=25.0, speed=0.5, closed=False)
    world = synthetic.make_world(seed=11, clear_path=poses[:, :2, 3])
    pts, mask = synthetic.render_sequence_skewed(world, poses, cfg, noise=0.01)
    imu = [(100.0 + t, rpy, acc) for t, rpy, acc in
           synthetic.imu_stream(poses, cfg.scan_period, rpy_noise=1e-3, acc_noise=0.05, seed=4)]
    bag = str(tmp_path / "seq.bag")
    rb.write_bag_pointclouds(bag, [(100.0 + cfg.scan_period * k, pts[k][mask[k]])
                                   for k in range(n)], imu=imu)
    out = str(tmp_path / "out")
    capsys.readouterr()
    rc = main("--bag", bag, "--tiny", "--use-imu", "--chunk", "4", "--output", out)
    assert rc == 0
    assert f"{n} PointCloud2 + {len(imu)} Imu messages" in capsys.readouterr().out
    traj = np.loadtxt(os.path.join(out, "trajectory_tum.txt"))
    assert traj.shape == (n, 8) and np.isfinite(traj).all()
    assert np.abs(traj[:, 1:4] - poses[:, :3, 3]).max() < 0.5
    pipe = SlamPipeline(cfg.replace(use_imu=True, loop_in_step=False), device="cpu")
    pipe.load_checkpoint(os.path.join(out, "state.npz"))
    assert int(pipe.state.imu.count) == len(imu)


# ---- the rosbag round trips (tests/test_rosbag.py) on the port's copy ----

def _clouds(n=3, pts=50, seed=0):
    rng = np.random.default_rng(seed)
    return [(100.0 + 0.1 * k, rng.normal(size=(pts, 3)).astype(np.float32),
             rng.random(pts).astype(np.float32)) for k in range(n)]


def test_rosbag_roundtrip_uncompressed(tmp_path):
    path = str(tmp_path / "t.bag")
    clouds = _clouds()
    rb.write_bag_pointclouds(path, clouds, topic="/lslidar_point_cloud")
    for reader in (rb, jrb):      # the reference's reader reads it too
        got = list(reader.read_bag_pointclouds(path))
        assert len(got) == 3
        for (t, topic, pc), (stamp, xyz, inten) in zip(got, clouds):
            assert topic == "/lslidar_point_cloud"
            assert abs(t - stamp) < 1e-6 and abs(pc.stamp - stamp) < 1e-6
            np.testing.assert_allclose(pc.array(("x", "y", "z")), xyz, rtol=1e-6)
            np.testing.assert_allclose(pc.array(("intensity",))[:, 0], inten, rtol=1e-6)


def test_rosbag_topic_filter_and_info(tmp_path):
    path = str(tmp_path / "t.bag")
    rb.write_bag_pointclouds(path, _clouds(2), topic="/velodyne_points")
    assert list(rb.read_bag_pointclouds(path, topic="/other")) == []
    assert rb.bag_topics(path) == {"/velodyne_points": (rb.PC2_TYPE, 2)}


def test_rosbag_bz2_chunk(tmp_path):
    """The writer's chunk re-packed with bz2 (rosbag record --bz2)."""
    path = str(tmp_path / "plain.bag")
    clouds = _clouds(2, seed=3)
    rb.write_bag_pointclouds(path, clouds)
    raw = open(path, "rb").read()
    off = len(rb.MAGIC)
    (hlen,) = struct.unpack_from("<I", raw, off)
    (dlen,) = struct.unpack_from("<I", raw, off + 4 + hlen)
    off2 = off + 4 + hlen + 4 + dlen          # start of the chunk record
    (chlen,) = struct.unpack_from("<I", raw, off2)
    chdr = rb._parse_header(raw[off2 + 4: off2 + 4 + chlen])
    (cdlen,) = struct.unpack_from("<I", raw, off2 + 4 + chlen)
    blob = raw[off2 + 4 + chlen + 4: off2 + 4 + chlen + 4 + cdlen]
    packed = rb._record({"op": bytes([rb.OP_CHUNK]), "compression": b"bz2",
                         "size": chdr["size"]}, bz2.compress(blob))
    path2 = str(tmp_path / "bz2.bag")
    with open(path2, "wb") as f:
        f.write(raw[:off2] + packed)
    got = list(rb.read_bag_pointclouds(path2))
    assert len(got) == 2
    np.testing.assert_allclose(got[1][2].array(), clouds[1][1], rtol=1e-6)


def test_rosbag_imu_roundtrip(tmp_path):
    """sensor_msgs/Imu interleaved with clouds; the reference's writer's bag
    read by the port's reader gives the same messages."""
    rng = np.random.default_rng(0)
    clouds = [(0.1, rng.normal(size=(50, 3)).astype(np.float32)),
              (0.3, rng.normal(size=(40, 3)).astype(np.float32))]
    imu = [(0.05, (0.01, -0.02, 0.5), (0.1, 0.2, 9.9)),
           (0.15, (0.0, 0.0, 0.6), (0.0, 0.0, 9.81), (0.0, 0.0, 0.5)),
           (0.25, (0.02, 0.01, 0.7), (-0.1, 0.1, 9.7))]
    for writer in (rb, jrb):
        path = str(tmp_path / "mix.bag")
        writer.write_bag_pointclouds(path, clouds, topic="/pc", imu=imu)
        topics = rb.bag_topics(path)
        assert topics["/pc"] == (rb.PC2_TYPE, 2)
        assert topics["/imu/data"] == (rb.IMU_TYPE, 3)
        got_pc, got_imu = [], []
        for _t, _topic, mtype, msg in rb.read_bag_messages(path):
            (got_imu if mtype == rb.IMU_TYPE else got_pc).append(msg)
        assert len(got_pc) == 2 and len(got_imu) == 3
        m = got_imu[1]
        assert abs(m.stamp - 0.15) < 1e-6
        np.testing.assert_allclose(m.rpy(), [0.0, 0.0, 0.6], atol=1e-9)
        np.testing.assert_allclose(m.lin_acc, [0.0, 0.0, 9.81])
        np.testing.assert_allclose(m.ang_vel, [0.0, 0.0, 0.5])
        np.testing.assert_allclose(got_imu[0].rpy(), [0.01, -0.02, 0.5], atol=1e-9)


# ---- PCD and frame IO (tests/test_io_runtime.py) on the port's copy ----

def test_pcd_roundtrip_python(tmp_path):
    pts = np.random.default_rng(0).uniform(-50, 50, (1234, 4)).astype(np.float32)
    p = str(tmp_path / "a.pcd")
    pio.write_pcd(p, pts)
    np.testing.assert_allclose(pio.read_pcd_py(p), pts, rtol=1e-6)


def test_pcd_ascii(tmp_path):
    pts = np.array([[1.5, 2.5, 3.5], [4, 5, 6]], np.float32)
    p = str(tmp_path / "a.pcd")
    pio.write_pcd(p, pts, binary=False)
    np.testing.assert_allclose(pio.read_pcd_py(p), pts, atol=1e-5)


def test_native_build_and_roundtrip(tmp_path):
    if not io_native.native_available():
        pytest.skip("native toolchain unavailable")
    assert io_native._lib_path().parent.name == "_build"
    pts = np.random.default_rng(1).uniform(-50, 50, (999, 4)).astype(np.float32)
    p = str(tmp_path / "n.pcd")
    assert io_native.native_write_pcd(p, pts)
    np.testing.assert_allclose(io_native.native_read_pcd(p), pts, rtol=1e-6)
    np.testing.assert_allclose(pio.read_pcd_py(p), pts, rtol=1e-6)


def test_frame_loader_prefetch(tmp_path):
    rng = np.random.default_rng(2)
    paths, truth = [], []
    for k in range(6):
        pts = rng.uniform(-10, 10, (100 + k, 4)).astype(np.float32)
        p = str(tmp_path / f"{k:03d}.bin")
        pts.tofile(p)
        paths.append(p)
        truth.append(pts)
    loader = io_native.FrameLoader(paths, n_threads=3, queue_cap=2)
    for k, frame in enumerate(loader):
        np.testing.assert_allclose(frame, truth[k], rtol=1e-6)
    loader.close()


def test_save_map(tmp_path):
    d = {"keyposes": np.tile(np.eye(4, dtype=np.float32), (3, 1, 1)),
         "corner": np.zeros((10, 3), np.float32),
         "surf": np.ones((20, 3), np.float32),
         "outlier": np.zeros((5, 3), np.float32)}
    pio.save_map(str(tmp_path / "map"), d)
    assert pio.read_pcd(str(tmp_path / "map" / "surf.pcd")).shape == (20, 3)
    assert pio.read_pcd(str(tmp_path / "map" / "keypose.pcd")).shape == (3, 4)


def test_tum_line_matches_reference():
    rng = np.random.default_rng(9)
    poses = [np.eye(4, dtype=np.float32)]
    for k in range(5):
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = synthetic._rpy_to_rot(rng.uniform(-3.1, 3.1, 3))
        T[:3, 3] = rng.uniform(-100, 100, 3)
        poses.append(T)
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = synthetic._rpy_to_rot(np.array([0.0, 0.0, np.pi]))
    poses.append(T)
    for k, T in enumerate(poses):
        assert tcli._tum_line(0.2 * k, T) == jcli._tum_line(0.2 * k, T)
