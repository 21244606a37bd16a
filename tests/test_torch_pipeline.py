"""The whole frame step of the port against the JAX reference, and the
odometry and mapping steps inside it.

* one scan-to-scan odometry step from the same state and the same feature
  clouds (frame 3 of the sequence): pose translation within 1e-4 m,
  rotation within 1e-5 rad; the first frame keeps the identity;
* one scan-to-map mapping step from the same mapping state and inputs
  (frame 4, a mapping frame): pose within 1e-4 m / 1e-5 rad; the keyframe
  decision, count and written row equal; keyframe saves write in place;
* one step from a state carried across with ``state_from_reference``:
  poses within 1e-4 m / 1e-5 rad, keyframe count, ``map_dirty`` and the
  written keyframe row's valid masks equal;
* a 6-frame trajectory from ``init_state`` on both sides, within 1e-3 m /
  1e-4 rad: the recursive pipeline carries each frame's ulp-level
  differences into the next frame's warm start and map (bench.py:194-199);
  with ``loop_in_step=False`` (the hoisted attempt) and ``True`` (in the
  step, on the ``loop_every_n_frames`` cadence);
* the port imports neither jax nor alego_tpu, and its entry points refuse
  to fall back to the CPU silently.

The reference's CPU path searches neighbours with the |q|^2-2q.r+|r|^2
expansion; the port computes the Pallas kernels' direct difference-squares.
To compare like with like the reference's searches run its Pallas kernels
in interpret mode (``pallas_search``), as the reference's own tests run
them on the CPU.  One reference program serves every check: its frame step
compiled once for the file, returning each frame's features and odometry
pose beside the new state.
"""

import os
import subprocess
import sys
import warnings

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from alego_tpu.models import laser_mapping as jlm, laser_odometry as jlo, pipeline as jpipe
from alego_tpu.models.image_projection import image_projection as j_image_projection
from alego_tpu.ops import features as jfeat
from alego_tpu.ops.pallas_nn import knn_pallas, nn1_pallas
from alego_tpu.utils import synthetic

from alego_tpu_torch.models import laser_mapping as tlm, laser_odometry as tlo, pipeline as tpipe
from alego_tpu_torch.models.pipeline import tree_from_reference
from alego_tpu_torch.ops.features import FeatureClouds
from alego_tpu_torch.ops.se3 import rot_to_rpy
from alego_tpu_torch.parallel import ranks
from alego_tpu_torch.parallel.distributed import DistributedSlamPipeline
from alego_tpu_torch.parallel.launch import launch

# one intra-op thread: the suite runs in several test processes at once,
# where more threads per process only contend for the cores
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def pallas_search(monkeypatch):
    """Route the reference's neighbour searches through its Pallas kernels
    (interpret mode) — the function the port's kernels compute."""
    monkeypatch.setattr(jlo, "nn1", lambda q, qm, r, rm, chunk=None:
                        nn1_pallas(q, qm, r, rm, interpret=True))
    monkeypatch.setattr(jlm, "knn", lambda q, qm, r, rm, k, chunk=None:
                        knn_pallas(q, qm, r, rm, k=k, interpret=True))


def assert_pose_close(T_port, T_ref, t_tol=1e-4, r_tol=1e-5):
    T_port = torch.as_tensor(np.array(T_port, np.float32))
    T_ref = torch.as_tensor(np.array(T_ref, np.float32))
    np.testing.assert_allclose(T_port[..., :3, 3], T_ref[..., :3, 3], rtol=0, atol=t_tol)
    d = (rot_to_rpy(T_port[..., :3, :3]) - rot_to_rpy(T_ref[..., :3, :3])).numpy()
    d = (d + np.pi) % (2 * np.pi) - np.pi
    assert np.abs(d).max() <= r_tol, np.abs(d).max()


def _to_torch(cls, tree):
    return tree_from_reference(cls, jax.tree_util.tree_map(np.asarray, tree), "cpu")


@pytest.fixture(scope="module")
def sequence(cfg, world):
    cfg = cfg.replace(loop_in_step=False)
    poses = synthetic.loop_trajectory(6, radius=20.0, speed=1.0, closed=False)
    pts, mask = synthetic.render_sequence(world, poses, cfg, noise=0.01)
    return cfg, poses, pts, mask


@pytest.fixture(scope="module")
def reference_run(sequence):
    """The reference's 6 frames from ``init_state`` through one compiled
    program, the frame step, which also returns each frame's feature clouds
    and its mapping inputs (the odometry pose, the features and outliers
    that the step's mapping consumes).  As numpy: ``states[k]``, the state
    before frame k (``states[6]`` after the last), ``poses``, ``fc[k]`` and
    ``inputs[k]``.

    Which frame each check needs: the odometry check frame 3 (a warm start
    three frames deep) and the first-frame check frame 0; the mapping check
    and the carried step frame 4 (a mapping frame with two keyframes
    before it); the trajectories frames 0-5 (the in-step attempts fall on
    frames 0 and 5)."""
    cfg, _, pts, mask = sequence

    def step_and_inputs(st, p, m, t):
        seg = j_image_projection(p, m, cfg)
        fc = jfeat.extract_features(seg, cfg)
        _, T_odom = jlo.odometry_step(st.odo, fc, cfg)
        inputs = (T_odom, fc.less_sharp_pts, fc.less_sharp_valid, fc.less_flat_pts,
                  fc.less_flat_valid, seg.outlier_points, seg.outlier_valid, t)
        return jpipe.slam_step(st, p, m, t, cfg), fc, inputs

    with pytest.MonkeyPatch.context() as mp:
        pallas_search(mp)
        step = jax.jit(step_and_inputs)
        st = jpipe.init_state(cfg)
        states, poses, fcs, inputs = [], [], [], []
        for k in range(6):
            states.append(jax.tree_util.tree_map(np.asarray, st))
            (st, pose), fc, args = step(st, jnp.asarray(pts[k]), jnp.asarray(mask[k]),
                                        jnp.float32(k * cfg.scan_period))
            poses.append(np.asarray(pose))
            fcs.append(jax.tree_util.tree_map(np.asarray, fc))
            inputs.append([np.asarray(a) for a in args])
        states.append(jax.tree_util.tree_map(np.asarray, st))
    return dict(states=states, poses=np.stack(poses), fc=fcs, inputs=inputs)


def test_odometry_step_matches_reference(sequence, reference_run):
    cfg = sequence[0]
    st = reference_run["states"][3].odo
    assert float(np.abs(st.params).max()) > 0.1   # a real warm start

    st_t = _to_torch(tlo.OdometryState, st)
    fc_t = _to_torch(FeatureClouds, reference_run["fc"][3])
    st_j, pose_j = reference_run["states"][4].odo, reference_run["inputs"][3][0]
    st_t, pose_t = tlo.odometry_step(st_t, fc_t, cfg)

    assert_pose_close(pose_t, pose_j)
    np.testing.assert_allclose(st_t.params.numpy(), st_j.params, rtol=0, atol=1e-4)
    assert bool(st_t.initialized)
    np.testing.assert_array_equal(st_t.surf_valid.numpy(), st_j.surf_valid)


def test_first_frame_keeps_identity(sequence, reference_run):
    cfg = sequence[0]
    st = tlo.init_state(cfg, "cpu")
    st, pose = tlo.odometry_step(st, _to_torch(FeatureClouds, reference_run["fc"][0]), cfg)
    assert torch.equal(pose, torch.eye(4))
    assert bool(st.initialized) and bool(st.surf_valid.any())


def test_mapping_step_matches_reference(sequence, reference_run):
    """The reference's mapping step is the one inside its frame step: frame
    4 maps, from the mapping state before it, on that frame's inputs."""
    cfg = sequence[0]
    st = reference_run["states"][4]
    assert int(st.mapping.graph.count) >= 2

    ms_t = tree_from_reference(tlm.MappingState, st.mapping, "cpu")
    ms_j = reference_run["states"][5].mapping
    T_j = ms_j.T_map2laser
    ms_t, T_t = tlm.mapping_step(ms_t, *(torch.from_numpy(np.array(a))
                                         for a in reference_run["inputs"][4]), cfg)

    assert_pose_close(T_t, T_j)
    count = int(ms_j.graph.count)
    assert int(ms_t.graph.count) == count
    assert bool(ms_t.map_dirty) == bool(ms_j.map_dirty)
    row = count - 1
    for name in ("kf_corner_valid", "kf_surf_valid", "kf_outlier_valid"):
        np.testing.assert_array_equal(getattr(ms_t, name)[row].numpy(),
                                      getattr(ms_j, name)[row], err_msg=name)
    np.testing.assert_allclose(ms_t.kf_surf[row].numpy(), ms_j.kf_surf[row],
                               rtol=0, atol=1e-3 * cfg.surf_leaf)
    # the local map the step used was rebuilt from the same keyframes
    np.testing.assert_array_equal(ms_t.map_surf_valid.numpy(), ms_j.map_surf_valid)


def test_keyframe_saves_write_in_place(cfg):
    """The keyframe store is written in place: no copy of the ~MiB arrays."""
    cfg = cfg.replace(loop_in_step=False)
    ms = tlm.init_state(cfg, "cpu")
    ptr = ms.kf_surf.data_ptr()
    rng = np.random.default_rng(0)
    pts = torch.from_numpy(rng.uniform(-20, 20, (cfg.max_less_flat, 3)).astype(np.float32))
    ok = torch.ones(cfg.max_less_flat, dtype=torch.bool)
    c = torch.zeros((cfg.max_less_sharp, 3))
    cok = torch.zeros(cfg.max_less_sharp, dtype=torch.bool)
    o = torch.zeros((cfg.max_outlier, 3))
    ook = torch.zeros(cfg.max_outlier, dtype=torch.bool)
    ms, T = tlm.mapping_step(ms, torch.eye(4), c, cok, pts, ok, o, ook,
                             torch.tensor(0.0), cfg)
    assert ms.kf_surf.data_ptr() == ptr
    assert int(ms.graph.count) == 1 and bool(ms.map_dirty)
    assert bool(ms.kf_surf_valid[0].any()) and not bool(ms.kf_surf_valid[1].any())
    assert torch.equal(T, torch.eye(4))


def test_step_from_carried_state(sequence, reference_run):
    cfg, _, pts, mask = sequence
    st4, mj_state = reference_run["states"][4], reference_run["states"][5]
    est_j = reference_run["poses"]
    st_t = tpipe.state_from_reference(st4, "cpu", cfg)
    assert int(st_t.frame) == 4

    st_t, pose_t = tpipe.slam_step(st_t, torch.from_numpy(pts[4]), torch.from_numpy(mask[4]),
                                   torch.tensor(0.8), cfg)
    assert_pose_close(pose_t, est_j[4])
    assert_pose_close(st_t.T_odom2laser, mj_state.T_odom2laser)
    mj, mt = mj_state.mapping, st_t.mapping
    count = int(mj.graph.count)
    assert int(mt.graph.count) == count and count >= 3
    assert bool(mt.map_dirty) == bool(mj.map_dirty)
    for name in ("kf_corner_valid", "kf_surf_valid", "kf_outlier_valid"):
        np.testing.assert_array_equal(getattr(mt, name)[count - 1].numpy(),
                                      getattr(mj, name)[count - 1], err_msg=name)
    assert int(st_t.frame) == 5


def test_six_frame_trajectory(sequence, reference_run):
    cfg, gt, pts, mask = sequence
    est_j = reference_run["poses"]
    pipe = tpipe.SlamPipeline(cfg, device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("error")     # the loop attempts run, unannounced
        est_t = pipe.run(pts, mask)
    assert est_t.shape == (6, 4, 4) and np.isfinite(est_t).all()
    assert_pose_close(est_t, est_j, t_tol=1e-3, r_tol=1e-4)
    assert np.abs(est_t[:, :3, 3] - gt[:, :3, 3]).max() < 0.5
    assert pipe._loop_live and int(pipe.state.mapping.loop_attempts) == 0
    m = pipe.export_map()
    assert len(m["keyposes"]) == int(pipe.state.mapping.graph.count) >= 3
    assert m["surf"].shape[1] == 3 and len(m["surf"]) > 100


def test_in_step_loop_cadence(sequence, reference_run, monkeypatch):
    """``loop_in_step=True`` (the config default): the step calls the loop
    attempt on frames 0 and 5 of 6; no candidate can pass the 30 s age gate
    in 1.2 s, so the trajectory is the reference's hoisted-mode one."""
    cfg, _, pts, mask = sequence
    calls = []
    real = tlm.loop_closure_step

    def counted(ms, c, **kw):
        calls.append(int(pipe._frame))
        return real(ms, c, **kw)

    monkeypatch.setattr(tlm, "loop_closure_step", counted)
    pipe = tpipe.SlamPipeline(cfg.replace(loop_in_step=True), device="cpu")
    est_t = pipe.run(pts, mask)
    assert calls == [0, 5]
    assert_pose_close(est_t, reference_run["poses"], t_tol=1e-3, r_tol=1e-4)
    assert int(pipe.state.mapping.loop_attempts) == 0


def test_state_from_reference_checks_layout(cfg):
    cfg = cfg.replace(loop_in_step=False)
    tree = jax.tree_util.tree_map(np.asarray, jpipe.init_state(cfg))
    state = tpipe.state_from_reference(tree, "cpu", cfg)
    assert state.mapping.kf_surf.shape == (cfg.max_keyframes, cfg.kf_surf_cap, 3)
    bad = tree._replace(frame=np.zeros(3, np.int32))
    with pytest.raises(ValueError, match="frame"):
        tpipe.state_from_reference(bad, "cpu", cfg)
    with pytest.raises(ValueError, match="float64"):
        tpipe.state_from_reference(tree._replace(T_odom2laser=np.eye(4)), "cpu")


def test_port_imports_no_reference():
    code = (
        "import sys\n"
        "for m in [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'alego_tpu')]:\n"
        "    del sys.modules[m]\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'jaxlib', 'alego_tpu'):\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "import alego_tpu_torch.models.pipeline, alego_tpu_torch.utils.synthetic\n"
        "import alego_tpu_torch.utils.metrics, alego_tpu_torch.ops.icp\n"
        "import alego_tpu_torch.ops.bev_align, alego_tpu_torch.ops.chain_solver\n"
        "import alego_tpu_torch.models.pose_graph, alego_tpu_torch.models.laser_mapping\n"
        "import alego_tpu_torch.cli, alego_tpu_torch.utils.rosbag, alego_tpu_torch.utils.io\n"
        "import alego_tpu_torch.utils.viewer, alego_tpu_torch.utils.profiling\n"
        "import alego_tpu_torch.runtime.io_native, alego_tpu_torch.ops.deskew\n"
        "import alego_tpu_torch.utils.sensor_sim, alego_tpu_torch.parallel.comm\n"
        "import alego_tpu_torch.parallel.launch, alego_tpu_torch.parallel.map_shard\n"
        "import alego_tpu_torch.parallel.schur, alego_tpu_torch.parallel.sharded_mapping\n"
        "import alego_tpu_torch.parallel.multichip, alego_tpu_torch.parallel.distributed\n"
        "import alego_tpu_torch.parallel.ranks\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'alego_tpu')]\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0 and "clean" in out.stdout, out.stderr


def test_no_silent_cpu(cfg, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = cfg.replace(loop_in_step=False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tpipe.SlamPipeline(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tpipe.init_state(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DistributedSlamPipeline(cfg, device="cuda")
    # a card but fewer than the ranks asked for over NCCL: the launcher of
    # the pipeline's ranks refuses before it starts them
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="4 ranks over NCCL need 4 cards, but only 1"):
        launch(ranks.distributed_run, 4, cfg, "frames", device="cuda")
