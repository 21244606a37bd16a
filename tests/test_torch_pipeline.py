"""The whole frame step of the port against the JAX reference.

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

The reference's neighbour searches run its Pallas kernels in interpret mode
(see test_torch_mapping), and its step is compiled once for the file.
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

from alego_tpu.models import pipeline as jpipe
from alego_tpu.utils import synthetic

from alego_tpu_torch.models import laser_mapping as tlm, pipeline as tpipe
from alego_tpu_torch.parallel import ranks
from alego_tpu_torch.parallel.distributed import DistributedSlamPipeline
from alego_tpu_torch.parallel.launch import launch

from test_torch_mapping import pallas_search
from test_torch_odometry import assert_pose_close

# one intra-op thread: the suite runs in several test processes at once,
# where more threads per process only contend for the cores
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def sequence(cfg, world):
    cfg = cfg.replace(loop_in_step=False)
    poses = synthetic.loop_trajectory(6, radius=20.0, speed=1.0, closed=False)
    pts, mask = synthetic.render_sequence(world, poses, cfg, noise=0.01)
    return cfg, poses, pts, mask


@pytest.fixture(scope="module")
def reference_run(sequence):
    """The reference's 6 frames from ``init_state``, compiled once: the
    poses, and the state (as numpy) before and after frame 4."""
    cfg, _, pts, mask = sequence
    with pytest.MonkeyPatch.context() as mp:
        pallas_search(mp)
        step = jax.jit(lambda st, p, m, t: jpipe.slam_step(st, p, m, t, cfg))
        st = jpipe.init_state(cfg)
        states, out = [], []
        for k in range(6):
            states.append(jax.tree_util.tree_map(np.asarray, st))
            st, pose = step(st, jnp.asarray(pts[k]), jnp.asarray(mask[k]),
                            jnp.float32(k * cfg.scan_period))
            out.append(np.asarray(pose))
    return states[4], states[5], np.stack(out)


def test_step_from_carried_state(sequence, reference_run):
    cfg, _, pts, mask = sequence
    st4, mj_state, est_j = reference_run
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
    est_j = reference_run[2]
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
    assert_pose_close(est_t, reference_run[2], t_tol=1e-3, r_tol=1e-4)
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
