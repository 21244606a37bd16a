"""One scan-to-map mapping step of the port against the JAX reference from
the same mapping state and inputs: pose translation within 1e-4 m, rotation
within 1e-5 rad; the keyframe decision, count and written row equal.  The
reference's mapping step is the one inside its frame step (frame 4 maps),
so one program is compiled.

As in test_torch_odometry, the reference's neighbour searches run its
Pallas kernels in interpret mode (the port computes their function).
"""

import numpy as np
import jax
import jax.numpy as jnp
import torch

from alego_tpu.models import laser_mapping as jlm, laser_odometry as jlo, pipeline as jpipe
from alego_tpu.models.image_projection import image_projection
from alego_tpu.ops import features as jfeat
from alego_tpu.ops.pallas_nn import knn_pallas, nn1_pallas
from alego_tpu.utils import synthetic

from alego_tpu_torch.models import laser_mapping as tlm
from alego_tpu_torch.models.pipeline import tree_from_reference

from test_torch_odometry import assert_pose_close

# one intra-op thread: the suite runs in several test processes at once,
# where more threads per process only contend for the cores
torch.set_num_threads(1)


def pallas_search(monkeypatch):
    """Route the reference's neighbour searches through its Pallas kernels
    (interpret mode) — the function the port's kernels compute."""
    monkeypatch.setattr(jlo, "nn1", lambda q, qm, r, rm, chunk=None:
                        nn1_pallas(q, qm, r, rm, interpret=True))
    monkeypatch.setattr(jlm, "knn", lambda q, qm, r, rm, k, chunk=None:
                        knn_pallas(q, qm, r, rm, k=k, interpret=True))


def test_mapping_step_matches_reference(cfg, world, monkeypatch):
    pallas_search(monkeypatch)
    cfg = cfg.replace(loop_in_step=False)
    poses = synthetic.loop_trajectory(6, radius=20.0, speed=1.0, closed=False)
    pts, mask = synthetic.render_sequence(world, poses, cfg, noise=0.01)
    def step_and_inputs(st, p, m, t):
        """One frame of the reference, and that frame's mapping inputs."""
        seg = image_projection(p, m, cfg)
        fc = jfeat.extract_features(seg, cfg)
        _, T_odom = jlo.odometry_step(st.odo, fc, cfg)
        inputs = (T_odom, fc.less_sharp_pts, fc.less_sharp_valid, fc.less_flat_pts,
                  fc.less_flat_valid, seg.outlier_points, seg.outlier_valid, t)
        return jpipe.slam_step(st, p, m, t, cfg)[0], inputs

    # one compile of the step: frames 0-3 advance the state; frame 4 (a
    # mapping frame) gives its mapping inputs and, in the state it returns,
    # the reference's mapping_step on them
    step = jax.jit(step_and_inputs)
    st = jpipe.init_state(cfg)
    for k in range(5):
        st_next, inputs = step(st, jnp.asarray(pts[k]), jnp.asarray(mask[k]),
                               jnp.float32(0.2 * k))
        if k < 4:
            st = st_next
    assert int(st.mapping.graph.count) >= 2

    ms_t = tree_from_reference(tlm.MappingState,
                               jax.tree_util.tree_map(np.asarray, st.mapping), "cpu")
    ms_j = st_next.mapping
    T_j = ms_j.T_map2laser
    ms_t, T_t = tlm.mapping_step(ms_t, *(torch.from_numpy(np.array(a)) for a in inputs), cfg)

    assert_pose_close(T_t, T_j)
    count = int(ms_j.graph.count)
    assert int(ms_t.graph.count) == count
    assert bool(ms_t.map_dirty) == bool(ms_j.map_dirty)
    row = count - 1
    for name in ("kf_corner_valid", "kf_surf_valid", "kf_outlier_valid"):
        np.testing.assert_array_equal(getattr(ms_t, name)[row].numpy(),
                                      np.asarray(getattr(ms_j, name))[row], err_msg=name)
    np.testing.assert_allclose(ms_t.kf_surf[row].numpy(), np.asarray(ms_j.kf_surf)[row],
                               rtol=0, atol=1e-3 * cfg.surf_leaf)
    # the local map the step used was rebuilt from the same keyframes
    np.testing.assert_array_equal(ms_t.map_surf_valid.numpy(),
                                  np.asarray(ms_j.map_surf_valid))


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
