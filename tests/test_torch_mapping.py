"""One scan-to-map mapping step of the port against the JAX reference from
the same mapping state and inputs: pose translation within 1e-4 m, rotation
within 1e-5 rad; the keyframe decision, count and written row equal.

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
    step = jax.jit(lambda st, p, m, t: jpipe.slam_step(st, p, m, t, cfg))
    st = jpipe.init_state(cfg)
    for k in range(4):
        st, _ = step(st, jnp.asarray(pts[k]), jnp.asarray(mask[k]), jnp.float32(0.2 * k))
    assert int(st.mapping.graph.count) >= 2

    # frame 4's mapping inputs, computed once by the reference
    seg = jax.jit(lambda p, m: image_projection(p, m, cfg))(jnp.asarray(pts[4]),
                                                           jnp.asarray(mask[4]))
    fc = jax.jit(lambda s: jfeat.extract_features(s, cfg))(seg)
    _, T_odom = jax.jit(lambda o, f: jlo.odometry_step(o, f, cfg))(st.odo, fc)
    inputs = (T_odom, fc.less_sharp_pts, fc.less_sharp_valid, fc.less_flat_pts,
              fc.less_flat_valid, seg.outlier_points, seg.outlier_valid,
              jnp.float32(0.8))

    ms_t = tree_from_reference(tlm.MappingState,
                               jax.tree_util.tree_map(np.asarray, st.mapping), "cpu")
    ms_j, T_j = jax.jit(lambda ms, *a: jlm.mapping_step(ms, *a, cfg))(st.mapping, *inputs)
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
