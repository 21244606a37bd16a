"""One scan-to-scan odometry step of the port against the JAX reference from
the same state and the same feature clouds: pose translation within
1e-4 m, rotation within 1e-5 rad.

The reference's CPU path searches neighbours with the |q|^2-2q.r+|r|^2
expansion; the port computes the Pallas kernels' direct difference-squares.
To compare like with like the reference's 1-NN runs the Pallas kernel in
interpret mode, as the reference's own tests run it on the CPU.
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from alego_tpu.models import laser_odometry as jlo
from alego_tpu.models.image_projection import image_projection
from alego_tpu.ops import features as jfeat
from alego_tpu.ops.pallas_nn import nn1_pallas
from alego_tpu.utils import synthetic

from alego_tpu_torch.models import laser_odometry as tlo
from alego_tpu_torch.models.pipeline import tree_from_reference
from alego_tpu_torch.ops.features import FeatureClouds
from alego_tpu_torch.ops.se3 import rot_to_rpy

# one intra-op thread: the suite runs in several test processes at once,
# where more threads per process only contend for the cores
torch.set_num_threads(1)


def _nn1_interpret(q, qm, r, rm, chunk=None):
    return nn1_pallas(q, qm, r, rm, interpret=True)


def _to_torch(cls, tree):
    return tree_from_reference(cls, jax.tree_util.tree_map(np.asarray, tree), "cpu")


def assert_pose_close(T_port, T_ref, t_tol=1e-4, r_tol=1e-5):
    T_port = torch.as_tensor(np.array(T_port, np.float32))
    T_ref = torch.as_tensor(np.array(T_ref, np.float32))
    np.testing.assert_allclose(T_port[..., :3, 3], T_ref[..., :3, 3], rtol=0, atol=t_tol)
    d = (rot_to_rpy(T_port[..., :3, :3]) - rot_to_rpy(T_ref[..., :3, :3])).numpy()
    d = (d + np.pi) % (2 * np.pi) - np.pi
    assert np.abs(d).max() <= r_tol, np.abs(d).max()


@pytest.fixture(scope="module")
def frames(cfg, world):
    poses = synthetic.loop_trajectory(4, radius=20.0, speed=1.0, closed=False)
    pts, mask = synthetic.render_sequence(world, poses, cfg, noise=0.01)
    fe = jax.jit(lambda p, m: jfeat.extract_features(image_projection(p, m, cfg), cfg))
    return [fe(jnp.asarray(pts[k]), jnp.asarray(mask[k])) for k in range(4)]


def test_odometry_step_matches_reference(cfg, frames, monkeypatch):
    monkeypatch.setattr(jlo, "nn1", _nn1_interpret)
    step = jax.jit(functools.partial(jlo.odometry_step, cfg=cfg))
    st = jlo.init_state(cfg)
    for fc in frames[:3]:
        st, _ = step(st, fc)
    assert float(np.abs(np.asarray(st.params)).max()) > 0.1   # a real warm start

    st_t = _to_torch(tlo.OdometryState, st)
    fc_t = _to_torch(FeatureClouds, frames[3])
    st_j, pose_j = step(st, frames[3])
    st_t, pose_t = tlo.odometry_step(st_t, fc_t, cfg)

    assert_pose_close(pose_t, pose_j)
    np.testing.assert_allclose(st_t.params.numpy(), np.asarray(st_j.params),
                               rtol=0, atol=1e-4)
    assert bool(st_t.initialized)
    np.testing.assert_array_equal(st_t.surf_valid.numpy(), np.asarray(st_j.surf_valid))


def test_first_frame_keeps_identity(cfg, frames):
    st = tlo.init_state(cfg, "cpu")
    st, pose = tlo.odometry_step(st, _to_torch(FeatureClouds, frames[0]), cfg)
    assert torch.equal(pose, torch.eye(4))
    assert bool(st.initialized) and bool(st.surf_valid.any())
