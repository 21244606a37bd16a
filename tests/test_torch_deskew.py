"""The port's IMU integration, de-skew and quaternion ops against the JAX
reference on the same numpy-seeded streams.

* ``integrate_imu``, ``integrate_imu_chunk`` and ``integrate_odom`` through
  a ring wrap (Q = 16, 40 samples): ``count`` and the ring's times equal,
  rpy/velocity/shift within 1e-5 relative;
* ``deskew`` on the same buffer (the reference's, carried across), within
  1e-5 m: with and without ``orient_start``/``orient_diff``, before and
  after a ring wrap, with yaw crossing ±π inside the sweep; fewer than 2
  samples pass the points through bit for bit, and invalid points are
  never moved;
* ``rot_to_quat`` within 1e-6 (sign fixed: q and -q are one rotation) on
  random rotations, near 180° about each axis and on the identity;
  ``quat_to_rot`` within 1e-6.

The reference's functions are jitted once each for the file.
"""

import math

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from alego_tpu.ops import deskew as jdk, se3 as jse3

from alego_tpu_torch.models.pipeline import tree_from_reference
from alego_tpu_torch.ops import deskew as tdk, se3 as tse3

# one intra-op thread: the suite runs in several test processes at once,
# where more threads per process only contend for the cores
torch.set_num_threads(1)

HZ = 40
N_SAMPLES = 40
N_POINTS = 600
SCAN_TIME = 0.7          # the sweep [0.7, 0.8] s holds yaw's crossing of +pi

j_imu = jax.jit(jdk.integrate_imu)
j_chunk = jax.jit(jdk.integrate_imu_chunk)
j_odom = jax.jit(jdk.integrate_odom)
j_deskew = jax.jit(jdk.deskew, static_argnames="cfg")
j_quat = jax.jit(jse3.rot_to_quat)
j_rot = jax.jit(jse3.quat_to_rot)


def _wrap(a):
    return (a + np.pi) % (2 * np.pi) - np.pi


def _stream(seed=0):
    """A 40 Hz IMU stream: yaw wrapped to (-pi, pi] as a quaternion source
    gives it, crossing +pi at t = 0.75 s, small roll and pitch, body-frame
    specific force with gravity."""
    rng = np.random.default_rng(seed)
    t = np.arange(N_SAMPLES) / HZ
    rpy = np.stack([0.02 * np.sin(3 * t), -0.03 * np.cos(2 * t),
                    _wrap(np.pi - 0.1 + 1.0 * (t - 0.65))], -1)
    acc = rng.normal(0, 0.3, (N_SAMPLES, 3)) + [0.5, 0.0, jdk.GRAVITY]
    return (t.astype(np.float32), rpy.astype(np.float32), acc.astype(np.float32))


def _to_torch_buf(buf):
    return tree_from_reference(tdk.ImuBuffer, jax.tree_util.tree_map(np.asarray, buf), "cpu")


def _assert_buf_close(tb, jb):
    assert int(tb.count) == int(jb.count)
    np.testing.assert_array_equal(tb.times.numpy(), np.asarray(jb.times))
    for name in ("rpy", "velo", "shift"):
        want = np.asarray(getattr(jb, name))
        np.testing.assert_allclose(getattr(tb, name).numpy(), want, rtol=1e-5,
                                   atol=1e-5 * max(1.0, np.abs(want).max()), err_msg=name)


@pytest.fixture(scope="module")
def buffers():
    """The reference's buffers after the whole stream, Q = 64 (no wrap) and
    Q = 16 (wrapped), and after a single sample."""
    t, rpy, acc = _stream()
    out = {}
    for Q in (64, 16):
        jb = jdk.init_buffer(Q)
        for i in range(N_SAMPLES):
            jb = j_imu(jb, jnp.float32(t[i]), jnp.asarray(rpy[i]), jnp.asarray(acc[i]))
        out[Q] = jb
    out[1] = j_imu(jdk.init_buffer(64), jnp.float32(t[0]), jnp.asarray(rpy[0]),
                   jnp.asarray(acc[0]))
    return out


def test_integrate_imu_through_ring_wrap(buffers):
    t, rpy, acc = _stream()
    tb = tdk.init_buffer(16, "cpu")
    for i in range(N_SAMPLES):
        tb = tdk.integrate_imu(tb, torch.tensor(t[i]), torch.from_numpy(rpy[i]),
                               torch.from_numpy(acc[i]))
    _assert_buf_close(tb, buffers[16])
    assert int(tb.count) == N_SAMPLES


def test_integrate_imu_chunk(buffers):
    """The chunked flush: the reference's fixed-size chunk with a masked
    tail, the port's loop over the real samples; two chunks of 24 + 16."""
    t, rpy, acc = _stream()
    C = 32
    jb, tb = jdk.init_buffer(16), tdk.init_buffer(16, "cpu")
    for lo, hi in ((0, 24), (24, N_SAMPLES)):
        n = hi - lo
        ts = np.full(C, 1e18, np.float32)
        rs, acs = np.zeros((C, 3), np.float32), np.zeros((C, 3), np.float32)
        ts[:n], rs[:n], acs[:n] = t[lo:hi], rpy[lo:hi], acc[lo:hi]
        jb = j_chunk(jb, jnp.asarray(ts), jnp.asarray(rs), jnp.asarray(acs), jnp.int32(n))
        tb = tdk.integrate_imu_chunk(tb, torch.from_numpy(t[lo:hi]), torch.from_numpy(rpy[lo:hi]),
                                     torch.from_numpy(acc[lo:hi]), n)
    _assert_buf_close(tb, jb)
    _assert_buf_close(tb, buffers[16])


def test_integrate_odom_through_ring_wrap():
    rng = np.random.default_rng(1)
    jb, tb = jdk.init_buffer(16), tdk.init_buffer(16, "cpu")
    for i in range(N_SAMPLES):
        t = np.float32(i / HZ)
        rpy, pos, velo = (rng.normal(size=3).astype(np.float32) for _ in range(3))
        jb = j_odom(jb, jnp.float32(t), jnp.asarray(rpy), jnp.asarray(pos), jnp.asarray(velo))
        tb = tdk.integrate_odom(tb, torch.tensor(t), torch.from_numpy(rpy),
                                torch.from_numpy(pos), torch.from_numpy(velo))
    for name in jdk.ImuBuffer._fields:
        np.testing.assert_array_equal(getattr(tb, name).numpy(), np.asarray(getattr(jb, name)),
                                      err_msg=name)


def _points(cfg, seed=2):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-12, 12, (N_POINTS, 3)).astype(np.float32)
    cols = rng.integers(0, cfg.horizon_scan, N_POINTS).astype(np.int32)
    valid = rng.random(N_POINTS) < 0.8
    return pts, cols, valid


@pytest.mark.parametrize("Q", [64, 16])
@pytest.mark.parametrize("orient", [False, True])
def test_deskew_matches_reference(cfg, buffers, Q, orient):
    pts, cols, valid = _points(cfg)
    jb = buffers[Q]
    kw_j, kw_t = {}, {}
    if orient:
        # the sweep starts in column 37 and spans 6.1 rad
        o_s, o_d = np.float32(37.4 * cfg.ang_res_x), np.float32(6.1)
        kw_j = dict(orient_start=jnp.float32(o_s), orient_diff=jnp.float32(o_d))
        kw_t = dict(orient_start=torch.tensor(o_s), orient_diff=torch.tensor(o_d))
    want = np.asarray(j_deskew(jnp.asarray(pts), jnp.asarray(cols), jnp.asarray(valid),
                               jnp.float32(SCAN_TIME), jb, cfg=cfg, **kw_j))
    got = tdk.deskew(torch.from_numpy(pts), torch.from_numpy(cols), torch.from_numpy(valid),
                     torch.tensor(SCAN_TIME, dtype=torch.float32), _to_torch_buf(jb), cfg,
                     **kw_t).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    # invalid points untouched; valid ones moved (the sweep yaws ~0.1 rad)
    np.testing.assert_array_equal(got[~valid], pts[~valid])
    assert np.abs(got[valid] - pts[valid]).max() > 0.1


def test_deskew_yaw_wrap_is_shortest_arc(buffers):
    """The interpolated yaw across the +pi -> -pi wrap stays near pi (a
    plain blend would swing through 0)."""
    jb = buffers[64]
    t = torch.tensor([0.74, 0.75, 0.76], dtype=torch.float32)
    rpy, _, _ = tdk._interp(_to_torch_buf(jb), t)
    assert (np.abs(np.abs(rpy[:, 2].numpy()) - np.pi) < 0.02).all()
    want = np.asarray(jdk._interp(jb, jnp.asarray(t.numpy()))[0])
    np.testing.assert_allclose(rpy.numpy(), want, rtol=0, atol=1e-6)


def test_deskew_needs_two_samples(cfg, buffers):
    pts, cols, valid = _points(cfg, seed=3)
    for jb in (jdk.init_buffer(64), buffers[1]):
        got = tdk.deskew(torch.from_numpy(pts), torch.from_numpy(cols), torch.from_numpy(valid),
                         torch.tensor(SCAN_TIME), _to_torch_buf(jb), cfg).numpy()
        assert got.tobytes() == pts.tobytes()
        want = np.asarray(j_deskew(jnp.asarray(pts), jnp.asarray(cols), jnp.asarray(valid),
                                   jnp.float32(SCAN_TIME), jb, cfg=cfg))
        np.testing.assert_array_equal(got, want)


def _rotations():
    rng = np.random.default_rng(5)
    q = rng.normal(size=(64, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    Rs = list(np.asarray(jse3.quat_to_rot(jnp.asarray(q, jnp.float32))))
    for axis in np.eye(3):
        for ang in (np.pi, np.pi - 1e-3, -(np.pi - 1e-2)):
            K = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]],
                          [-axis[1], axis[0], 0]])
            Rs.append(np.eye(3) + math.sin(ang) * K + (1 - math.cos(ang)) * K @ K)
    Rs.append(np.eye(3))
    return np.stack(Rs).astype(np.float32)


def test_rot_to_quat_matches_reference():
    Rs = _rotations()
    want = np.array(j_quat(jnp.asarray(Rs)))
    got = tse3.rot_to_quat(torch.from_numpy(Rs)).numpy()
    sign = np.where(np.sum(got * want, -1, keepdims=True) < 0, -1.0, 1.0)
    np.testing.assert_allclose(got * sign, want, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got[-1], [1, 0, 0, 0])
    back = tse3.quat_to_rot(torch.from_numpy(want)).numpy()
    np.testing.assert_allclose(back, np.asarray(j_rot(jnp.asarray(want))), rtol=0, atol=1e-6)
