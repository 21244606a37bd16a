"""Loop closure of the port against the JAX reference, from the same
mapping state carried across with ``tree_from_reference``: the keyframe
ring of tests/test_sharded_mapping.py whose latest keyframe revisits
keyframe 0.

Three cases: the identity-initialised attempt closes; the latest keyframe
yawed by 75 degrees closes only through the bird's-eye-view rescue; the
same with ``loop_coarse_align=False`` is rejected.  In each, ``closed``,
``loop_count``, ``loop_i``/``loop_j`` and the attempt counters are equal;
fitness within 1e-5 relative or 1e-9 m^2 (a converged fitness of ~1e-5 m^2
moves by ~1e-10 with the transform's f32 rounding), poses within 1e-4 m /
1e-5 rad.  The bird's-eye-view alignment of the yawed case finds the same
(yaw, shift) peak, not merely a close one.  The host
loop's hoisted attempt (``SlamPipeline._maybe_loop``) fires on the
cadence boundary and equals the reference's attempt; ``_maybe_compact``
fires ``16`` keyframes before capacity.

The reference's searches run its Pallas kernels in interpret mode (the
functions the port's kernels compute), and each reference program is
compiled once per configuration.
"""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from alego_tpu.config import tiny_config
from alego_tpu.models import laser_mapping as jlm
from alego_tpu.ops import bev_align as jbev, icp as jicp
from alego_tpu.ops.pallas_nn import knn_pallas, nn1_pallas

from alego_tpu_torch.models import laser_mapping as tlm, pipeline as tpipe
from alego_tpu_torch.models.pipeline import tree_from_reference
from alego_tpu_torch.ops import bev_align as tbev, icp as ticp

from test_sharded_mapping import _loop_ready_state

# one intra-op thread: the suite runs in several test processes at once,
# where more threads per process only contend for the cores
torch.set_num_threads(1)

BASE = dict(max_keyframes=64, loop_time_gap=30.0, history_search_num=3,
            history_fitness_score=0.1, icp_iters=40)


def _yawed(ms, deg):
    """The latest keyframe's pose turned by ``deg`` about z (map frame)."""
    latest = int(ms.graph.count) - 1
    yaw = np.radians(deg)
    Tz = np.eye(4, dtype=np.float32)
    Tz[:2, :2] = [[np.cos(yaw), -np.sin(yaw)], [np.sin(yaw), np.cos(yaw)]]
    T = (Tz @ np.asarray(ms.graph.poses[latest])).astype(np.float32)
    return ms._replace(graph=ms.graph._replace(
        poses=ms.graph.poses.at[latest].set(jnp.asarray(T))))


@pytest.fixture(scope="module")
def scenes():
    """Each case's configuration, input state and the reference's
    (state, closed, fitness) as numpy trees."""
    cfg = tiny_config(**BASE, loop_coarse_align=True)
    cfg_identity_only = tiny_config(**BASE, loop_coarse_align=False)
    # the scene made by one traced program (bit-equal to the eager calls,
    # and a fifth of their time)
    ms = jax.jit(_loop_ready_state, static_argnums=0)(cfg)
    cases = {"identity": (cfg, ms), "rescue": (cfg, _yawed(ms, 75.0)),
             "no_rescue": (cfg_identity_only, _yawed(ms, 75.0))}
    out = {}
    with pytest.MonkeyPatch.context() as mp, ThreadPoolExecutor(2) as pool:
        mp.setattr(jicp, "_nn1", lambda q, qm, r, rm, chunk=None:
                   nn1_pallas(q, qm, r, rm, interpret=True))
        mp.setattr(jlm, "knn", lambda q, qm, r, rm, k, chunk=None:
                   knn_pallas(q, qm, r, rm, k=k, interpret=True))
        # one program per configuration: each is traced here (which holds
        # the interpreter) and compiled on a worker thread (which does not),
        # so the second trace overlaps the first compile
        steps = {}
        for c, m in cases.values():
            if c not in steps:
                lowered = jax.jit(lambda m, c=c: jlm.loop_closure_step(m, c)).lower(m)
                steps[c] = pool.submit(lowered.compile)
        for name, (c, m) in cases.items():
            ref = jax.tree_util.tree_map(np.asarray, steps[c].result()(m))
            out[name] = (c, jax.tree_util.tree_map(np.asarray, m), ref)
    return out


def assert_loop_state_equal(ms_t, ms_j, t_tol=1e-4, r_tol=1e-5):
    g_t, g_j = ms_t.graph, ms_j.graph
    for name in ("count", "loop_count", "loop_i", "loop_j", "loop_overflow"):
        np.testing.assert_array_equal(getattr(g_t, name).numpy(), getattr(g_j, name),
                                      err_msg=name)
    for name in ("last_loop_kf", "loop_attempts", "map_dirty"):
        np.testing.assert_array_equal(getattr(ms_t, name).numpy(), getattr(ms_j, name),
                                      err_msg=name)
    np.testing.assert_allclose(ms_t.loop_best_fitness.numpy(), ms_j.loop_best_fitness,
                               rtol=1e-5, atol=1e-9)
    np.testing.assert_allclose(ms_t.loop_best_inlier.numpy(), ms_j.loop_best_inlier,
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(g_t.loop_w.numpy(), g_j.loop_w, rtol=1e-5)
    n = int(g_j.count)
    for got, want in ((g_t.poses[:n], g_j.poses[:n]), (ms_t.T_map2odom, ms_j.T_map2odom),
                      (ms_t.T_map2laser, ms_j.T_map2laser), (g_t.loop_rel, g_j.loop_rel)):
        got = got.numpy()
        np.testing.assert_allclose(got[..., :3, 3], want[..., :3, 3], rtol=0, atol=t_tol)
        np.testing.assert_allclose(got[..., :3, :3], want[..., :3, :3], rtol=0, atol=r_tol)


@pytest.mark.parametrize("case", ["identity", "rescue", "no_rescue"])
def test_loop_closure_step_matches_reference(scenes, case, monkeypatch):
    cfg, ms_in, (ms_j, closed_j, fit_j) = scenes[case]
    ms_t = tree_from_reference(tlm.MappingState, ms_in, "cpu")
    ms_t, closed_t, fit_t = tlm.loop_closure_step(ms_t, cfg)
    assert bool(closed_t) == bool(closed_j) == (case != "no_rescue")
    np.testing.assert_allclose(float(fit_t), float(fit_j), rtol=1e-5, atol=1e-9)
    assert_loop_state_equal(ms_t, ms_j)
    if case == "rescue":   # the identity attempt alone fails on this scene
        _, _, (_, closed_1, fit_1) = scenes["no_rescue"]
        assert not bool(closed_1) and float(fit_t) < float(fit_1)
    # a second call against the same latest keyframe is gated off: no
    # search runs (so no kernel would launch) and nothing changes
    searches = []
    monkeypatch.setattr(ticp, "_nn1", lambda *a: searches.append("nn1"))
    monkeypatch.setattr(tlm, "knn", lambda *a: searches.append("knn"))
    again, closed2, fit2 = tlm.loop_closure_step(ms_t, cfg)
    assert again is ms_t and not bool(closed2) and float(fit2) == 1e9
    assert not searches


def test_hoisted_loop_fires_on_the_cadence(scenes):
    """``SlamPipeline._maybe_loop`` with ``loop_in_step=False``: nothing
    between cadence boundaries, one attempt on crossing one, equal to the
    reference's ``loop_closure_step`` from the same state."""
    cfg, ms_in, (ms_j, _, _) = scenes["identity"]
    cfg = cfg.replace(loop_in_step=False)
    pipe = tpipe.SlamPipeline(cfg, device="cpu")
    ms_t = tree_from_reference(tlm.MappingState, ms_in, "cpu")
    pipe.state = pipe.state._replace(mapping=ms_t)
    n = cfg.loop_every_n_frames
    pipe._frame = 2 * n - 1
    pipe._maybe_loop(1)                      # frames 2n-2 -> 2n-1: no boundary
    assert pipe.state.mapping is ms_t and not pipe._loop_live
    pipe._frame = 2 * n
    pipe._maybe_loop(1)                      # crosses 2n: one attempt
    assert pipe._loop_live
    assert_loop_state_equal(pipe.state.mapping, ms_j)
    # a dispatch spanning several boundaries still makes one attempt, and
    # this one is gated off (the same latest keyframe)
    pipe._frame = 5 * n
    before = pipe.state.mapping
    pipe._maybe_loop(3 * n)
    assert pipe.state.mapping is before
    assert int(before.loop_attempts) == 1


def test_compaction_fires_before_capacity(scenes):
    """``_maybe_compact`` thins the keyframes once the graph holds
    ``max_keyframes - 16`` of them, and not one keyframe earlier."""
    cfg = scenes["identity"][0].replace(loop_in_step=False, recent_keyframe_search_num=8)
    pipe = tpipe.SlamPipeline(cfg, device="cpu")
    ms = pipe.state.mapping
    for count, fired in ((cfg.max_keyframes - 17, False), (cfg.max_keyframes - 16, True)):
        g = ms.graph._replace(count=torch.tensor(count, dtype=torch.int32))
        pipe.state = pipe.state._replace(mapping=ms._replace(graph=g))
        pipe.compactions = 0
        pipe._maybe_compact()
        assert pipe.compactions == int(fired)
        new = int(pipe.state.mapping.graph.count)
        if fired:
            assert cfg.recent_keyframe_search_num <= new < count
            assert bool(pipe.state.mapping.map_dirty)
        else:
            assert new == count


def test_bev_align_matches_reference(scenes):
    """The rescue's coarse alignment on the yawed revisit: the latest
    keyframe's map-frame cloud against keyframe 0's."""
    cfg, ms, _ = scenes["rescue"]
    poses = ms.graph.poses
    src = (ms.kf_surf[11] @ poses[11][:3, :3].T + poses[11][:3, 3]).astype(np.float32)
    tgt = (ms.kf_surf[0] @ poses[0][:3, :3].T + poses[0][:3, 3]).astype(np.float32)
    args = (src, ms.kf_surf_valid[11], tgt, ms.kf_surf_valid[0], poses[11][:2, 3].copy(),
            poses[0][:2, 3].copy())
    kw = dict(grid=cfg.loop_bev_grid, res=cfg.loop_bev_res, n_yaw=cfg.loop_bev_yaws)
    ba_j = jax.jit(lambda *a: jbev.bev_align(*a, **kw))(*(jnp.asarray(a) for a in args))
    ba_t = tbev.bev_align(*(torch.from_numpy(np.array(a)) for a in args), **kw)
    assert float(ba_t.yaw) == float(ba_j.yaw)
    np.testing.assert_array_equal(ba_t.shift.numpy()[:2], np.asarray(ba_j.shift)[:2])
    np.testing.assert_allclose(ba_t.shift.numpy()[2], np.asarray(ba_j.shift)[2], rtol=0, atol=1e-6)
    np.testing.assert_allclose(ba_t.transform.numpy(), np.asarray(ba_j.transform), rtol=0, atol=1e-5)
    np.testing.assert_allclose(float(ba_t.score), float(ba_j.score), rtol=1e-5)
    # the peak undoes the 75 degree yaw to within a 10 degree yaw step
    assert abs(float(ba_t.yaw) + np.radians(75.0)) < np.radians(10.0)
    # the ground quantile truncates an f32 product, as the reference does
    for n in (1, 7, 10, 99, 100):
        z = np.arange(n, dtype=np.float32)
        pts, m = np.c_[z, z, z], np.ones(n, bool)
        assert float(tbev._ground_z(torch.from_numpy(pts), torch.from_numpy(m))) == \
            float(jbev._ground_z(jnp.asarray(pts), jnp.asarray(m)))
