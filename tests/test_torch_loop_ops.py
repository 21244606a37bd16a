"""The loop-closure ops of the port against the JAX reference on the same
numpy-seeded inputs: se(3) maps, the closed-form Kabsch rotation, the
affine scans and the chain solve, the pose-graph solve and its dense
oracle, ICP, keyframe compaction and the loop candidate search (the
bird's-eye-view alignment is held in test_torch_loop_closure.py, on its
scene).

Tolerances: f32 closed forms within 2e-6 (twists) and 5e-7 (rotations;
the rank-1 covariance, whose optimum is not unique, by its objective).  The
doubling scan composes the affine maps in another order than XLA's
associative scan, so scans and chain solves agree to 1e-5 relative of the
solution's scale.  Poses of the pose-graph solve agree within 1e-5 m / rad
with the reference's and with the dense oracle run in f64 (the f32 dense LU
itself is off by ~1e-4 on this stiff chain).  Integers, masks and
iteration counts are equal; each test states its other tolerances.  The
reference's 1-NN inside ICP runs its Pallas kernel in interpret mode (the
function the port's kernel computes).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from alego_tpu.config import tiny_config
from alego_tpu.models import laser_mapping as jlm, pose_graph as jpg
from alego_tpu.ops import chain_solver as jcs, eig3 as jeig
from alego_tpu.ops import icp as jicp, se3 as jse3
from alego_tpu.ops.pallas_nn import nn1_pallas

from alego_tpu_torch.models import laser_mapping as tlm, pose_graph as tpg
from alego_tpu_torch.models.pipeline import tree_from_reference
from alego_tpu_torch.ops import chain_solver as tcs, eig3 as teig
from alego_tpu_torch.ops import icp as ticp, se3 as tse3

from test_compaction import _filled_mapping_state

# one intra-op thread: the suite runs in several test processes at once,
# where more threads per process only contend for the cores
torch.set_num_threads(1)

# the reference runs jitted: one compile per function, not one per op
j_se3 = {name: jax.jit(getattr(jse3, name))
         for name in ("se3_exp", "se3_log", "so3_exp", "adjoint")}
j_rot = jax.jit(jeig.rotation_from_covariance)
j_scan = jax.jit(jcs.affine_scan_carry, static_argnames="reverse")
j_chain = jax.jit(jcs.chain_solve)
# the budget is traced: every ICP case with one start shares one program
j_icp = jax.jit(jicp.icp_point_to_point, static_argnames="max_corr_dist")


def T(a):
    return torch.from_numpy(np.array(a))


def N(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _twists(rng):
    """Random twists plus rotation angles at 0, 1e-7, 1e-4, 1e-2 and near pi."""
    xi = rng.normal(0, 0.5, (32, 6)).astype(np.float32)
    axis = rng.normal(size=(8, 3))
    axis /= np.linalg.norm(axis, axis=1, keepdims=True)
    angles = np.array([0.0, 1e-7, 1e-4, 1e-2, 0.5, 3.0, np.pi - 1e-3, np.pi - 1e-2])
    xi[:8, 3:] = axis * angles[:, None]
    return xi


def test_se3_maps_match_reference():
    xi = _twists(np.random.default_rng(0))
    Tt = tse3.se3_exp(T(xi))
    np.testing.assert_allclose(N(Tt), N(j_se3['se3_exp'](jnp.asarray(xi))), rtol=0, atol=2e-6)
    np.testing.assert_allclose(N(tse3.adjoint(Tt)), N(j_se3['adjoint'](jnp.asarray(N(Tt)))),
                               rtol=0, atol=2e-6)
    np.testing.assert_allclose(N(tse3.so3_exp(T(xi[:, 3:]))),
                               N(j_se3['so3_exp'](jnp.asarray(xi[:, 3:]))), rtol=0, atol=2e-6)
    log_t = N(tse3.se3_log(Tt))
    np.testing.assert_allclose(log_t, N(j_se3['se3_log'](jnp.asarray(N(Tt)))), rtol=0, atol=2e-6)
    # round trip away from pi, where log is well conditioned in f32
    ok = np.linalg.norm(xi[:, 3:], axis=1) < 3.0
    np.testing.assert_allclose(log_t[ok], xi[ok], rtol=0, atol=2e-4)
    np.testing.assert_allclose(N(tse3.se3_exp(tse3.se3_log(Tt)))[ok], N(Tt)[ok], rtol=0, atol=2e-4)
    # f64 runs the same closed forms
    x64 = tse3.se3_log(tse3.se3_exp(T(xi[8:].astype(np.float64))))
    assert x64.dtype == torch.float64
    np.testing.assert_allclose(N(x64), xi[8:], rtol=0, atol=1e-6)


def _covariances(rng):
    """Random S, reflections (det < 0), rank 1, S = 0 and scaled ones."""
    S = rng.normal(size=(12, 3, 3))
    S[1] = np.diag([1.0, 2.0, -3.0])                     # reflection
    S[2] = rng.normal(size=(3, 3)) @ np.diag([1.0, 1.0, -1.0])
    u, v = rng.normal(size=3), rng.normal(size=3)
    S[3] = np.outer(u, v)                                 # rank 1
    S[4] = 0.0                                            # no correspondence
    S[5] = np.eye(3)                                      # isotropy
    S[6] *= 1e6
    S[7] *= 1e-8
    return S.astype(np.float32)


def test_rotation_from_covariance_matches_reference():
    S = _covariances(np.random.default_rng(1))
    got = N(teig.rotation_from_covariance(T(S)))
    want = N(j_rot(jnp.asarray(S)))
    # a rank-1 S has a one-parameter family of optima (any spin about the
    # matched direction): there the fallback's choice follows rounding, so
    # that case is held to the objective, every other one to the rotation
    unique = np.arange(len(S)) != 3
    np.testing.assert_allclose(got[unique], want[unique], rtol=0, atol=5e-7)
    np.testing.assert_allclose(got[4], np.eye(3), rtol=0, atol=0)   # S = 0 -> identity
    np.testing.assert_allclose(got @ got.transpose(0, 2, 1), np.broadcast_to(np.eye(3), got.shape),
                               rtol=0, atol=2e-6)
    np.testing.assert_allclose(np.linalg.det(got), 1.0, rtol=0, atol=2e-6)
    # the Kabsch objective tr(R S) equals the reference's, and the f64 SVD
    # optimum, on every S
    tr = np.trace(got @ S, axis1=1, axis2=2)
    np.testing.assert_allclose(tr, np.trace(want @ S, axis1=1, axis2=2), rtol=1e-6, atol=1e-12)
    best = np.linalg.svd(S.astype(np.float64), compute_uv=False)
    best[:, 2] *= np.sign(np.linalg.det(S.astype(np.float64)))
    np.testing.assert_allclose(tr, best.sum(1), rtol=1e-6, atol=1e-12)


def _chain_blocks(rng, n=64, k=5):
    Ad = rng.normal(0, 0.3, (n, 6, 6)).astype(np.float32)
    Ad[0] = 0.0
    Ad += np.eye(6, dtype=np.float32) * 0.5
    Ad[0] = 0.0
    Jr = (np.eye(6) + rng.normal(0, 0.05, (n, 6, 6))).astype(np.float32)
    info = rng.uniform(1.0, 1e4, (n, 6)).astype(np.float32)
    rhs = rng.normal(size=(n, 6, k)).astype(np.float32)
    return Ad, Jr, info, rhs


@pytest.mark.parametrize("reverse", [False, True])
def test_affine_scan_matches_reference(reverse):
    rng = np.random.default_rng(2)
    A = (rng.normal(0, 0.25, (64, 6, 6)) + np.eye(6)).astype(np.float32)
    b = rng.normal(size=(64, 6, 3)).astype(np.float32)
    A_t, x_t = tcs.affine_scan_carry(T(A), T(b), reverse=reverse)
    A_j, x_j = j_scan(jnp.asarray(A), jnp.asarray(b), reverse=reverse)
    for got, want in ((A_t, A_j), (x_t, x_j)):
        want = N(want)
        np.testing.assert_allclose(N(got), want, rtol=0, atol=1e-5 * np.abs(want).max())
    # the sequential recursion itself
    x = np.zeros((6, 3))
    order = range(63, -1, -1) if reverse else range(64)
    for i in order:
        x = A[i].astype(np.float64) @ x + b[i]
        np.testing.assert_allclose(N(x_t)[i], x, rtol=0, atol=1e-5 * np.abs(N(x_j)).max())


def test_chain_solve_matches_reference():
    Ad, Jr, info, rhs = _chain_blocks(np.random.default_rng(3))
    got = N(tcs.chain_solve(T(Ad), T(Jr), T(info), T(rhs)))
    want = N(j_chain(*(jnp.asarray(a) for a in (Ad, Jr, info, rhs))))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())
    # against the formed system in f64
    n = Ad.shape[0]
    B = np.eye(6 * n)
    for i in range(1, n):
        B[6 * i:6 * i + 6, 6 * i - 6:6 * i] = -Ad[i]
    J = np.zeros((6 * n, 6 * n))
    for i in range(n):
        J[6 * i:6 * i + 6, 6 * i:6 * i + 6] = Jr[i]
    J = J @ B
    H = J.T @ np.diag(info.reshape(-1).astype(np.float64)) @ J
    x = np.linalg.solve(H, rhs.reshape(6 * n, -1).astype(np.float64)).reshape(n, 6, -1)
    np.testing.assert_allclose(got, x, rtol=0, atol=1e-4 * np.abs(x).max())
    # the f64 path (f32 factorisations refined once)
    got64 = N(tcs.chain_solve(*(T(a.astype(np.float64)) for a in (Ad, Jr, info, rhs))))
    np.testing.assert_allclose(got64, x, rtol=0, atol=1e-8 * np.abs(x).max())


def _drifted_graph(n=64, n_loops=2, cap_loops=8, seed=5):
    """The scene of test_pose_graph_fast._graph_with_loops, built in numpy:
    a chain of ~1 m steps (+-0.05 in every twist coordinate), every node
    but 0 drifted by a +-0.04 twist, and loop factors (n-1-2l, 2l) of
    weight 25 measured on the true poses.  Returns (reference graph, port
    graph, true poses)."""
    rng = np.random.default_rng(seed)
    steps = rng.uniform(-0.05, 0.05, (n, 6)).astype(np.float32)
    steps[:, 0] += 1.0
    rel = N(tse3.params_to_mat(T(steps)))
    true = [np.eye(4, dtype=np.float32)]
    for k in range(1, n):
        true.append((true[-1] @ rel[k - 1]).astype(np.float32))
    true = np.stack(true)
    drift = N(tse3.se3_exp(T(rng.uniform(-0.04, 0.04, (n, 6)).astype(np.float32))))
    drift[0] = np.eye(4)
    chain_rel = true.copy()
    chain_rel[1:] = np.linalg.inv(true[:-1]) @ true[1:]
    loops = [(n - 1 - 2 * l, 2 * l) for l in range(n_loops)]
    loop_rel = np.tile(np.eye(4, dtype=np.float32), (cap_loops, 1, 1))
    loop_i = np.zeros(cap_loops, np.int32)
    loop_j = np.zeros(cap_loops, np.int32)
    loop_w = np.zeros(cap_loops, np.float32)
    for l, (i, j) in enumerate(loops):
        loop_i[l], loop_j[l], loop_w[l] = i, j, 25.0
        loop_rel[l] = np.linalg.inv(true[i]) @ true[j]
    g = jpg.PoseGraph(poses=(true @ drift).astype(np.float32), chain_rel=chain_rel.astype(np.float32),
                      loop_i=loop_i, loop_j=loop_j, loop_rel=loop_rel.astype(np.float32),
                      loop_w=loop_w, count=np.int32(n), loop_count=np.int32(n_loops),
                      overflow=np.int32(0), loop_overflow=np.int32(0))
    return (jax.tree_util.tree_map(jnp.asarray, g), tree_from_reference(tpg.PoseGraph, g, "cpu"),
            true)


def test_optimize_matches_reference_and_dense_oracle():
    g_j, g_t, truth = _drifted_graph()
    sigma = (1e-4,) * 6
    out_t = tpg.optimize(g_t, sigma, iters=3)
    out_j = jax.jit(lambda g: jpg.optimize(g, sigma, iters=3))(g_j)
    g64 = g_t._replace(poses=g_t.poses.double(), chain_rel=g_t.chain_rel.double(),
                       loop_rel=g_t.loop_rel.double(), loop_w=g_t.loop_w.double())
    dense = N(tpg.optimize_dense(g64, sigma, iters=3).poses)
    got = N(out_t.poses)
    np.testing.assert_allclose(got, N(out_j.poses), rtol=0, atol=1e-5)
    np.testing.assert_allclose(got, dense, rtol=0, atol=1e-5)
    # the f32 dense oracle of both packages, as the reference's test holds it
    np.testing.assert_allclose(N(tpg.optimize_dense(g_t, sigma, iters=3).poses), dense,
                               rtol=0, atol=1e-3)
    assert np.abs(got - truth).max() < 0.06
    # the factored solver in f64 (chain_solve's f64 path) answers the dense
    # oracle's system of one GN iteration to 1e-9 of the step (4.5e-12 m
    # against 0.09 measured)
    Ad, Jr, info, b, Vs = tpg._gn_parts(g64, T(np.asarray(sigma)))
    step = N(tpg._assemble_and_solve(g64, sigma)[0])
    np.testing.assert_allclose(N(tpg._factored_solver(Ad, Jr, info, Vs)(b)), step,
                               rtol=0, atol=1e-9 * np.abs(step).max())
    # the energy of the drifted graph: f64 within 1e-9 relative; f32 within
    # 1e-5, since f32 pose products at 64 m lever arms put ~4e-6 m of
    # rounding into each residual's translation
    energy = jax.jit(lambda g: jpg.graph_energy(g, sigma))
    e_t = float(tpg.graph_energy(g64, sigma))
    with jax.enable_x64(True):
        g_j64 = jax.tree_util.tree_map(
            lambda a: jnp.asarray(np.asarray(a, np.float64) if a.dtype == np.float32
                                  else np.asarray(a)), g_j)
        e_j = float(energy(g_j64))
    assert abs(e_t - e_j) <= 1e-9 * e_j, (e_t, e_j)
    e32 = float(tpg.graph_energy(g_t, sigma))
    assert abs(e32 - float(energy(g_j))) <= 1e-5 * e_j
    assert abs(e32 - e_j) <= 1e-5 * e_j
    assert float(tpg.graph_energy(out_t, sigma)) < 1e-3 * e32
    # the GN iterations through a loop that updates its carry in place (the
    # loop graph's way) give the same poses
    assert torch.equal(tpg.optimize(g_t, sigma, iters=3, loop=_in_place_loop).poses,
                       out_t.poses)


def test_add_loop_factor_counts_overflow():
    rel = np.eye(4, dtype=np.float32)
    rel[0, 3] = 1.5
    g_t = tpg.init_graph(8, 2, "cpu")
    g_j = jpg.init_graph(8, 2)
    for l in range(3):
        args = (np.int32(5 + l), np.int32(l), rel, np.float32(10.0 + l))
        g_t = tpg.add_loop_factor(g_t, *(T(a) for a in args))
        g_j = jpg.add_loop_factor(g_j, *(jnp.asarray(a) for a in args))
    assert int(g_t.loop_count) == 2 and int(g_t.loop_overflow) == 1
    for name in jpg.PoseGraph._fields:
        np.testing.assert_array_equal(N(getattr(g_t, name)), N(getattr(g_j, name)), err_msg=name)


def _in_place_loop(body, carry, n):
    """``device.fixed_loop`` the loop graph's way: the carry copied into
    buffers of its own, each iteration written back into them."""
    carry = tuple(c.clone() for c in carry)
    for _ in range(n):
        for c, new in zip(carry, body(carry)):
            c.copy_(new)
    return carry


def _pallas_nn1(q, qm, r, rm, chunk=None):
    return nn1_pallas(q, qm, r, rm, interpret=True)


@pytest.fixture
def icp_clouds():
    rng = np.random.default_rng(6)
    tgt = rng.uniform(-10, 10, (768, 3)).astype(np.float32)
    tgt_ok = rng.random(768) < 0.95
    true = jse3.params_to_mat(jnp.asarray([0.4, -0.3, 0.2, 0.03, -0.02, 0.1], jnp.float32))
    Tm = np.asarray(true)
    # the source is the target pulled back through the true transform
    src = ((tgt - Tm[:3, 3]) @ Tm[:3, :3] + rng.normal(0, 0.002, (768, 3))).astype(np.float32)
    src_ok = tgt_ok & (rng.random(768) < 0.9)
    return src, src_ok, tgt, tgt_ok, Tm


@pytest.mark.parametrize("start", ["identity", "T0", "far", "budget", "frozen"])
def test_icp_matches_reference(icp_clouds, start, monkeypatch):
    """From identity, from near the truth, with no correspondence in range,
    with a budget that runs out before the epsilon stop (``budget``), and
    from identity with every search counted (``frozen``): the masked loop
    runs all ``iters`` iterations and leaves the result of the reference's
    ``while_loop``, bit for bit the result of a budget that ends at the
    stop, and of a loop that updates its carry in place."""
    monkeypatch.setattr(jicp, "_nn1", _pallas_nn1)
    src, src_ok, tgt, tgt_ok, Tm = icp_clouds
    kw = dict(iters=2 if start == "budget" else 30, max_corr_dist=5.0)
    searches = []
    if start == "frozen":
        real = ticp._nn1
        monkeypatch.setattr(ticp, "_nn1", lambda *a: searches.append(1) or real(*a))
    T0 = None
    if start == "T0":
        T0 = (Tm @ np.asarray(jse3.se3_exp(jnp.asarray([0.05, 0, 0, 0, 0, 0.02], jnp.float32)))
              ).astype(np.float32)
    if start == "far":             # no correspondence within range
        tgt = tgt + 1e3
    res_j = j_icp(jnp.asarray(src), jnp.asarray(src_ok), jnp.asarray(tgt), jnp.asarray(tgt_ok),
                  T0=None if T0 is None else jnp.asarray(T0), **kw)
    res_t = ticp.icp_point_to_point(T(src), T(src_ok), T(tgt), T(tgt_ok),
                                    T0=None if T0 is None else T(T0), **kw)
    assert int(res_t.iters) == int(res_j.iters)
    assert bool(res_t.converged) == bool(res_j.converged)
    np.testing.assert_allclose(N(res_t.transform), N(res_j.transform), rtol=0, atol=1e-5)
    # a converged d2 of ~1e-5 m^2 moves by ~1e-9 with the transform's f32
    # rounding (~1e-7 m); the spent budget's d2 of ~5e-4 m^2 (2 cm) moves by
    # ~2 sqrt(d2) 1e-7 m, 1e-8 m^2
    np.testing.assert_allclose(float(res_t.fitness), float(res_j.fitness), rtol=1e-5,
                               atol=2e-8 if start == "budget" else 1e-9)
    if start == "far":
        assert not bool(res_t.converged)
        np.testing.assert_array_equal(N(res_t.transform), np.eye(4))
    elif start == "budget":
        # PCL's default counts a spent budget as converged
        assert int(res_t.iters) == 2 and bool(res_t.converged)
        assert np.abs(N(res_t.transform) - Tm).max() > 5e-3
    else:
        assert bool(res_t.converged) and int(res_t.iters) < 30
        np.testing.assert_allclose(N(res_t.transform), Tm, rtol=0, atol=5e-3)
    if start == "frozen":
        # every iteration searched, and the fitness pass once more
        assert len(searches) == 30 + 1
        stop = int(res_t.iters)
        res_s = ticp.icp_point_to_point(T(src), T(src_ok), T(tgt), T(tgt_ok), iters=stop,
                                        max_corr_dist=5.0)
        for got, want in zip(res_t, res_s):
            assert torch.equal(got, want), (got, want)

        # a loop that updates its carry in place, as the loop graph's
        # replayed iteration does, leaves the same result
        res_p = ticp.icp_point_to_point(T(src), T(src_ok), T(tgt), T(tgt_ok),
                                        loop=_in_place_loop, **kw)
        for got, want in zip(res_p, res_t):
            assert torch.equal(got, want), (got, want)


def test_compact_keyframes_matches_reference():
    cfg = tiny_config(max_keyframes=32, recent_keyframe_search_num=8)
    ms = _filled_mapping_state(cfg, 32, np.random.default_rng(0))
    for i, j, w in ((21, 3, 10.0), (25, 7, 5.0), (30, 29, 1.0)):
        ms = ms._replace(graph=jpg.add_loop_factor(
            ms.graph, jnp.int32(i), jnp.int32(j), jnp.eye(4), jnp.float32(w)))
    ms = ms._replace(last_loop_kf=jnp.int32(25))
    ms_t = tree_from_reference(tlm.MappingState, jax.tree_util.tree_map(np.asarray, ms), "cpu")
    out_j = jax.jit(lambda m: jlm.compact_keyframes(m, cfg))(ms)
    out_t = tlm.compact_keyframes(ms_t, cfg)
    for name in ("kf_times", "kf_corner", "kf_corner_valid", "kf_surf_valid",
                 "last_loop_kf", "map_dirty"):
        np.testing.assert_array_equal(N(getattr(out_t, name)), N(getattr(out_j, name)),
                                      err_msg=name)
    for name in ("count", "loop_i", "loop_j", "loop_count", "poses"):
        np.testing.assert_array_equal(N(getattr(out_t.graph, name)),
                                      N(getattr(out_j.graph, name)), err_msg=name)
    np.testing.assert_allclose(N(out_t.graph.chain_rel), N(out_j.graph.chain_rel),
                               rtol=0, atol=1e-6)
    assert int(out_t.graph.count) < 32


def test_detect_loop_needs_time_gap():
    cfg = tiny_config()
    ms = jlm.init_state(cfg)
    g = jpg.add_keyframe(jpg.add_keyframe(ms.graph, jnp.eye(4)), jnp.eye(4).at[0, 3].set(2.0))
    ms = ms._replace(graph=g, kf_times=ms.kf_times.at[0].set(0.0).at[1].set(1.0))
    for t1, want in ((1.0, False), (100.0, True)):
        ms = ms._replace(kf_times=ms.kf_times.at[1].set(t1))
        ms_t = tree_from_reference(tlm.MappingState, jax.tree_util.tree_map(np.asarray, ms), "cpu")
        found, closest, latest = tlm.detect_loop(ms_t, cfg)
        ref = jlm.detect_loop(ms, cfg)
        assert bool(found) == bool(ref[0]) == want
        assert int(closest) == int(ref[1]) and int(latest) == int(ref[2]) == 1
        if want:
            assert int(closest) == 0
