"""The port's ``parallel/`` on gloo CPU ranks against the JAX reference's on
the conftest's virtual CPU mesh.

Two rank groups run every port case, each started once by
``parallel.launch`` (one torch thread per rank):

* D = 4: (a) the row-sharded 5-NN, on a map whose rows divide by D, on
  a padded one and on one whose rows repeat across and within the shards,
  d2, global idx and coordinates equal to the reference's
  ``make_sharded_map_knn(return_coords=True)`` on live slots (d2 < 1e30;
  fill slots carry other indices, ROADMAP §3), and tied candidates in
  ascending global row (``lax.top_k``'s order); (b) the Schur solver at
  N = 64 with 3 loops, within 1e-5 m of the reference's Schur solver and
  of the port's ``optimize`` (the bar of tests/test_schur.py:83-91);
  (e) ``make_multichip_step``: the frame-parallel front end over 4
  frames, bit for bit the single front end's, and the distributed
  pose-graph solve of a drifted chain within 1e-5 m of ``optimize``;
* D = 2: (c) one sharded mapping step from a state carried across, within
  1e-4 of the reference's sharded step (tests/test_sharded_mapping.py's
  bar); (d) the sharded loop closure step on the loop scene of
  tests/test_sharded_mapping.py: closed on both sides, fitness within 1e-5,
  poses within 2e-3 m; (f) ``DistributedSlamPipeline`` over 8 frames, the
  loop step called on its cadence, within 1e-3 m of the reference's
  ``DistributedSlamPipeline(n_devices=2)`` and bit for bit the port's
  single-device run (the merge of the shards' candidates is exact), the
  two ranks' final states equal; (g)
  ``ShardedSlamPipeline``, two lanes bit for bit the single runs of their
  sequences.

(h) a rank that raises and ranks that hang both make ``launch`` raise
within its timeout; the per-rank byte counts equal the reference's; a
lane of the reference's batched state carries across.

The reference's programs run on a worker thread while the port's ranks
run, its neighbour searches through its Pallas kernels in interpret mode
(the functions the port's kernels compute), and its inputs are placed
replicated on its mesh before each call, so that each program compiles
once.
"""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from alego_tpu.config import tiny_config as j_tiny_config
from alego_tpu.models import laser_mapping as jlm, pipeline as jpipe, pose_graph as jpg
from alego_tpu.ops import icp as jicp
from alego_tpu.ops.pallas_nn import knn_pallas, nn1_pallas
from alego_tpu.parallel import map_shard as jms, schur as jschur
from alego_tpu.parallel.distributed import DistributedSlamPipeline as JDistributed
from alego_tpu.parallel.multichip import make_mesh

from alego_tpu_torch.config import tiny_config
from alego_tpu_torch.models import laser_mapping as tlm, pose_graph as tpg
from alego_tpu_torch.models.image_projection import image_projection
from alego_tpu_torch.models.pipeline import SlamPipeline, front_step, state_from_reference
from alego_tpu_torch.ops import se3
from alego_tpu_torch.ops.nn import knn_plain
from alego_tpu_torch.ops.features import extract_features
from alego_tpu_torch.parallel import launch, map_shard, multichip, ranks, schur
from alego_tpu_torch.utils import synthetic

from test_torch_mapping import pallas_search

# one intra-op thread: the suite runs in several test processes at once,
# where more threads per process only contend for the cores
torch.set_num_threads(1)

# the loop-closure configuration of tests/test_sharded_mapping.py, for every
# D = 2 case (one compile of each reference program)
BASE = dict(max_keyframes=64, loop_time_gap=30.0, history_search_num=3,
            history_fitness_score=0.5, icp_iters=25)
SIGMA = (1e-4,) * 6
N_SEQ = 8          # frames of the distributed run
N_LANE = 4         # frames of each lane
CARRY = 4          # the mapping step of (c) is frame CARRY's, from the state before it


def _loop_scene(cfg):
    """tests/test_sharded_mapping.py's ``_loop_ready_state`` in numpy: twelve
    keyframes on a 3 m ring, 10 s apart, each holding its view of two walls
    and a ground patch; the latest revisits keyframe 0."""
    rng = np.random.default_rng(4)
    g = np.stack(np.meshgrid(np.linspace(-8, 8, 24), np.linspace(-8, 8, 24)), -1).reshape(-1, 2)
    ground = np.concatenate([g, np.full((len(g), 1), -1.5)], 1)
    w1 = np.stack(np.meshgrid(np.linspace(-8, 8, 24), np.linspace(-1.5, 2.5, 10)),
                  -1).reshape(-1, 2)
    wall1 = np.stack([w1[:, 0], np.full(len(w1), 8.0), w1[:, 1]], 1)
    wall2 = np.stack([np.full(len(w1), -8.0), w1[:, 0], w1[:, 1]], 1)
    W = np.concatenate([ground, wall1, wall2]).astype(np.float32)
    W += rng.normal(0, 0.01, W.shape).astype(np.float32)
    ring = synthetic.loop_trajectory(12, radius=3.0, closed=True)
    ms = tlm.init_state(cfg, "cpu")
    graph = ms.graph
    for k in range(12):
        T = ring[k].astype(np.float32)
        graph = tpg.add_keyframe(graph, torch.from_numpy(T), torch.tensor(True))
        local = (W - T[:3, 3]) @ T[:3, :3]
        m = min(len(local), cfg.kf_surf_cap)
        ms.kf_surf[k, :m] = torch.from_numpy(local[:m])
        ms.kf_surf_valid[k, :m] = True
        ms.kf_times[k] = k * 10.0
    return ranks._numpy(ms._replace(graph=graph))


def _knn_case(seed, N):
    rng = np.random.default_rng(seed)
    Q = 256
    return (rng.uniform(-10, 10, (Q, 3)).astype(np.float32), rng.random(Q) < 0.9,
            rng.uniform(-10, 10, (N, 3)).astype(np.float32), rng.random(N) < 0.8)


def _tie_case(seed=2, N=4096, D=4):
    """Every row of the first shard repeated in each of the others, and some
    repeated within it, a fifth of the copies masked: each query's nearest
    rows tie across the shards."""
    rng = np.random.default_rng(seed)
    Q, nb = 256, N // D
    base = rng.uniform(-10, 10, (nb, 3)).astype(np.float32)
    dup = base[1::7].shape[0]
    base[1::7] = base[0::7][:dup]
    pts = np.tile(base, (D, 1))
    query = np.concatenate([pts[rng.integers(0, N, Q // 2)],
                            rng.uniform(-10, 10, (Q - Q // 2, 3)).astype(np.float32)])
    return query, rng.random(Q) < 0.9, pts, rng.random(N) < 0.8


def _single(cfg, pts, mask, carry=None):
    """A single-device run on the CPU: poses, and with ``carry`` the state
    before frame ``carry`` and that frame's mapping inputs (numpy)."""
    pipe = SlamPipeline(cfg, device="cpu")
    out = None
    for k in range(pts.shape[0]):
        if k == carry:
            t = torch.tensor(k * cfg.scan_period)
            _, T, fc, seg = front_step(pipe.state, torch.from_numpy(pts[k]),
                                       torch.from_numpy(mask[k]), t, cfg)
            args = (T, fc.less_sharp_pts, fc.less_sharp_valid, fc.less_flat_pts,
                    fc.less_flat_valid, seg.outlier_points, seg.outlier_valid, t)
            out = (ranks._numpy(pipe.state.mapping), [a.numpy() for a in args])
        pipe.process(pts[k], mask[k])
    return torch.stack(pipe.poses).numpy(), out


def _reference_state(ms):
    """A port ``MappingState`` of numpy leaves as the reference's type."""
    return jlm.MappingState(*ms)._replace(graph=jpg.PoseGraph(*ms.graph))


def _reference_d4(data):
    """The reference's sharded 5-NN and Schur solve on 4 virtual devices."""
    mesh4 = make_mesh(4)
    knn = jms.make_sharded_map_knn(mesh4, 5, return_coords=True)
    out = []
    for q, qm, mp_, mok in data["knn"]:
        m_s, ok_s = jms.shard_map_points(mesh4, jnp.asarray(mp_), jnp.asarray(mok))
        out.append([np.asarray(x) for x in knn(q, qm, m_s, ok_s)])
    g = jpg.PoseGraph(*map(jnp.asarray, data["graph"]))
    solver = jschur.make_schur_solver(mesh4, 64, 4, SIGMA, iters=1, max_step=1e9)
    return out, np.asarray(solver(g).poses)


def _reference_d2(data, port_carry):
    """The reference's ``DistributedSlamPipeline(n_devices=2)`` over the
    sequence, then (c) and (d) through the run's own programs.  Each call's
    state is placed replicated on the mesh first, so nothing recompiles."""
    dist = JDistributed(j_tiny_config(**BASE), n_devices=2)
    repl = NamedSharding(dist.mesh, P())
    pts, mask = data["seq"]
    for k in range(N_SEQ):
        dist.state = jax.device_put(dist.state, repl)
        dist.process(pts[k], mask[k])
    run = np.stack([np.asarray(p) for p in dist.poses])
    ms, args = port_carry.result()[1]
    ms_j, T_j = dist._map_step(jax.device_put(_reference_state(ms), repl),
                               *jax.device_put(args[:-1], repl), jnp.asarray(args[-1]))
    loop = dist._loop_step(jax.device_put(_reference_state(data["scene"]), repl))
    return dict(run=run, map=(jax.tree_util.tree_map(np.asarray, ms_j), np.asarray(T_j)),
                loop=jax.tree_util.tree_map(np.asarray, loop))


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    cfg = tiny_config(**BASE)
    world = synthetic.make_world(seed=3)
    poses = synthetic.loop_trajectory(N_SEQ, radius=20.0, speed=1.0, closed=False)
    seq = synthetic.render_sequence(world, poses, cfg, noise=0.01)
    lane_b = synthetic.render_sequence(synthetic.make_world(seed=8), poses[:N_LANE], cfg,
                                       noise=0.01, seed=1)
    root = tmp_path_factory.mktemp("frames")
    # a chain whose estimates were pushed off its measurements
    g = synthetic.circuit_graph(64, 60, 0, loop_cap=8, seed=3)[0]
    kick = np.random.default_rng(5).uniform(-0.05, 0.05, (59, 6)).astype(np.float32)
    g.poses[1:60] = g.poses[1:60] @ se3.se3_exp(torch.from_numpy(kick))
    return dict(
        cfg=cfg, seq=seq, lane_b=lane_b,
        seq_dir=ranks.save_frames(str(root / "seq"), *seq),
        lanes_dir=ranks.save_frames(str(root / "lanes"),
                                    np.stack([seq[0][:N_LANE], lane_b[0]], 1),
                                    np.stack([seq[1][:N_LANE], lane_b[1]], 1)),
        knn=[_knn_case(0, 4096), _knn_case(1, 3997), _tie_case()],
        graph=tpg.PoseGraph(*(x.numpy() for x in
                                 synthetic.circuit_graph(64, 60, 3, loop_cap=4, seed=1)[0])),
        chain=(g.poses.numpy(), g.chain_rel.numpy(), np.arange(64) < int(g.count)),
        scene=_loop_scene(cfg))


@pytest.fixture(scope="module")
def runs(data):
    """The two rank groups, the single-device runs and the reference's
    programs, overlapped: the reference's on two worker threads (its
    compiles release the interpreter), the D = 2 group on a third, the
    D = 4 group and the single runs here."""
    cfg = data["cfg"]
    pts, mask = data["seq"]
    with pytest.MonkeyPatch.context() as mp, ThreadPoolExecutor(4) as pool:
        pallas_search(mp)
        mp.setattr(jicp, "_nn1", lambda q, qm, r, rm, chunk=None:
                   nn1_pallas(q, qm, r, rm, interpret=True))
        mp.setattr(jms, "knn_best", lambda q, qm, r, rm, k, chunk=None:
                   knn_pallas(q, qm, r, rm, k=k, interpret=True))
        carry = pool.submit(_single, cfg, pts[:CARRY + 1], mask[:CARRY + 1], CARRY)
        ref4 = pool.submit(_reference_d4, data)
        ref2 = pool.submit(_reference_d2, data, carry)
        d2 = pool.submit(launch.launch, ranks.run_jobs, 2, [
            (ranks.mapping_step, (cfg, *carry.result()[1])),
            (ranks.loop_closure_step, (cfg, data["scene"])),
            (ranks.distributed_run, (cfg, data["seq_dir"])),
            (ranks.lanes_run, (cfg, data["lanes_dir"]))], device="cpu", timeout=300)
        d4 = launch.launch(ranks.run_jobs, 4, [
            *[(ranks.sharded_knn, (5, *case)) for case in data["knn"]],
            (ranks.schur_solve, (data["graph"], SIGMA, 1, 1e9)),
            (ranks.multichip_step, (cfg, pts[:4], mask[:4], *data["chain"]))],
            device="cpu", timeout=300)
        single = (_single(cfg, pts, mask)[0], _single(cfg, *data["lane_b"])[0])
        knn_j, schur_j = ref4.result()
        return dict(d2=d2.result(), d4=d4, single=single,
                    ref=dict(ref2.result(), knn=knn_j, schur=schur_j))


@pytest.mark.parametrize("case", [0, 1, 2], ids=["rows_divide", "padded", "ties"])
def test_sharded_knn_matches_reference(runs, data, case):
    (d, i, c), (d_j, i_j, c_j) = runs["d4"][case], runs["ref"]["knn"][case]
    q, qm, mp_, mok = data["knn"][case]
    live = d_j < 1e30
    np.testing.assert_array_equal(d < 1e30, live)
    # the interpreted Pallas kernel rounds d2 within an ulp of the exact
    # differences of squares (tests/test_torch_kernels_cpu.py), which may
    # swap near-tied neighbours; coordinates follow the indices
    np.testing.assert_allclose(d[live], d_j[live], rtol=1e-6, atol=0)
    same = live & (i == i_j)
    assert same.sum() > 0.99 * live.sum()
    np.testing.assert_array_equal(c[same], c_j[same])
    assert i[live].max() < mp_.shape[0]                        # pad rows never win
    # the single-device search over the whole map, bit for bit
    d1, i1 = knn_plain(*(torch.from_numpy(np.asarray(a)) for a in (q, qm, mp_, mok)), 5)
    np.testing.assert_array_equal(d[live], d1.numpy()[live])
    np.testing.assert_array_equal(i[live], i1.numpy()[live])
    np.testing.assert_array_equal(c[live], mp_[i[live]])


def test_sharded_knn_ties_take_the_lowest_row(runs):
    """Where candidates tie in d2 the merge keeps the lower global row:
    the lower rank, then the lower slot, as ``lax.top_k`` over the
    rank-major concatenation keeps them."""
    d, i, _ = runs["d4"][2]
    nb = 4096 // 4                              # rows per shard
    live = d < 1e30
    tied = live[:, 1:] & (d[:, 1:] == d[:, :-1])
    assert tied.sum() > 256                     # the case does tie, often
    assert (i[:, 1:][tied] > i[:, :-1][tied]).all()
    # a row's copies in the other shards follow it (where they are live)
    across = tied & (i[:, 1:] - i[:, :-1] == nb)
    assert across.sum() > 100


def test_per_device_bytes_match_reference():
    assert map_shard.per_device_map_bytes(2 ** 20, 8) == jms.per_device_map_bytes(2 ** 20, 8)
    assert map_shard.per_device_map_bytes(3997, 4) == jms.per_device_map_bytes(3997, 4)
    for args in ((2048, 8, 16), (2048, 4, 32), (64, 4, 4)):
        assert schur.per_device_bytes(*args) == jschur.per_device_bytes(*args)


def test_schur_matches_reference_and_optimize(runs, data):
    got = runs["d4"][3]["poses"]
    np.testing.assert_allclose(got, runs["ref"]["schur"], rtol=0, atol=1e-5)
    g = tpg.PoseGraph(*(torch.from_numpy(np.array(x)) for x in data["graph"]))
    want = tpg.optimize(g, SIGMA, 1, max_step=1e9).poses.numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_multichip_step(runs, data):
    """The frame-parallel front end bit for bit the single front end's, and
    the distributed chain solve within 1e-5 m of ``optimize``."""
    cfg = data["cfg"]
    pts, mask = data["seq"]
    fc, solved = runs["d4"][4]
    poses, chain_rel, active = data["chain"]
    g = tpg.init_graph(64, 8, "cpu")._replace(
        poses=torch.from_numpy(poses), chain_rel=torch.from_numpy(chain_rel),
        count=torch.tensor(int(active.sum()), dtype=torch.int32))
    want = tpg.optimize(g, cfg.pose_graph_chain_sigma, 2).poses.numpy()
    np.testing.assert_allclose(solved, want, rtol=0, atol=1e-5)
    assert np.abs(solved - poses).max() > 1e-3        # the solve moved the chain
    for b in range(4):
        one = extract_features(image_projection(torch.from_numpy(pts[b]),
                                                torch.from_numpy(mask[b]), cfg), cfg)
        for name, got, want in zip(one._fields, fc, one):
            np.testing.assert_array_equal(got[b], want.numpy(), err_msg=name)


def test_sharded_mapping_step_matches_reference(runs):
    (ms_t, T_t), (ms_j, T_j) = runs["d2"][0], runs["ref"]["map"]
    np.testing.assert_allclose(T_t, T_j, rtol=0, atol=1e-4)
    n = int(ms_j.graph.count)
    assert int(ms_t.graph.count) == n
    np.testing.assert_allclose(ms_t.graph.poses[:n], ms_j.graph.poses[:n], rtol=0, atol=1e-4)
    np.testing.assert_array_equal(ms_t.map_dirty, ms_j.map_dirty)


def test_sharded_loop_closure_matches_reference(runs):
    (ms_t, closed_t, fit_t), (ms_j, closed_j, fit_j) = runs["d2"][1], runs["ref"]["loop"]
    assert closed_t and bool(closed_j)
    np.testing.assert_allclose(fit_t, float(fit_j), rtol=0, atol=1e-5)
    n = int(ms_j.graph.count)
    for name in ("count", "loop_count", "loop_i", "loop_j"):
        np.testing.assert_array_equal(getattr(ms_t.graph, name), getattr(ms_j.graph, name))
    np.testing.assert_allclose(ms_t.graph.poses[:n], ms_j.graph.poses[:n], rtol=0, atol=2e-3)


def test_distributed_pipeline_matches_reference(runs):
    res = runs["d2"][2]
    est = res["poses"]
    assert est.shape == (N_SEQ, 4, 4) and np.isfinite(est).all()
    np.testing.assert_allclose(est[:, :3, 3], runs["ref"]["run"][:, :3, 3], rtol=0, atol=1e-3)
    np.testing.assert_array_equal(est, runs["single"][0])
    assert res["keyframes"] >= 2 and res["attempts"] == 0
    # both ranks took part: the sharded association gathered candidates
    assert all(r["collective_calls"] > 0 for r in res["ranks"])
    # and ended with the same graph and bit for bit the same poses
    assert ranks.ranks_agree(res["ranks"]) and res["ranks"][0]["poses_checksum"] != 0


def test_lanes_equal_single_runs(runs):
    lanes = runs["d2"][3]
    traj = lanes["trajectories"]
    assert traj.shape == (N_LANE, 2, 4, 4)
    np.testing.assert_array_equal(traj[:, 0], runs["single"][0][:N_LANE])
    np.testing.assert_array_equal(traj[:, 1], runs["single"][1])
    assert lanes["keyframes"].shape == (2,) and (lanes["keyframes"] >= 1).all()


def test_lane_state_from_a_batched_reference_state(data):
    """A lane of the reference's batched state (its ``ShardedSlamPipeline``
    state) carries across as that lane's ``SlamState``."""
    one = jax.tree_util.tree_map(np.asarray, jpipe.init_state(j_tiny_config(**BASE)))
    batched = jax.tree_util.tree_map(
        lambda x: np.stack([x, x if x.dtype == bool else x + np.ones((), x.dtype)]), one)
    state = state_from_reference(multichip.lane_state(batched, 1), "cpu", data["cfg"])
    assert int(state.frame) == 1
    np.testing.assert_array_equal(state.mapping.graph.poses.numpy(),
                                  one.mapping.graph.poses + 1)


def test_failed_rank_raises():
    with pytest.raises(RuntimeError, match="rank 1 of 2 failed") as err:
        launch.launch(ranks.fail_on, 2, 1, device="cpu", timeout=60)
    assert "fails on purpose" in str(err.value)


def test_launch_needs_a_gpu_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launch.launch(ranks.stall, 2, 0.0)


def test_hung_ranks_raise_at_the_timeout():
    with pytest.raises(TimeoutError, match="still running after 3"):
        launch.launch(ranks.stall, 2, 600.0, device="cpu", timeout=3)
