"""The frame step and the loop-closure attempt replayed from CUDA graphs,
on the GPU.  Skipped without one (graph capture needs the card).

* a tiny-config 8-frame ``SlamPipeline`` run (graphed) against an eager
  loop of ``slam_step`` on the card: every pose within 1e-5 m (the f64
  voxel sums are atomics, whose order can move a pose by ~1e-7 m), launch
  and keyframe counts equal;
* ``kernels.LAUNCHES`` grows by each graph's captured counts at every
  replay, and the warm-up's and the captures' own launches are set apart;
* the eager step makes no synchronising call (``set_sync_debug_mode``);
* a step with a host read injected raises at capture: nothing falls back
  to the eager step;
* on the loop scene of the CPU tests (twelve keyframes on a ring, the
  latest revisiting keyframe 0; from identity and yawed by 75 degrees,
  where only the bird's-eye-view rescue closes), the attempt replayed by
  ``SlamPipeline`` equals ``loop_closure_step`` run eagerly on a copy of
  the state, bit for bit, with one host read (the gate), the launches the
  config gives and one graph launch per ICP and GN iteration besides the
  five around those loops; the attempt past its gate makes no synchronising
  call; a host read injected into it raises at capture.

Like ``test_torch_kernels_gpu.py`` this file imports torch and numpy only,
so it runs on the GPU machine:
``python -m pytest --noconftest tests/test_torch_graph_gpu.py -q``.
"""

import numpy as np
import pytest
import torch

from alego_tpu_torch import kernels, tiny_config
from alego_tpu_torch.models import laser_mapping as tlm, pipeline as tpipe
from alego_tpu_torch.models import pose_graph as tpg
from alego_tpu_torch.utils import synthetic


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (graph capture has no CPU mode)")
    return torch.device("cuda")


def _frames(n=8):
    cfg = tiny_config().replace(loop_in_step=False)
    poses = synthetic.loop_trajectory(n, radius=20.0, speed=1.0, closed=False)
    pts, mask = synthetic.render_sequence(synthetic.make_world(seed=3), poses, cfg,
                                          noise=0.01)
    return cfg, pts, mask


def _eager(cfg, pts, mask, dev):
    st, out = tpipe.init_state(cfg, dev), []
    for k in range(pts.shape[0]):
        st, pose = tpipe.slam_step(st, torch.as_tensor(pts[k], device=dev),
                                   torch.as_tensor(mask[k], device=dev),
                                   torch.full((), k * cfg.scan_period, device=dev), cfg,
                                   do_map_static=k % cfg.map_frame_decimation == 0,
                                   do_loop_static=False)
        out.append(pose)
    return st, torch.stack(out).cpu().numpy()


@pytest.mark.gpu
def test_graphed_run_matches_eager(cuda):
    cfg, pts, mask = _frames()
    pipe = tpipe.SlamPipeline(cfg, device=cuda)
    kernels.LAUNCHES.clear()
    est = pipe.run(pts, mask)
    launches = dict(kernels.LAUNCHES)
    kernels.LAUNCHES.clear()
    st, want = _eager(cfg, pts, mask, cuda)
    assert launches == dict(kernels.LAUNCHES)
    assert int(pipe.state.mapping.graph.count) == int(st.mapping.graph.count)
    assert np.abs(est[:, :3, 3] - want[:, :3, 3]).max() <= 1e-5
    assert np.abs(est[:, :3, :3] - want[:, :3, :3]).max() <= 1e-5
    assert set(pipe.graphs.graphs) == {True, False}


@pytest.mark.gpu
def test_replays_count_their_launches(cuda):
    cfg, pts, mask = _frames(4)
    pipe = tpipe.SlamPipeline(cfg, device=cuda)
    kernels.LAUNCHES.clear()
    pipe.process(pts[0], mask[0])                  # captures, then replays frame 0
    g = pipe.graphs
    odo = 2 * cfg.odom_outer_iters          # 1-NN searches and solves (gn)
    assert g.launches[True] == {"ccl": 1, "nn1": odo, "knn": 2 * cfg.map_outer_iters,
                                "gn": odo + cfg.map_outer_iters}
    assert g.launches[False] == {"ccl": 1, "nn1": odo, "gn": odo}
    assert g.warmup_launches == g.launches[True]
    assert dict(kernels.LAUNCHES) == g.launches[True]
    for k in range(1, 4):
        before = dict(kernels.LAUNCHES)
        pipe.process(pts[k], mask[k])
        grown = {n: kernels.LAUNCHES[n] - before.get(n, 0) for n in kernels.LAUNCHES}
        want = g.launches[k % cfg.map_frame_decimation == 0]
        assert {n: c for n, c in grown.items() if c} == want
    assert pipe.graphs is g                        # captured once


@pytest.mark.gpu
def test_eager_step_makes_no_sync(cuda):
    cfg, pts, mask = _frames(3)
    st = tpipe.init_state(cfg, cuda)
    inputs = [(torch.as_tensor(pts[k], device=cuda), torch.as_tensor(mask[k], device=cuda))
              for k in range(3)]
    tpipe.slam_step(st, *inputs[0], torch.zeros((), device=cuda), cfg,
                    do_map_static=True, do_loop_static=False)     # lazy set-up
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for k in (1, 2):
            st, _ = tpipe.slam_step(st, *inputs[k], torch.zeros((), device=cuda), cfg,
                                    do_map_static=k % 2 == 0, do_loop_static=False)
    finally:
        torch.cuda.set_sync_debug_mode(0)


@pytest.mark.gpu
def test_host_read_in_the_step_raises(cuda, monkeypatch):
    cfg, pts, mask = _frames(2)
    real = tpipe.front_step

    def reads(state, *a):
        state.frame.item()
        return real(state, *a)

    monkeypatch.setattr(tpipe, "front_step", reads)
    pipe = tpipe.SlamPipeline(cfg, device=cuda)
    with pytest.raises(RuntimeError):
        pipe.process(pts[0], mask[0])
    assert pipe.graphs is None and pipe.poses == []
    torch.cuda.synchronize()


def _loop_scene(dev, yaw_deg=0.0):
    """The loop scene of tests/test_sharded_mapping.py: twelve keyframes on
    a 3 m ring, 10 s apart, each holding its view of two walls and a ground
    patch, the latest revisiting keyframe 0 (turned by ``yaw_deg`` about z).
    Returns (cfg, mapping state)."""
    cfg = tiny_config(max_keyframes=64, loop_time_gap=30.0, history_search_num=3,
                      history_fitness_score=0.1, icp_iters=40, loop_in_step=False)
    rng = np.random.default_rng(4)
    g = np.stack(np.meshgrid(np.linspace(-8, 8, 24), np.linspace(-8, 8, 24)), -1).reshape(-1, 2)
    ground = np.concatenate([g, np.full((len(g), 1), -1.5)], 1)
    w = np.stack(np.meshgrid(np.linspace(-8, 8, 24), np.linspace(-1.5, 2.5, 10)), -1).reshape(-1, 2)
    walls = [np.stack([w[:, 0], np.full(len(w), 8.0), w[:, 1]], 1),
             np.stack([np.full(len(w), -8.0), w[:, 0], w[:, 1]], 1)]
    world = np.concatenate([ground] + walls).astype(np.float32)
    world += rng.normal(0, 0.01, world.shape).astype(np.float32)
    ring = synthetic.loop_trajectory(12, radius=3.0, closed=True).astype(np.float32)
    c, s = np.cos(np.radians(yaw_deg)), np.sin(np.radians(yaw_deg))
    Tz = np.eye(4, dtype=np.float32)
    Tz[:2, :2] = [[c, -s], [s, c]]
    ms = tlm.init_state(cfg, dev)
    graph, yes = ms.graph, torch.ones((), dtype=torch.bool, device=dev)
    for k in range(12):
        local = (world - ring[k, :3, 3]) @ ring[k, :3, :3]
        graph = tpg.add_keyframe(graph, torch.as_tensor(ring[k], device=dev), yes)
        m = min(len(local), cfg.kf_surf_cap)
        ms.kf_surf[k, :m] = torch.as_tensor(local[:m], device=dev)
        ms.kf_surf_valid[k, :m] = True
        ms.kf_times[k] = k * 10.0
    graph.poses[11] = torch.as_tensor(Tz, device=dev) @ graph.poses[11]
    return cfg, ms._replace(graph=graph)


def _copy(tree):
    return tpipe._unflatten(tree, [t.clone() for _, t in tpipe._flatten(tree)])


@pytest.mark.gpu
@pytest.mark.parametrize("yaw_deg", [0.0, 75.0])
def test_loop_attempt_replay_matches_eager(cuda, yaw_deg):
    cfg, scene = _loop_scene(cuda, yaw_deg)
    kernels.LAUNCHES.clear()
    want, closed, fitness = tlm.loop_closure_step(_copy(scene), cfg)
    eager = dict(kernels.LAUNCHES)
    assert bool(closed)                 # both close: the yawed one by the rescue
    pipe = tpipe.SlamPipeline(cfg, device=cuda)
    pipe.state = pipe.state._replace(mapping=scene)
    reads = []
    pipe._read = lambda flag: reads.append(flag) or bool(flag)
    kernels.LAUNCHES.clear()
    pipe._loop_attempt()                           # the gate, a capture, a replay
    g = pipe.loop_graph
    assert len(reads) == 1
    rescue = min(cfg.icp_iters, cfg.loop_rescue_icp_iters)
    assert dict(kernels.LAUNCHES) == eager == g.launches == \
        {"nn1": cfg.icp_iters + 1 + rescue + 1, "knn": 2}
    # the warm-up runs each loop's iteration once; a replay launches the five
    # graphs around the loops (two ICPs, two solves) and each loop's
    # iteration graph its count
    assert g.warmup_launches == {"nn1": 4, "knn": 2}
    assert g.graph_launches == 5 + cfg.icp_iters + rescue + 2 * cfg.pose_graph_gn_iters
    for (path, a), (_, b) in zip(tpipe._flatten(pipe.state.mapping), tpipe._flatten(want)):
        assert torch.equal(a, b), path
    assert torch.equal(g.closed, closed) and torch.equal(g.fitness, fitness)
    # the same latest keyframe again: gated off, nothing launches
    pipe._loop_attempt()
    assert len(reads) == 2 and not bool(reads[1])
    assert dict(kernels.LAUNCHES) == g.launches and pipe.loop_graph is g
    pipe.state = pipe.state                        # adopting a state drops the graphs
    assert pipe.loop_graph is None and pipe.graphs is None


@pytest.mark.gpu
def test_loop_attempt_makes_no_sync(cuda):
    cfg, scene = _loop_scene(cuda, 75.0)
    _, closest, latest = tlm.loop_gate(scene, cfg)
    tlm.loop_attempt(_copy(scene), closest, latest, cfg)     # lazy set-up
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        _, closest, latest = tlm.loop_gate(scene, cfg)
        tlm.loop_attempt(scene, closest, latest, cfg)
    finally:
        torch.cuda.set_sync_debug_mode(0)


@pytest.mark.gpu
def test_host_read_in_the_attempt_raises(cuda, monkeypatch):
    cfg, scene = _loop_scene(cuda)
    real = tlm.loop_attempt

    def reads(ms, *a, **kw):
        ms.loop_attempts.item()
        return real(ms, *a, **kw)

    monkeypatch.setattr(tlm, "loop_attempt", reads)
    pipe = tpipe.SlamPipeline(cfg, device=cuda)
    pipe.state = pipe.state._replace(mapping=scene)
    with pytest.raises(RuntimeError):
        pipe._loop_attempt()
    assert pipe.loop_graph is None
    torch.cuda.synchronize()
