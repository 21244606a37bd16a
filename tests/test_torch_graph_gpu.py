"""The frame step replayed from CUDA graphs, on the GPU.  Skipped without
one (graph capture needs the card).

* a tiny-config 8-frame ``SlamPipeline`` run (graphed) against an eager
  loop of ``slam_step`` on the card: every pose within 1e-5 m (the f64
  voxel sums are atomics, whose order can move a pose by ~1e-7 m), launch
  and keyframe counts equal;
* ``kernels.LAUNCHES`` grows by each graph's captured counts at every
  replay, and the warm-up's and the captures' own launches are set apart;
* the eager step makes no synchronising call (``set_sync_debug_mode``);
* a step with a host read injected raises at capture: nothing falls back
  to the eager step.

Like ``test_torch_kernels_gpu.py`` this file imports torch and numpy only,
so it runs on the GPU machine:
``python -m pytest --noconftest tests/test_torch_graph_gpu.py -q``.
"""

import numpy as np
import pytest
import torch

from alego_tpu_torch import kernels, tiny_config
from alego_tpu_torch.models import pipeline as tpipe
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
    assert g.launches[True] == {"ccl": 1, "nn1": 2 * cfg.odom_outer_iters,
                                "knn": 2 * cfg.map_outer_iters}
    assert g.launches[False] == {"ccl": 1, "nn1": 2 * cfg.odom_outer_iters}
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
