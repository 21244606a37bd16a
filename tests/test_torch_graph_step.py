"""The frame step made capture-safe, and the pipeline's static state.

* ``gauss_newton.degeneracy_projector`` (the cyclic Jacobi ``eigh6`` in
  place of ``torch.linalg.eigh``) against the reference's on random SPD,
  rank-deficient and non-finite 6x6 matrices whose eigenvalues keep clear
  of the floor: P within 1e-5 (the reference's f32 ``eigh`` is the coarser
  side); ``eigh6`` leaves an
  off-diagonal below 1e-12 of the largest entry on spectra spread over nine
  decades;
* the component sizes of segmentation, counted by a scatter-add into a
  fixed buffer, against ``torch.bincount``, bit for bit;
* ``mapping_step`` (the local map built on every mapping frame and selected
  by ``map_dirty`` on the device) against the reference's (``lax.cond``)
  with ``map_dirty`` False and True, from one state and inputs: the pose
  within 1e-4 m / 1e-5 rad, the selected map's masks equal and points
  within 1e-3 of the leaf, and, on the port's side, the map bit for bit the
  cached one or the rebuilt one;
* the static state: every tensor of ``SlamPipeline.state`` keeps its
  ``data_ptr`` across ``process``, ``run_scanned``, the hoisted loop
  attempts, ``_maybe_compact``, an IMU flush, ``reset`` and
  ``load_checkpoint``, and the poses after each equal, bit for bit, an
  eager loop of ``slam_step`` with the same updates between frames.

The reference's searches run its Pallas kernels in interpret mode (see
test_torch_pipeline); its ``mapping_step`` is compiled once for the file.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from alego_tpu.models import laser_mapping as jlm, pose_graph as jpg
from alego_tpu.ops import gauss_newton as jgn
from alego_tpu.utils import synthetic

from alego_tpu_torch.models import laser_mapping as tlm, pipeline as tpipe
from alego_tpu_torch.ops import deskew as tdk, gauss_newton as tgn
from alego_tpu_torch.ops.segmentation import component_sizes

from test_torch_pipeline import assert_pose_close, pallas_search

# one intra-op thread: the suite runs in several test processes at once,
# where more threads per process only contend for the cores
torch.set_num_threads(1)


def _random_symmetric(rng, lam):
    Q, _ = np.linalg.qr(rng.normal(size=(6, 6)))
    A = (Q * lam) @ Q.T
    return 0.5 * (A + A.T)


def _projector_cases(floor):
    """(name, H [6, 6] f32) around ``floor``: full rank, rank-deficient,
    repeated eigenvalues, and non-finite.  The kept eigenvalues lie in
    [2, 50] x floor and the dropped ones in [0, 0.5] x floor, so both f32
    decompositions see the same split (an eigenvalue within f32's rounding
    of ||H|| from the floor could fall on either side)."""
    rng = np.random.default_rng(11)
    out = []
    for k in range(12):
        lam = floor * rng.uniform(2.0, 50.0, 6)
        n_low = k % 4                          # 0-3 directions below the floor
        lam[:n_low] = floor * rng.uniform(0.0, 0.5, n_low)
        if k % 3 == 1:
            lam[:n_low] = 0.0                  # rank-deficient
        if k % 5 == 2:
            lam[3:] = lam[3]                   # a repeated eigenvalue
        out.append((f"case{k}", _random_symmetric(rng, lam).astype(np.float32)))
    bad = out[0][1].copy()
    bad[1, 4] = bad[4, 1] = np.nan
    out.append(("nan", bad))
    inf = out[1][1].copy()
    inf[0, 0] = np.inf
    out.append(("inf", inf))
    return out


@pytest.mark.parametrize("floor", [1.0, 100.0])
def test_degeneracy_projector_matches_reference(floor):
    proj = jax.jit(jgn.degeneracy_projector, static_argnums=1)
    for name, H in _projector_cases(floor):
        P_t = tgn.degeneracy_projector(torch.from_numpy(H), floor).numpy()
        P_j = np.asarray(proj(jnp.asarray(H), floor))
        np.testing.assert_allclose(P_t, P_j, rtol=0, atol=1e-5, err_msg=name)
        if not np.isfinite(H).all():
            assert not P_t.any(), name


def test_eigh6_converges():
    """Spectra over nine decades, with zeros and a repeated eigenvalue,
    against numpy's f64 ``eigvalsh``."""
    rng = np.random.default_rng(12)
    for k in range(12):
        lam = 10.0 ** rng.uniform(-3, 6, 6)
        if k % 3 == 1:
            lam[rng.choice(6, 2, replace=False)] = 0.0
        if k % 4 == 2:
            lam[:3] = lam[0]
        A = torch.from_numpy(_random_symmetric(rng, lam))
        lam_t, V = tgn.eigh6(A)
        D = V.T @ A @ V
        off = (D - torch.diag(torch.diagonal(D))).abs().max()
        assert float(off) <= 1e-12 * float(A.abs().max()), k
        np.testing.assert_allclose(np.sort(lam_t.numpy()), np.linalg.eigvalsh(A.numpy()),
                                   rtol=0, atol=1e-10 * float(A.abs().max()), err_msg=str(k))
        np.testing.assert_allclose((V.T @ V).numpy(), np.eye(6), rtol=0, atol=1e-12)


def test_component_sizes_match_bincount():
    rng = np.random.default_rng(5)
    for n, size in ((1, 10), (17, 1000), (64001, 64000)):
        labels = torch.from_numpy(rng.integers(0, n, size))
        labels[-1] = n - 1            # the sentinel slot, as segmentation uses it
        want = torch.bincount(labels, minlength=n)
        got = component_sizes(labels, n)
        assert got.dtype == want.dtype and torch.equal(got, want)


@pytest.fixture(scope="module")
def tiny_run(cfg, world):
    """A tiny config with hoisted loop attempts that run within 8 frames
    (a 0.3 s age gate, 3 ICP iterations, no rescue), and its frames."""
    cfg = cfg.replace(loop_in_step=False, loop_every_n_frames=3, loop_time_gap=0.3,
                      icp_iters=3, loop_coarse_align=False)
    poses = synthetic.loop_trajectory(8, radius=20.0, speed=1.5, closed=False)
    pts, mask = synthetic.render_sequence(world, poses, cfg, noise=0.01)
    return cfg, pts, mask


def _mapping_inputs(cfg, pts, mask, frames):
    """The port's state after ``frames`` frames, and the next frame's
    mapping inputs (the front half's features and odometry pose)."""
    pipe = tpipe.SlamPipeline(cfg, device="cpu")
    pipe.run(pts[:frames], mask[:frames])
    st = pipe.state
    _, T, fc, seg = tpipe.front_step(st, torch.from_numpy(pts[frames]),
                                     torch.from_numpy(mask[frames]),
                                     torch.tensor(0.2 * frames), cfg)
    return st.mapping, (T, fc.less_sharp_pts, fc.less_sharp_valid, fc.less_flat_pts,
                        fc.less_flat_valid, seg.outlier_points, seg.outlier_valid,
                        torch.tensor(0.2 * frames))


def _numpy(tree):
    if hasattr(tree, "_fields"):
        return type(tree)(*(_numpy(t) for t in tree))
    return tree.numpy()


def test_mapping_step_selects_the_map(tiny_run, monkeypatch):
    cfg, pts, mask = tiny_run
    pallas_search(monkeypatch)
    ms, inputs = _mapping_inputs(cfg, pts, mask, 6)
    assert int(ms.graph.count) >= 2
    step = jax.jit(lambda m, *a: jlm.mapping_step(m, *a, cfg))
    rebuilt = tlm._build_local_map(ms, cfg)
    for dirty in (False, True):
        ms_d = ms._replace(map_dirty=torch.tensor(dirty))
        # the cached map is the one of frame 4, before frame 5's keyframe:
        # a rebuild would differ from it
        m_np = _numpy(ms_d)
        ms_j, T_j = step(jlm.MappingState(*m_np)._replace(graph=jpg.PoseGraph(*m_np.graph)),
                         *(jnp.asarray(a.numpy()) for a in inputs))
        ms_t, T_t = tlm.mapping_step(tpipe._unflatten(ms_d, [t.clone() for _, t in
                                                             tpipe._flatten(ms_d)]),
                                     *inputs, cfg)
        assert_pose_close(T_t, np.asarray(T_j))
        assert int(ms_t.graph.count) == int(ms_j.graph.count)
        assert bool(ms_t.map_dirty) == bool(ms_j.map_dirty)
        want = rebuilt if dirty else (ms.map_corner, ms.map_corner_valid, ms.map_surf,
                                      ms.map_surf_valid)
        for name, w in zip(("map_corner", "map_corner_valid", "map_surf",
                            "map_surf_valid"), want):
            got = getattr(ms_t, name)
            assert torch.equal(got, w), (dirty, name)
            ref = np.asarray(getattr(ms_j, name))
            if got.dtype == torch.bool:
                np.testing.assert_array_equal(got.numpy(), ref, err_msg=f"{dirty} {name}")
            else:
                np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                                           atol=1e-3 * cfg.surf_leaf, err_msg=f"{dirty} {name}")
    assert not torch.equal(rebuilt[3], ms.map_surf_valid), "the cached map is not stale"


def _ptrs(pipe):
    return [t.data_ptr() for _, t in tpipe._flatten(pipe.state)]


def _eager_frames(cfg, st, pts, mask, frames, attempt_after=(), clock=None):
    """``slam_step`` over ``frames`` from ``st``, with a hoisted loop
    attempt after each frame in ``attempt_after`` (where the pipeline makes
    its own: after a frame, or a chunk, that crossed the loop cadence).
    ``clock``: the frames' stamps, by default ``f * scan_period``.  Returns
    the state and the poses."""
    out = []
    for f in frames:
        t = f * cfg.scan_period if clock is None else float(clock[f])
        st, pose = tpipe.slam_step(st, torch.from_numpy(pts[f]), torch.from_numpy(mask[f]),
                                   torch.full((), t), cfg,
                                   do_map_static=f % cfg.map_frame_decimation == 0,
                                   do_loop_static=False)
        out.append(pose)
        if f in attempt_after:
            st = st._replace(mapping=tlm.loop_closure_step(st.mapping, cfg)[0])
    return st, torch.stack(out).numpy()


def test_static_state_identity(tiny_run, tmp_path):
    cfg, pts, mask = tiny_run
    pipe = tpipe.SlamPipeline(cfg, device="cpu")
    ptrs = _ptrs(pipe)
    st = tpipe.init_state(cfg, "cpu")

    # an IMU flush before frame 0, then frames 0-3 through process (the
    # hoisted attempt after frame 2)
    imu = (0.0, (0.0, 0.01, 0.02), (0.1, 0.0, 9.8))
    pipe.add_imu(*imu)
    rows = torch.tensor([[imu[0], *imu[1], *imu[2]]])
    st = st._replace(imu=tdk.integrate_imu_chunk(st.imu, rows[:, 0], rows[:, 1:4],
                                                 rows[:, 4:7], 1))
    est = np.stack([pipe.process(pts[f], mask[f]).numpy() for f in range(4)])
    st, want = _eager_frames(cfg, st, pts, mask, range(4), attempt_after=(2,))
    np.testing.assert_array_equal(est, want)
    assert int(pipe.state.mapping.loop_attempts) == 1 and _ptrs(pipe) == ptrs
    tpipe.commit(pipe.state, pipe.state)       # a commit onto itself moves nothing
    assert _ptrs(pipe) == ptrs

    # a forced compaction, a checkpoint, then frames 4-7 through run_scanned
    # (the hoisted attempt after the chunk)
    pipe._maybe_compact(margin=cfg.max_keyframes)
    st = st._replace(mapping=tlm.compact_keyframes(st.mapping, cfg))
    assert pipe.compactions == 1 and _ptrs(pipe) == ptrs
    ck = str(tmp_path / "state.npz")
    pipe.save_checkpoint(ck)
    st_ck = st
    est = pipe.run_scanned(pts[4:8], mask[4:8])
    clock = np.arange(8, dtype=np.float32) * np.float32(cfg.scan_period)
    st, want = _eager_frames(cfg, st, pts, mask, range(4, 8), attempt_after=(7,), clock=clock)
    np.testing.assert_array_equal(est, want)
    assert int(pipe.state.mapping.loop_attempts) == 2 and _ptrs(pipe) == ptrs
    for (path, a), (_, b) in zip(tpipe._flatten(pipe.state), tpipe._flatten(st)):
        assert torch.equal(a, b), path

    # back to the checkpoint: frames 4-5 again
    pipe.load_checkpoint(ck)
    assert _ptrs(pipe) == ptrs and pipe._frame == 4
    est = np.stack([pipe.process(pts[f], mask[f]).numpy() for f in (4, 5)])
    _, want = _eager_frames(cfg, st_ck, pts, mask, (4, 5), attempt_after=(5,))
    np.testing.assert_array_equal(est, want)

    # reset: frames 0-1 again from a fresh state
    pipe.reset()
    assert _ptrs(pipe) == ptrs and int(pipe.state.frame) == 0
    est = pipe.run(pts[:2], mask[:2])
    _, want = _eager_frames(cfg, tpipe.init_state(cfg, "cpu"), pts, mask, range(2))
    np.testing.assert_array_equal(est, want)
    assert _ptrs(pipe) == ptrs
