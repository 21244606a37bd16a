"""The port's last small pieces against the JAX reference.

* the sequential sector picker (``parallel_sectors=False``): labels equal
  to the reference's ``_pick_ring`` (vmapped over rings) on the same
  curvature, occlusion marks and windows of a rendered frame, and the
  whole ``extract_features`` runs with it;
* ``voxel.merge_masked``: equal to the reference's;
* ``eig3.solve_spd_3x3``: within 1e-5 relative of the reference's on
  random SPD systems, and finite where both clamp ill-conditioned pivots;
* ``utils/sensor_sim``: the same scene, circuit and scans from the same
  seed;
* ``utils/profiling.device_trace``: writes a Chrome trace of the block.
"""

import json
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from alego_tpu.ops import eig3 as jeig3, features as jfeat, voxel as jvoxel
from alego_tpu.utils import sensor_sim as jsim

from alego_tpu_torch.models.image_projection import image_projection
from alego_tpu_torch.ops import eig3 as teig3, features as tfeat, voxel as tvoxel
from alego_tpu_torch.utils import profiling, sensor_sim as tsim, synthetic

# one intra-op thread: the suite runs in several test processes at once,
# where more threads per process only contend for the cores
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def picker_inputs(cfg, world):
    """Curvature, columns, ground, occlusion marks, windows and counts of a
    rendered frame (the port's front half; both pickers read the same)."""
    poses = synthetic.loop_trajectory(2, radius=20.0, speed=1.0, closed=False)
    pts, mask = synthetic.render_sequence(world, poses, cfg, noise=0.01)
    seg = image_projection(torch.from_numpy(pts[1]), torch.from_numpy(mask[1]), cfg)
    curv, in_window = tfeat.curvature_and_window(seg, cfg)
    return seg, (curv, seg.cols, seg.ground, tfeat.occlusion_mask(seg, cfg), in_window,
                 seg.counts)


def test_sequential_picker_matches_reference(cfg, picker_inputs):
    seg, args = picker_inputs
    cfg = cfg.replace(parallel_sectors=False)
    got = tfeat._pick_rings_sequential(*args, cfg).numpy()
    pick = jax.jit(jax.vmap(lambda c, co, g, p, w, n: jfeat._pick_ring(c, co, g, p, w, n, cfg)))
    want = np.asarray(pick(*(jnp.asarray(a.numpy()) for a in args)))
    np.testing.assert_array_equal(got, want)
    assert (got == 2).sum() > 0 and (got == -1).sum() > 0
    # the whole stage with it: the labels above become the feature sets
    fc = tfeat.extract_features(seg, cfg)
    assert int(fc.sharp_valid.sum()) == int((got == 2).sum())
    assert int(fc.flat_valid.sum()) == int((got == -1).sum())


def test_merge_masked_matches_reference():
    rng = np.random.default_rng(0)
    sets = [(rng.normal(size=(n, 3)).astype(np.float32), rng.random(n) < 0.5)
            for n in (40, 7, 25)]
    for cap in (16, 100):
        got = tvoxel.merge_masked([torch.from_numpy(p) for p, _ in sets],
                                  [torch.from_numpy(m) for _, m in sets], cap)
        want = jvoxel.merge_masked([jnp.asarray(p) for p, _ in sets],
                                   [jnp.asarray(m) for _, m in sets], cap)
        # the reference keeps min(n, cap) slots, the port always cap: the
        # port's extra slots are empty
        n = want[0].shape[0]
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g[:n].numpy(), np.asarray(w))
            assert not g[n:].any()
        assert got[0].shape == (cap, 3)


def test_solve_spd_3x3_matches_reference():
    rng = np.random.default_rng(1)
    M = rng.normal(size=(256, 3, 3)).astype(np.float32)
    A = M @ np.swapaxes(M, 1, 2) + 0.1 * np.eye(3, dtype=np.float32)
    b = rng.normal(size=(256, 3)).astype(np.float32)
    got = teig3.solve_spd_3x3(torch.from_numpy(A), torch.from_numpy(b)).numpy()
    want = np.asarray(jeig3.solve_spd_3x3(jnp.asarray(A), jnp.asarray(b)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6 * np.abs(want).max())
    np.testing.assert_allclose(np.einsum("nij,nj->ni", A, got), b, rtol=0, atol=1e-3)
    # five near-collinear points at ~100 m: the relative pivot clamp keeps it finite
    p = 100.0 + np.linspace(0, 1, 5)[:, None] * np.array([1.0, 1e-4, 1e-4])
    C = (p.T @ p).astype(np.float32)[None]
    got = teig3.solve_spd_3x3(torch.from_numpy(C), torch.ones((1, 3))).numpy()
    want = np.asarray(jeig3.solve_spd_3x3(jnp.asarray(C), jnp.ones((1, 3))))
    assert np.isfinite(got).all() and np.isfinite(want).all()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)


def test_sensor_sim_matches_reference(cfg):
    t_scene, j_scene = tsim.make_urban_scene(seed=2), jsim.make_urban_scene(seed=2)
    for name in ("boxes", "cylinders", "spheres"):
        np.testing.assert_array_equal(getattr(t_scene, name), getattr(j_scene, name))
    poses = tsim.street_circuit(6)
    np.testing.assert_array_equal(poses, jsim.street_circuit(6))
    got = tsim.simulate_sequence(t_scene, poses[:2], cfg, seed=5)
    want = jsim.simulate_sequence(j_scene, poses[:2], cfg, seed=5)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert got[1].sum() > 1000


def test_device_trace_writes_a_trace(tmp_path):
    with profiling.device_trace(str(tmp_path / "trace")):
        torch.ones(64).cumsum(0)
    with open(os.path.join(tmp_path, "trace", "trace.json")) as f:
        trace = json.load(f)
    assert any("cumsum" in ev.get("name", "") for ev in trace["traceEvents"])
