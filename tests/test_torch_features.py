"""Feature extraction of the port against the JAX reference on the same
segmented scans: masks and rings equal, compacted points equal.

Voxel centroids (the less-flat cloud) are held to 1e-5 m against an exact
f64 oracle.  Against the reference they agree to 1e-3 of the leaf: the
reference forms each voxel's sum as a difference of blocked f32 prefix sums
(a TPU compiler workaround, alego_tpu/ops/voxel.py:53-67), which its own
docstring bounds at ~1e-3 of the leaf and which measures up to ~2e-4 m here;
the port's f64 segment sums are exact to f32 rounding."""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from alego_tpu.ops import features as jfeat, projection as jproj, segmentation as jseg
from alego_tpu.ops import voxel as jvox
from alego_tpu.utils import synthetic

from alego_tpu_torch.ops import features as tfeat, segmentation as tseg, voxel as tvox
from alego_tpu_torch.models.pipeline import tree_from_reference

# one intra-op thread: the suite runs in several test processes at once,
# where more threads per process only contend for the cores
torch.set_num_threads(1)


@functools.lru_cache(maxsize=None)
def _programs(cfg):
    """The reference's programs for ``cfg``, each compiled once per file."""
    def labels_of(s):
        curv, win = jfeat.curvature_and_window(s, cfg)
        picked0 = jfeat.occlusion_mask(s, cfg)
        labels = jax.vmap(lambda c, co, g, p, w, n: jfeat._pick_ring_parallel(
            c, co, g, p, w, n, cfg))(curv, s.cols, s.ground, picked0, win, s.counts)
        return (labels <= 0) & win & s.valid

    return dict(
        segment=jax.jit(lambda p, q: jseg.segment_scan(jproj.project_scan(p, q, cfg), cfg)),
        features=jax.jit(lambda s: jfeat.extract_features(s, cfg)),
        less_flat_mask=jax.jit(labels_of))


def _segmented(cfg, world, pose):
    pts = synthetic.render_scan(world, pose, cfg, noise=0.01)
    good = np.isfinite(pts).all(-1)
    n = cfg.max_raw_points
    pad = np.zeros((n, 3), np.float32)
    m = np.zeros(n, bool)
    pad[: good.sum()] = pts[good]
    m[: good.sum()] = True
    return _programs(cfg)["segment"](jnp.asarray(pad), jnp.asarray(m))


def _less_flat_oracle(seg_j, cfg):
    """Exact f64 centroids of the less-flat cloud, slot by slot: the
    reference's less-flat points per ring, grouped by the reference's hashed
    voxel key, voxels in ascending key order, cut to the ring's capacity."""
    lf_mask = np.asarray(_programs(cfg)["less_flat_mask"](seg_j))
    pts = np.asarray(seg_j.points)
    # the reference's keys, point by point (one call for every ring)
    keys_all = np.asarray(jvox.voxel_key(seg_j.points, cfg.less_flat_leaf, 256.0))
    R = pts.shape[0]
    cap = cfg.max_less_flat // R
    out = np.zeros((R, cap, 3))
    ok = np.zeros((R, cap), bool)
    for r in range(R):
        p = pts[r][lf_mask[r]]
        keys = keys_all[r][lf_mask[r]]
        uniq, inv = np.unique(keys, return_inverse=True)
        sums = np.zeros((len(uniq), 3))
        np.add.at(sums, inv, p.astype(np.float64))
        n = min(len(uniq), cap)
        out[r, :n] = (sums / np.bincount(inv)[:, None])[:n]
        ok[r, :n] = True
    return out.reshape(-1, 3), ok.reshape(-1)


@pytest.mark.parametrize("frame", [0, 3])
def test_features_match_reference(cfg, world, frame):
    pose = synthetic.loop_trajectory(4, radius=20.0, speed=1.0, closed=False)[frame]
    seg_j = _segmented(cfg, world, pose)
    seg_t = tree_from_reference(tseg.SegmentedScan,
                                jax.tree_util.tree_map(np.asarray, seg_j), "cpu")

    fc_j = _programs(cfg)["features"](seg_j)
    fc_t = tfeat.extract_features(seg_t, cfg)
    for name in fc_j._fields:
        a, b = getattr(fc_t, name).numpy(), np.asarray(getattr(fc_j, name))
        assert a.shape == b.shape and a.dtype == b.dtype, name
        if name == "less_flat_pts":
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-3 * cfg.less_flat_leaf,
                                       err_msg=name)
        else:
            np.testing.assert_array_equal(a, b, err_msg=name)
    assert fc_t.sharp_valid.sum() > 5 and fc_t.flat_valid.sum() > 20
    assert fc_t.less_flat_valid.sum() > 100

    # the port's voxel centroids against exact ones, slot by slot
    want, want_ok = _less_flat_oracle(seg_j, cfg)
    np.testing.assert_array_equal(fc_t.less_flat_valid.numpy(), want_ok)
    np.testing.assert_allclose(fc_t.less_flat_pts.numpy()[want_ok], want[want_ok],
                               rtol=0, atol=1e-5)


def test_curvature_and_occlusion_match_reference(cfg, world):
    seg_j = _segmented(cfg, world, np.eye(4))
    seg_t = tree_from_reference(tseg.SegmentedScan,
                                jax.tree_util.tree_map(np.asarray, seg_j), "cpu")
    curv_j, win_j = jfeat.curvature_and_window(seg_j, cfg)
    curv_t, win_t = tfeat.curvature_and_window(seg_t, cfg)
    np.testing.assert_allclose(curv_t.numpy(), np.asarray(curv_j), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(win_t.numpy(), np.asarray(win_j))
    np.testing.assert_array_equal(tfeat.occlusion_mask(seg_t, cfg).numpy(),
                                  np.asarray(jfeat.occlusion_mask(seg_j, cfg)))


@pytest.mark.parametrize("cap", [64, 4096])
def test_voxel_downsample_matches_reference(cap):
    """Slot order (ascending hashed key) decides which voxels survive an
    overflowing capacity: both the kept set and its order must match."""
    rng = np.random.default_rng(5)
    pts = rng.uniform(-40, 40, (3000, 3)).astype(np.float32)
    mask = rng.random(3000) < 0.8
    leaf = 0.8
    p_j, m_j = jax.jit(jvox.voxel_downsample, static_argnums=(2, 3))(
        jnp.asarray(pts), jnp.asarray(mask), leaf, cap)
    p_t, m_t = tvox.voxel_downsample(torch.from_numpy(pts), torch.from_numpy(mask), leaf, cap)
    np.testing.assert_array_equal(m_t.numpy(), np.asarray(m_j))
    np.testing.assert_allclose(p_t.numpy(), np.asarray(p_j), rtol=0, atol=1e-3 * leaf)

    # exact f64 centroids per cell
    cells = {}
    for p in pts[mask].astype(np.float64):
        acc = cells.setdefault(tuple(np.floor(p / leaf).astype(int)), [0.0, 0])
        acc[0] = acc[0] + p
        acc[1] += 1
    got = p_t.numpy()[m_t.numpy()]
    assert len(got) == min(cap, len(cells))
    for c in got:
        s, n = cells[tuple(np.floor(c / leaf).astype(int))]
        np.testing.assert_allclose(c, s / n, rtol=0, atol=1e-5)
    keys_j = np.asarray(jvox.voxel_key(jnp.asarray(pts), 0.8, 256.0))
    np.testing.assert_array_equal(tvox.voxel_key(torch.from_numpy(pts), 0.8, 256.0).numpy(),
                                  keys_j)
