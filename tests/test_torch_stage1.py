"""Stage 1 of the port (projection + segmentation) against the JAX
reference on the same scans: integer, mask and label fields bit-equal, f32
fields within 1e-6 relative."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from alego_tpu.ops import projection as jproj, segmentation as jseg
from alego_tpu.utils import synthetic

from alego_tpu_torch.ops import projection as tproj, segmentation as tseg

# one intra-op thread: the suite runs in several test processes at once,
# where more threads per process only contend for the cores
torch.set_num_threads(1)

EXACT_IMG = ("valid", "ground")
EXACT_SEG = ("cols", "ground", "valid", "counts", "outlier_valid", "outlier_cols")


def _scan(cfg, world, pose, duplicates=False):
    """Padded scan; with ``duplicates``, 500 returns fire again later in
    arrival order at a slightly longer range (same pixel: the later arrival
    must win).  Returns (points, mask, the re-fired points)."""
    pts = synthetic.render_scan(world, pose, cfg, noise=0.01)
    pts = pts[np.isfinite(pts).all(-1)]
    dup = np.zeros((0, 3), np.float32)
    if duplicates:
        rng = np.random.default_rng(1)
        dup = pts[rng.choice(len(pts), 500, replace=False)] * np.float32(1.002)
        pts = np.concatenate([pts, dup])
    n = cfg.max_raw_points
    assert len(pts) <= n
    out = np.zeros((n, 3), np.float32)
    mask = np.zeros(n, bool)
    out[: len(pts)] = pts
    mask[: len(pts)] = True
    return out, mask, dup


def _compare(port, ref, exact, rtol=1e-6):
    for name in ref._fields:
        a = getattr(port, name).numpy()
        b = np.asarray(getattr(ref, name))
        assert a.shape == b.shape, name
        if name in exact:
            np.testing.assert_array_equal(a, b, err_msg=name)
        else:
            np.testing.assert_allclose(a, b, rtol=rtol, atol=1e-6, err_msg=name)


@pytest.fixture(scope="module")
def jax_stage1(cfg):
    return (jax.jit(lambda p, m: jproj.project_scan(p, m, cfg)),
            jax.jit(lambda img: jseg.label_components(img, cfg)),
            jax.jit(lambda img: jseg.segment_scan(img, cfg)))


@pytest.mark.parametrize("duplicates", [False, True])
def test_stage1_matches_reference(cfg, world, jax_stage1, duplicates):
    j_project, j_label, j_segment = jax_stage1
    pose = synthetic.loop_trajectory(4, radius=20.0, speed=1.0, closed=False)[2]
    pts, mask, dup = _scan(cfg, world, pose, duplicates)

    img_j = j_project(jnp.asarray(pts), jnp.asarray(mask))
    img_t = tproj.project_scan(torch.from_numpy(pts), torch.from_numpy(mask), cfg)
    _compare(img_t, img_j, EXACT_IMG)
    if duplicates:   # the re-fired returns won their pixels
        won = img_t.points.numpy().reshape(-1, 3)
        assert (np.isin(dup[:, 0], won[:, 0]) & np.isin(dup[:, 1], won[:, 1])).mean() > 0.95

    # segmentation from the SAME range image
    lab_j, ok_j, out_j = j_label(img_j)
    lab_t, ok_t, out_t = tseg.label_components(img_t, cfg)
    np.testing.assert_array_equal(lab_t.numpy(), np.asarray(lab_j))
    np.testing.assert_array_equal(ok_t.numpy(), np.asarray(ok_j))
    np.testing.assert_array_equal(out_t.numpy(), np.asarray(out_j))
    assert ok_t.sum() > 500 and out_t.sum() > 0

    _compare(tseg.segment_scan(img_t, cfg), j_segment(img_j), EXACT_SEG)


def test_empty_scan(cfg):
    n = cfg.max_raw_points
    pts = np.zeros((n, 3), np.float32)
    mask = np.zeros(n, bool)
    img = tproj.project_scan(torch.from_numpy(pts), torch.from_numpy(mask), cfg)
    seg = tseg.segment_scan(img, cfg)
    assert not img.valid.any() and not seg.valid.any()
    assert int(seg.counts.sum()) == 0 and not seg.outlier_valid.any()
    assert float(img.orient_diff) == pytest.approx(2 * np.pi)
