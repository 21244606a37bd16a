"""The device renderer against the port's host renderer, at tiny size on
the CPU: the same worlds and routes, the same hit mask, the same points to
float32 rounding."""

import numpy as np
import pytest

import render
import tiny  # noqa: F401  (puts the repository on sys.path)
from alego_tpu_torch import tiny_config
from alego_tpu_torch.utils import synthetic


@pytest.mark.parametrize("laser", ["rfans", "lslidar"])
def test_render_matches_synthetic(laser):
    cfg = tiny_config() if laser == "rfans" else tiny_config(
        laser_type=0, ang_bottom_deg=15.1, ground_scan_id=7)
    gt = synthetic.loop_trajectory(24, radius=30.0, closed=True)
    poses = render.circuit(30.0, 24, 1)
    assert np.array_equal(gt, poses)
    w0 = synthetic.make_world(seed=11, clear_path=gt[:, :2, 3])
    w1 = render.make_world(seed=11, clear_path=poses[:, :2, 3])
    assert np.array_equal(w0.boxes, w1.boxes) and np.array_equal(w0.cylinders, w1.cylinders)
    p0, m0 = synthetic.render_sequence(w0, gt[:5], cfg)
    p1, m1 = render.render(w1, poses[:5], cfg, 0.0, 1, "cpu", batch=2)
    assert np.array_equal(m0, m1)
    np.testing.assert_allclose(p1[m1], p0[m0], rtol=2 ** -23, atol=0)


def test_arc_matches_open_loop():
    gt = synthetic.loop_trajectory(30, radius=120.0, speed=0.98, closed=False)
    assert np.array_equal(gt, render.arc(120.0, 30, 0.98))


def test_noise_follows_the_seed():
    cfg = tiny_config()
    poses = render.circuit(30.0, 12, 1)[:2]
    world = render.make_world(seed=3, clear_path=poses[:, :2, 3])
    a = render.render(world, poses, cfg, 0.01, 2 ** 40 + 7, "cpu")
    b = render.render(world, poses, cfg, 0.01, 2 ** 40 + 7, "cpu")
    c = render.render(world, poses, cfg, 0.01, 2 ** 40 + 8, "cpu")
    assert np.array_equal(a[0], b[0]) and not np.array_equal(a[0], c[0])
