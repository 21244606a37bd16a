"""The plain reference against the port's CPU path at ``tiny_config``: the
start of a drive from each side's fresh state, and single frames from the
port's state carried into the reference.  The reference imports nothing of
the port (checked in its own process)."""

import json
import os
import subprocess
import sys

import numpy as np
import torch

import check
import render
import run
import tiny
from alego_tpu_torch import tiny_config
from alego_tpu_torch.models.pipeline import SlamPipeline
from reference import config as rconfig

torch.set_num_threads(2)


def _drive(n=10):
    cfg = tiny_config(loop_in_step=False)
    poses = render.arc(20.0, n, 1.0)
    world = render.make_world(seed=7, clear_path=poses[:, :2, 3])
    pts, mask = render.render(world, poses, cfg, 0.01, 1, "cpu")
    rcfg = run.pipeline_config(rconfig.PipelineConfig, tiny.tiny_fields(), rconfig.LaserType)
    return cfg, rcfg, pts, mask


def test_reference_follows_the_port():
    cfg, rcfg, pts, mask = _drive()
    pipe = SlamPipeline(cfg, device="cpu")
    poses, steps = [], []
    for k in range(pts.shape[0]):
        pre = check.snapshot(pipe.state) if k in (4, 7) else None
        poses.append(pipe.process(pts[k], mask[k]).numpy())
        if pre is not None:
            steps.append((k, 1, pre, poses[-1][None], check.outcome(pipe.state)))
    feed = check.Feed(1, cfg.scan_period, cfg.map_frame_decimation, cfg.loop_every_n_frames)
    ref = check.Reference(rcfg, pts, mask, feed, "cpu")
    out = check.compare(ref, np.stack(poses[:6]), steps)
    assert out["steps"] == 2 and out["discrete_diff"] == 0
    assert out["start_gap_m"] < 1e-3 and out["step_gap_m"] < 1e-4 and out["kf_gap_m"] < 1e-4


def test_control_fails_the_limits():
    """The control (the reference in TF32) in the program's place fails
    the limits of the cells: its own start, and its own states' steps."""
    cfg, rcfg, pts, mask = _drive(8)
    feed = check.Feed(1, cfg.scan_period, cfg.map_frame_decimation, cfg.loop_every_n_frames)
    ref = check.Reference(rcfg, pts, mask, feed, "cpu")
    ctl = check.Reference(rcfg, pts, mask, feed, "cpu", control=True)
    state, poses = ctl.run(ctl.fresh(), 0, 5)
    after, step_pose = ctl.run(state, 5, 1)
    steps = [(5, 1, check.snapshot(state), step_pose, check.outcome(after))]
    numbers = check.compare(ref, poses, steps)
    for cell in ("rfans16_5hz.patrol", "vlp16_10hz.patrol", "rfans16_5hz.survey"):
        with open(os.path.join(tiny.BENCH, "cells", cell + ".json")) as f:
            limits = json.load(f)["check"]["limits"]
        assert not check.judge(numbers, limits)[0], (cell, numbers)


def test_reference_imports_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, 'portbench'); "
            "import reference.pipeline, reference.precision, check; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('alego_tpu_torch', 'alego_tpu', 'jax', 'jaxlib', 'flax')); print(bad)")
    out = subprocess.run([sys.executable, "-c", code], cwd=tiny.ROOT, capture_output=True,
                         text=True, check=True).stdout.strip()
    assert out == "[]"
