"""The one traffic generator: reads a mix's parameters
(``traffic/<mix>.json``) and a configuration, and makes the drive from the
seed: the ground-truth route, the world around it, and its scans rendered
on the device (``render.py``).

A mix names:

- ``route``: ``circuit`` (``radius_m``, ``laps``) or ``arc`` (``radius_m``,
  ``length_m``), driven at ``speed_mps``; the sensor's sweep period sets how
  many frames that makes;
- ``world``: ``square`` (``n_boxes``, ``n_cylinders``, ``extent_m``: the
  port's synthetic world) or ``corridor`` (``n_boxes``, ``n_cylinders``
  along the route within ``half_width_m``), made from ``seed``;
- ``noise_m``: the range noise's sigma;
- ``feed``: ``chunk`` sweeps a call (1: ``SlamPipeline.process`` and the
  pose read after each; more: ``run_scanned``, which reads a chunk's poses
  once);
- ``warmup``: ``until_attempt`` (run a drive until its first loop attempt
  has been captured) or ``frames``.

The world is the mix's own (``world.seed``), so every run's drive has the
same geometry, loop candidates and work; the run's seed draws the range
noise, so no two seeds hand the program the same scans.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np

import render


class Drive(NamedTuple):
    poses: np.ndarray    # [n, 4, 4] ground truth
    points: np.ndarray   # [n, P, 3] float32, the scans as a driver hands them over
    mask: np.ndarray     # [n, P] bool
    chunk: int
    warmup: dict


def route(mix: dict, scan_period: float) -> np.ndarray:
    r = mix["route"]
    step = r["speed_mps"] * scan_period
    if r["kind"] == "circuit":
        per_lap = int(round(2 * math.pi * r["radius_m"] / step)) + 1
        return render.circuit(r["radius_m"], per_lap, int(r["laps"]))
    if r["kind"] == "arc":
        return render.arc(r["radius_m"], int(round(r["length_m"] / step)), step)
    raise ValueError(f"unknown route kind {r['kind']!r}")


def world(mix: dict, poses: np.ndarray, seed: int) -> render.World:
    w = mix["world"]
    path = poses[:, :2, 3]
    if w["kind"] == "square":
        return render.make_world(seed=seed, n_boxes=w["n_boxes"], n_cyl=w["n_cylinders"],
                                 extent=w["extent_m"], clear_path=path)
    if w["kind"] == "corridor":
        return render.make_corridor_world(path, seed, w["n_boxes"], w["n_cylinders"],
                                          w["half_width_m"])
    raise ValueError(f"unknown world kind {w['kind']!r}")


def noise_seed(seed: int) -> int:
    """The range noise's seed from the run's seed (any size)."""
    return int(np.random.SeedSequence(seed).generate_state(1, dtype=np.uint64)[0])


def drive(mix: dict, cfg, seed: int, device) -> Drive:
    poses = route(mix, cfg.scan_period)
    points, mask = render.render(world(mix, poses, mix["world"]["seed"]), poses, cfg,
                                 mix["noise_m"], noise_seed(seed), device)
    return Drive(poses, points, mask, int(mix["feed"]["chunk"]), mix["warmup"])
