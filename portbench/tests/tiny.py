"""A tiny benchmark tree for the CPU tests: the real ``portbench/`` copied
beside a ``BENCHMARK.json`` whose cells run the port's ``tiny_config``
(16x900) on short drives, so ``run.main`` can drive a whole run on the CPU."""

from __future__ import annotations

import dataclasses
import json
import os
import shutil

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH)

LIMITS = {"start_gap_m": 1e-3, "step_gap_m": 1e-3, "last_gap_m": 1e-3, "kf_gap_m": 1e-3,
          "discrete_diff": 0}


def tiny_fields() -> dict:
    import sys
    sys.path.insert(0, ROOT)
    from alego_tpu_torch import tiny_config
    cfg = tiny_config(loop_in_step=False)
    out = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        out[f.name] = list(v) if isinstance(v, tuple) else int(v) if hasattr(v, "value") else v
    return out


def make(tmp: str, frames: int = 12, chunk: int = 1) -> str:
    """A tree at ``tmp`` with the cell ``tiny.drive``: an open arc of
    ``frames`` sweeps fed ``chunk`` at a time.  Returns ``tmp``."""
    bench = os.path.join(tmp, "portbench")
    shutil.copytree(BENCH, bench, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    with open(os.path.join(bench, "configs", "tiny.json"), "w") as f:
        json.dump({"source": "tiny_config", "assumed": {}, "reduced": [],
                   "pipeline_config": tiny_fields()}, f)
    with open(os.path.join(bench, "traffic", "tinyarc.json"), "w") as f:
        json.dump({"route": {"kind": "arc", "radius_m": 20.0, "length_m": 1.0 * frames,
                             "speed_mps": 5.0},
                   "world": {"kind": "square", "seed": 7, "n_boxes": 14, "n_cylinders": 12,
                             "extent_m": 60.0},
                   "noise_m": 0.01, "feed": {"chunk": chunk},
                   "warmup": {"until_attempt": False, "frames": chunk}}, f)
    with open(os.path.join(bench, "cells", "tiny.drive.json"), "w") as f:
        json.dump({"check": {"start_frames": 4, "attempt_steps": 1, "other_steps": 1,
                             "step_frames": 0 if chunk == 1 else 2, "limits": LIMITS},
                   "trace": {"session": 1, "from_frame": 0, "frames": 4}}, f)
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        manifest = json.load(f)
    manifest["configs"].append({"name": "tiny", "source": "tiny_config",
                                "file": "portbench/configs/tiny.json", "reduced": [],
                                "why": "CPU tests"})
    manifest["workloads"].append({"name": "tiny.drive", "config": "tiny",
                                  "traffic": "tinyarc", "chips": 1, "why": "CPU tests"})
    for m in manifest["end_to_end"]:
        if m["name"] == "fps" and "workloads" in m:
            m["workloads"].append("tiny.drive")
    with open(os.path.join(tmp, "BENCHMARK.json"), "w") as f:
        json.dump(manifest, f)
    return tmp
