#!/usr/bin/env python3
"""Where the port's run and the JAX reference's part on the bench circuit,
one frame at a time, at the full default geometry, on the CPU.

Usage, from the root of the repository:

    JAX_PLATFORMS=cpu python3 tools/reference_bisect.py [--frames 10] [--threads 8]

Both sides run ``SlamPipeline(PipelineConfig().replace(loop_in_step=
False))`` over the first ``--frames`` frames of the circuit that
``tools/reference_circuit.py`` records (the reference with its searches
routed to difference-squares, that tool's ``diff_squares`` route; the
port on the CPU, each kernel's plain version).  Per frame f it prints:

- ``run``: how far the two runs' poses at f lie apart (translation m,
  rotation rad from the rotation vector of R_a^T R_b, in f64);
- ``port_from_reference``: the port's step for frame f from the
  reference's state before f (``state_from_reference``) against the
  reference's pose at f: the port's error in one step at equal inputs;
- ``reference_from_port``: the reference's step from the port's state
  against the port's pose at f;
- ``map_iters``: on a mapping frame, the iterations each of the port's
  outer scan-to-map solves ran (its plain solve's ``iters_out``) beside
  their cap ``map_gn_iters``: a solve at its cap returns wherever its last
  iteration lands.

A gap that one step from equal inputs keeps small but the runs grow is
carried state: the recursive pipeline amplifies each frame's small
differences (PERF.md §2).  ~3 min for 10 frames on an 8-core x86 host.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import jax

jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [REPO, os.path.join(REPO, "tools")]

import reference_circuit as rc  # noqa: E402
from alego_tpu import PipelineConfig as RefConfig  # noqa: E402
from alego_tpu.models.pipeline import SlamPipeline as RefPipeline  # noqa: E402
from alego_tpu.utils import synthetic  # noqa: E402
from alego_tpu_torch import PipelineConfig  # noqa: E402
from alego_tpu_torch.models import laser_mapping, pipeline  # noqa: E402
from alego_tpu_torch.ops import gauss_newton  # noqa: E402


def gap(a, b):
    """(translation m, rotation rad) between two poses [3 or 4, 4]
    (``chip_smoke.pose_gaps``)."""
    g = rc.smoke.pose_gaps(np.asarray(a)[None], np.asarray(b)[None])
    return g["max_m"], g["max_rad"]


class MappingIters:
    """The iterations each scan-to-map solve of the port ran, by wrapping
    ``laser_mapping.solve_correspondences`` with the plain solve asked for
    ``iters_out`` (the same solve the CPU runs)."""

    def __init__(self):
        self.log = []

    def __enter__(self):
        def solve(corr, params0, iters, dim_mask, huber_delta, **kw):
            done = torch.zeros(1, dtype=torch.int32)
            out = gauss_newton.solve_correspondences_plain(
                corr, params0, iters, dim_mask, huber_delta, **kw, iters_out=done)
            self.log.append(int(done))
            return out
        laser_mapping.solve_correspondences = solve
        return self

    def __exit__(self, *exc):
        laser_mapping.solve_correspondences = gauss_newton.solve_correspondences


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--frames", type=int, default=10)
    ap.add_argument("--threads", type=int, default=8,
                    help="torch's intra-op threads for the port (its CPU sums' order)")
    args = ap.parse_args(argv)
    torch.set_num_threads(args.threads)
    n = args.frames
    cfg, ref_cfg = PipelineConfig().replace(loop_in_step=False), \
        RefConfig().replace(loop_in_step=False)
    poses = synthetic.loop_trajectory(rc.N_CIRCUIT, radius=30.0, speed=1.6, closed=True)
    world = synthetic.make_world(seed=100, clear_path=poses[:, :2, 3])
    pts, mask = synthetic.render_sequence(world, poses[:n], ref_cfg, noise=0.01, seed=0)

    with rc.routed("diff_squares"):
        ref = RefPipeline(ref_cfg)
        treedef = jax.tree_util.tree_flatten(ref.state)[1]
        port = pipeline.SlamPipeline(cfg, device="cpu")
        ref_states, port_states, ref_T, port_T, iters = [], [], [], [], []
        for f in range(n):
            ref_states.append(jax.tree_util.tree_map(np.asarray, ref.state))
            port_states.append([t.clone() for _, t in pipeline._flatten(port.state)])
            ref_T.append(np.asarray(ref.process(pts[f], mask[f])))
            with MappingIters() as rec:
                port_T.append(port.process(pts[f], mask[f]).numpy())
            iters.append(rec.log)
        for f in range(1, n):
            one = pipeline.SlamPipeline(cfg, device="cpu")
            one.state = pipeline.state_from_reference(ref_states[f], "cpu", cfg)
            one._frame = f
            T_port = one.process(pts[f], mask[f]).numpy()
            back = RefPipeline(ref_cfg)
            back.state = jax.tree_util.tree_unflatten(
                treedef, [jnp.asarray(t.numpy()) for t in port_states[f]])
            back._frame = f
            T_ref = np.asarray(back.process(pts[f], mask[f]))
            row = dict(frame=f, run=gap(port_T[f], ref_T[f]),
                       port_from_reference=gap(T_port, ref_T[f]),
                       reference_from_port=gap(T_ref, port_T[f]))
            if iters[f]:
                row["map_iters"] = iters[f]
                row["map_gn_iters"] = cfg.map_gn_iters
            print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
