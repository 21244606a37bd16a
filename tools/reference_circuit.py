#!/usr/bin/env python3
"""The JAX reference's answer on the 192-frame closed bench circuit at the
full default geometry, recorded as data for the port to be held against.

Usage, from the root of the repository, on the CPU:

    JAX_PLATFORMS=cpu python3 tools/reference_circuit.py

It writes ``tools/reference_circuit.json``.  ``chip_smoke.py``'s phase
``reference_agreement`` reads that file with ``json`` alone and holds the
port's runs on the card against it; ``tests/test_torch_reference_circuit.py``
checks that it is current.  Regenerate it whenever the reference's inputs
change (the circuit, its render, the default ``PipelineConfig``); the
port's own pins in ``chip_smoke.py`` are held apart from it.

The circuit is the one ``chip_smoke.py`` renders: ``loop_trajectory(192,
radius=30.0, speed=1.6, closed=True)``, ``make_world(seed=100, clear_path=
...)``, ``render_sequence(..., noise=0.01, seed=0)``, here through the
reference's ``alego_tpu/utils/synthetic.py``.  The reference's
``SlamPipeline(PipelineConfig().replace(loop_in_step=False))`` runs it on
two schedules:

- ``process``: frame by frame, a hoisted loop attempt every
  ``loop_every_n_frames`` frames (``chip_smoke.py``'s loop path; its first
  32 frames are the main path);
- ``scanned``: ``run_scanned`` in chunks of 16 on the frame clock (the
  CLI's ``--chunk 16`` streaming path), one hoisted attempt per chunk.

and each schedule with two neighbour-search routes:

- ``diff_squares``: the searches the port's kernels compute (the Pallas
  kernels' direct f32 difference-squares, ties to the lowest index), put in
  at the names the port's parity tests patch (``laser_odometry.nn1``,
  ``icp._nn1``, ``laser_mapping.knn``) as a plain ``jnp`` search
  (:func:`ds_knn`): Pallas interpret mode is far too slow at the loop
  shapes (2048 x 32768);
- ``as_is``: the reference as it stands on the CPU, whose searches use the
  ``|q|^2 - 2 q.r + |r|^2`` expansion (``alego_tpu/ops/knn.py``); the gap
  between its two routes is the reference's own sensitivity to rounding.

Per run the record holds the per-frame poses [192, 3, 4] (f32, shortest
repr), keyframe count and times, loop pairs (latest, closest keyframe),
loop count, attempts, ``overflow``, ``loop_overflow``, the unaligned ATE of
the streamed poses and of the corrected keyframe poses (as
``chip_smoke.py``'s ``_loop_results`` computes them) and the seconds the
run took; besides the runs, every ``PipelineConfig`` field, a sha256 per
rendered frame (points as little-endian f32 bytes, then the mask as bool
bytes), the JAX version and the command.

Seconds on an 8-core x86 CPU host shared with other work (three runs of
this tool, which recorded the same answer bit for bit): 28-36 s to
render, then 151-203 s for ``process`` / diff-squares, 211-248 s for
``process`` / as-is, 170-207 s for ``scanned`` / diff-squares and 190-211 s
for ``scanned`` / as-is, each with its compiles (``seconds`` per run in the
record): 773-907 s in all, peak resident memory 1.4 GiB.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import platform
import resource
import sys
import time

import numpy as np
import jax

jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as smoke  # noqa: E402  (numpy only: the record's reader)
from alego_tpu import PipelineConfig  # noqa: E402
from alego_tpu.models import laser_mapping, laser_odometry  # noqa: E402
from alego_tpu.models.pipeline import SlamPipeline  # noqa: E402
from alego_tpu.ops import icp  # noqa: E402
from alego_tpu.utils import synthetic  # noqa: E402
from alego_tpu.utils.metrics import ate_rmse  # noqa: E402

OUT, N_CIRCUIT, CHUNK = smoke.REFERENCE_RECORD, smoke.N_CIRCUIT, smoke.CHUNK
QUERY_BLOCK = 128      # queries per step of the diff-squares search
BIG = 1e30
SCHEDULES = ("process", "scanned")
ROUTES = ("diff_squares", "as_is")
RUNS = tuple(f"{s}/{r}" for s in SCHEDULES for r in ROUTES)


def ds_knn(query, qmask, ref, rmask, k, chunk=None):
    """The k nearest refs of each query by direct f32 difference-squares,
    the function of ``knn_pallas`` (and of the port's kernels): per query
    ``((dx*dx + dy*dy) + dz*dz)``, invalid refs at 1e30, the k smallest
    ascending with ties to the lowest index (``lax.top_k``), invalid
    queries at 1e30.  ``lax.map`` over blocks of QUERY_BLOCK queries keeps
    the distance matrix at [QUERY_BLOCK, N].  ``chunk`` is accepted and
    ignored (the signature of ``ops.knn.knn``)."""
    Q = query.shape[0]
    nb = -(-Q // QUERY_BLOCK)
    qp = jnp.zeros((nb * QUERY_BLOCK, 3), query.dtype).at[:Q].set(query)
    rT = ref.T

    def block(qb):
        d = jnp.zeros((qb.shape[0], ref.shape[0]), query.dtype)
        for c in range(3):
            diff = qb[:, c:c + 1] - rT[c][None, :]
            d = d + diff * diff
        d = jnp.where(rmask[None, :], d, BIG)
        neg, idx = jax.lax.top_k(-d, k)
        return -neg, idx.astype(jnp.int32)

    d, i = jax.lax.map(block, qp.reshape(nb, QUERY_BLOCK, 3))
    d, i = d.reshape(-1, k)[:Q], i.reshape(-1, k)[:Q]
    return jnp.where(qmask[:, None], jnp.maximum(d, 0.0), BIG), i


def ds_nn1(query, qmask, ref, rmask, chunk=None):
    """1-NN by :func:`ds_knn` (``nn1_pallas``'s function)."""
    d, i = ds_knn(query, qmask, ref, rmask, 1)
    return d[:, 0], i[:, 0]


@contextlib.contextmanager
def routed(route):
    """The reference's searches through ``route``: ``diff_squares`` puts
    :func:`ds_nn1` / :func:`ds_knn` at the names the port's parity tests
    patch; ``as_is`` leaves them."""
    names = ((laser_odometry, "nn1", ds_nn1), (icp, "_nn1", ds_nn1),
             (laser_mapping, "knn", ds_knn))
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in names]
    try:
        if route == "diff_squares":
            for mod, name, fn in names:
                setattr(mod, name, fn)
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def render(cfg):
    """The bench circuit: ground-truth poses [192, 4, 4], points, masks."""
    poses = synthetic.loop_trajectory(N_CIRCUIT, radius=30.0, speed=1.6, closed=True)
    world = synthetic.make_world(seed=100, clear_path=poses[:, :2, 3])
    pts, mask = synthetic.render_sequence(world, poses, cfg, noise=0.01, seed=0)
    return poses, pts, mask


def _f32(a):
    """Nested lists of the shortest decimal that reads back as each f32."""
    a = np.asarray(a, np.float32)
    if a.ndim == 0:
        return float(np.format_float_positional(np.float32(a), unique=True, trim="-"))
    return [_f32(x) for x in a]


def results(pipe, gt, seconds):
    """A finished run's record: poses, keyframes, loops and ATEs."""
    est = np.stack([np.asarray(p) for p in pipe.poses]).astype(np.float32)
    ms = pipe.state.mapping
    g = ms.graph
    n = est.shape[0]
    n_loops, n_kf = int(g.loop_count), int(g.count)
    pairs = [[int(i), int(j)] for i, j in zip(np.asarray(g.loop_i)[:n_loops],
                                            np.asarray(g.loop_j)[:n_loops])]
    kf_t = np.asarray(ms.kf_times)[:n_kf]
    gt_idx = np.clip(np.round(kf_t / pipe.cfg.scan_period).astype(int), 0, n - 1)
    kf_ate = ate_rmse(np.asarray(g.poses)[:n_kf, :3, 3], gt[gt_idx, :3, 3], align=False)
    return dict(frames=n, keyframes=n_kf, kf_times=_f32(kf_t), loops=n_loops,
                loop_pairs=pairs, attempts=int(ms.loop_attempts), overflow=int(g.overflow),
                loop_overflow=int(g.loop_overflow),
                ate_m=ate_rmse(est[:, :3, 3], gt[:n, :3, 3], align=False), kf_ate_m=kf_ate,
                compactions=pipe.compactions, seconds=seconds, poses=_f32(est[:, :3, :]))


def run(cfg, gt, pts, mask, schedule, route):
    """One schedule over the frames with one search route; its record."""
    t0 = time.time()
    with routed(route):
        pipe = SlamPipeline(cfg)
        if schedule == "process":
            for k in range(pts.shape[0]):
                pipe.process(pts[k], mask[k])
        else:
            for i in range(0, pts.shape[0], CHUNK):
                pipe.run_scanned(pts[i:i + CHUNK], mask[i:i + CHUNK])
        jax.block_until_ready(pipe.state)
        np.asarray(pipe.poses[-1])
    return results(pipe, gt, time.time() - t0)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=OUT, help="the record to write (default: %(default)s)")
    args = ap.parse_args(argv)

    cfg = PipelineConfig().replace(loop_in_step=False)
    t0 = time.time()
    gt, pts, mask = render(cfg)
    render_s = time.time() - t0
    print(f"rendered {pts.shape[0]} frames {cfg.n_scan}x{cfg.horizon_scan} in "
          f"{render_s:.1f} s", flush=True)
    record = dict(
        command="JAX_PLATFORMS=cpu python3 tools/reference_circuit.py",
        jax_version=jax.__version__, numpy_version=np.__version__,
        python=platform.python_version(), machine=f"{platform.machine()}, "
        f"{os.cpu_count()} CPUs", backend=jax.default_backend(),
        circuit=dict(frames=N_CIRCUIT, radius=30.0, speed=1.6, closed=True,
                     world_seed=100, noise=0.01, render_seed=0, chunk=CHUNK),
        render_seconds=render_s, config=smoke.config_fields(cfg),
        frame_sha256=[smoke.frame_sha256(pts[k], mask[k]) for k in range(pts.shape[0])],
        runs={})
    for name in RUNS:
        schedule, route = name.split("/")
        rec = run(cfg, gt, pts, mask, schedule, route)
        record["runs"][name] = rec
        print(f"{name}: {rec['keyframes']} keyframes, loops {rec['loop_pairs']}, "
              f"{rec['attempts']} attempts, overflow {rec['overflow']}/"
              f"{rec['loop_overflow']}, ATE {rec['ate_m']:.6f} / {rec['kf_ate_m']:.6f} m, "
              f"{rec['seconds']:.1f} s", flush=True)
    with open(args.out, "w") as f:
        # one line per run keeps the file short and its diffs readable
        runs = record.pop("runs")
        body = json.dumps(record, indent=1)[:-2]
        f.write(body + ',\n "runs": {\n' + ",\n".join(
            f"  {json.dumps(k)}: {json.dumps(v)}" for k, v in runs.items()) + "\n }\n}\n")
    peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2 ** 20
    print(f"wrote {args.out} ({os.path.getsize(args.out)} bytes) in "
          f"{time.time() - t0:.1f} s, peak resident {peak:.2f} GiB", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
