"""The record of the JAX reference's answer on the 192-frame bench circuit
(``tools/reference_circuit.json``, written by ``tools/reference_circuit.py``),
which ``chip_smoke.py``'s phase ``reference_agreement`` holds the port's
runs on the card against.

* the record is current: its config is every field of the port's and of
  the reference's ``PipelineConfig().replace(loop_in_step=False)``, each
  of its four runs (two schedules, two search routes) carries every field
  over all 192 frames, and ``chip_smoke.py``, which reads it, imports no
  JAX;
* the same render: the circuit's first two frames at the full geometry,
  rendered by the port's and by the reference's ``synthetic.py``, are bit
  for bit equal and hash to the record's first two (the card checks all
  192);
* the tool's difference-squares search (its ``diff_squares`` route) is
  ``nn1_pallas`` / ``knn_pallas`` in interpret mode, the function the
  port's kernels compute: distances and indices bit for bit.
"""

import ast
import importlib
import importlib.util
import json
import os
import sys
import types

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from alego_tpu import PipelineConfig as JConfig
from alego_tpu.ops.pallas_nn import knn_pallas, nn1_pallas
from alego_tpu.utils import synthetic as jsyn

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port_numpy_module(name):
    """A numpy-only module of the port (``config``, ``utils.synthetic``),
    loaded under a private package name without the port's ``__init__``,
    which imports torch: two of this file's ten CPU seconds alone."""
    pkg = "_alego_tpu_torch_numpy"
    if pkg not in sys.modules:
        mod = types.ModuleType(pkg)
        mod.__path__ = [os.path.join(REPO, "alego_tpu_torch")]
        sys.modules[pkg] = mod
    return importlib.import_module(f"{pkg}.{name}")


TConfig = _port_numpy_module("config").PipelineConfig
tsyn = _port_numpy_module("utils.synthetic")
RUN_FIELDS = ("frames", "keyframes", "kf_times", "loops", "loop_pairs", "attempts",
              "overflow", "loop_overflow", "ate_m", "kf_ate_m", "compactions", "seconds",
              "poses")


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def tool():
    return _load("reference_circuit", os.path.join(REPO, "tools", "reference_circuit.py"))


@pytest.fixture(scope="module")
def smoke(tool):
    return tool.smoke


@pytest.fixture(scope="module")
def record(tool):
    with open(tool.OUT) as f:
        return json.load(f)


def test_record_is_current(tool, smoke, record):
    port = smoke.config_fields(TConfig().replace(loop_in_step=False))
    ref = smoke.config_fields(JConfig().replace(loop_in_step=False))
    assert record["config"] == port == ref
    n = tool.N_CIRCUIT
    assert len(record["frame_sha256"]) == n and sorted(record["runs"]) == sorted(tool.RUNS)
    for name, run in record["runs"].items():
        assert set(RUN_FIELDS) <= set(run), (name, set(RUN_FIELDS) - set(run))
        assert run["frames"] == n and np.asarray(run["poses"]).shape == (n, 3, 4), name
        assert len(run["kf_times"]) == run["keyframes"] and len(run["loop_pairs"]) == run["loops"]
        assert np.isfinite(np.asarray(run["poses"])).all(), name
    assert os.path.getsize(tool.OUT) < 200 * 1024
    # chip_smoke.py reads the record with json alone: it imports no JAX
    with open(os.path.join(REPO, "chip_smoke.py")) as f:
        tree = ast.parse(f.read())
    names = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names}
    names |= {n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.module}
    assert not {m for m in names if m.split(".")[0] in ("jax", "alego_tpu")}, names


def test_same_render(tool, smoke, record):
    frames = {}
    for side, syn, config in (("port", tsyn, TConfig), ("reference", jsyn, JConfig)):
        cfg = config().replace(loop_in_step=False)
        poses = syn.loop_trajectory(tool.N_CIRCUIT, radius=30.0, speed=1.6, closed=True)
        world = syn.make_world(seed=100, clear_path=poses[:, :2, 3])
        frames[side] = syn.render_sequence(world, poses[:2], cfg, noise=0.01, seed=0)
    (tp, tm), (jp, jm) = frames["port"], frames["reference"]
    assert tp.dtype == jp.dtype == np.float32 and tm.dtype == jm.dtype == np.bool_
    np.testing.assert_array_equal(tp, jp)
    np.testing.assert_array_equal(tm, jm)
    assert tm.sum() > 20000
    for k in range(2):
        assert smoke.frame_sha256(tp[k], tm[k]) == record["frame_sha256"][k]


def test_diff_squares_route_is_pallas(tool):
    rng = np.random.default_rng(0)
    Q, N = 200, 4100    # three ref tiles of the Pallas kernel, one ragged
    q = rng.normal(0, 20, (Q, 3)).astype(np.float32)
    r = rng.normal(0, 20, (N, 3)).astype(np.float32)
    r[3000] = r[500]            # a duplicate ref in another tile: a tie
    q[5] = r[500]
    qm, rm = rng.random(Q) < 0.9, rng.random(N) < 0.7
    rm[[500, 3000]] = True
    q, qm, r, rm = map(jnp.asarray, (q, qm, r, rm))
    got = jax.jit(tool.ds_knn, static_argnums=4)(q, qm, r, rm, 5)
    want = knn_pallas(q, qm, r, rm, k=5, interpret=True)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    assert int(got[1][5, 0]) == 500
    got = jax.jit(tool.ds_nn1)(q, qm, r, rm)
    want = nn1_pallas(q, qm, r, rm, interpret=True)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    # the route is put in at the names the port's parity tests patch, and
    # taken out again
    from alego_tpu.models import laser_mapping, laser_odometry
    from alego_tpu.ops import icp
    before = (laser_odometry.nn1, icp._nn1, laser_mapping.knn)
    with tool.routed("diff_squares"):
        assert (laser_odometry.nn1, icp._nn1, laser_mapping.knn) == \
            (tool.ds_nn1, tool.ds_nn1, tool.ds_knn)
    assert (laser_odometry.nn1, icp._nn1, laser_mapping.knn) == before
