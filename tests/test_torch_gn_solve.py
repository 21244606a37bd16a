"""The Gauss-Newton solve over a Correspondences batch, and the reference's
last small functions, against the JAX reference on the CPU.

* ``eval_correspondences`` against the reference's on a batch of the three
  kinds with zero-weight, non-finite and degenerate rows (lines of two
  equal points, planes of three collinear points, a point on its plane
  from the identity: sign(0) = 0): residuals and Jacobians within 1e-5
  relative (+1e-5 absolute; a line row's Jacobian + 2e-5 / r, see the
  test), the non-finite entries at the same places;
* the plain ``solve_correspondences`` against the reference's ``solve_gn``
  over its ``eval_correspondences`` for the frame's three compositions
  (odometry step A, step B with its column masks, mapping with
  ``eig_floor`` 1.0) and step B with a prior: params within 1e-5 (f32
  sums in other orders; the solves converge far below ``param_tol``);
* the plain path against the closures the odometry and mapping solves ran
  before the batch (the rows evaluated per family and concatenated): bit
  for bit;
* the ``gn`` kernel's launch plan (``gn_plan``): its blocks' rows cover
  the batch once and the prior's rows have one owner;
* ``kernels.build`` keeps each compiler log beside its library (the
  ``gn`` row of ``chip_smoke.py`` reads ``-Xptxas -v`` from it), with a
  stand-in compiler, as this machine has no ``nvcc``;
* ``knn.knn``, ``knn.nn1``, ``knn.radius_count`` and ``se3.compose_mats``
  against the reference's: indices and counts equal, distances within
  1e-3 (the expansion |q|^2 - 2 q.r + |r|^2 rounds terms up to ~5400 m^2).

The batches are the GPU tests' seeded scenes (test_torch_kernels_gpu), at
the tiny configuration's widths.
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from alego_tpu.ops import gauss_newton as jgn, knn as jknn, residuals as jres, se3 as jse3

from alego_tpu_torch.ops import gauss_newton as tgn, knn as tknn, residuals as tres
from alego_tpu_torch.ops import se3 as tse3

from test_torch_kernels_gpu import GN_COMPOSITIONS, GN_TRUE_PARAMS, gn_scene, gn_torch

# one intra-op thread: the suite runs in several test processes at once,
# where more threads per process only contend for the cores
torch.set_num_threads(1)

# rows of each kind at the tiny configuration's widths (max_flat 128,
# max_sharp 64, kf caps 512 + 1024 + 512)
TINY_ROWS = {"step_a": ((1, 128),), "step_b": ((1, 128), (0, 64)),
             "mapping": ((0, 512), (2, 1536))}


def _case(name):
    """(scene, params0, opts) of a composition at the tiny widths; "prior"
    is step B with a prior toward params0."""
    base = "step_b" if name == "prior" else name
    opts = dict(GN_COMPOSITIONS[base][1])
    opts.setdefault("iters", 5)
    if name == "prior":
        opts["prior_weight"] = 2.0
    scene = gn_scene(TINY_ROWS[base], seed=5)
    return scene, (GN_TRUE_PARAMS * 0.6).astype(np.float32), opts


def _jax_corr(scene):
    return jres.Correspondences(*(jnp.asarray(scene[k]) for k in jres.Correspondences._fields))


@functools.lru_cache(maxsize=None)
def _jax_solve(name):
    """The reference's solve_gn over its eval_correspondences (the column
    masks applied by kind), compiled once per composition."""
    _, _, opts = _case(name)
    cols = None if "kind_cols" not in opts else jnp.asarray(opts["kind_cols"], jnp.float32)

    def solve(corr, p0):
        def res(p):
            r, J = jres.eval_correspondences(p, corr)
            if cols is not None:
                k = corr.kind[:, None]
                J = J * jnp.where(k == 0, cols[0], jnp.where(k == 1, cols[1], cols[2]))
            return r, J, corr.weight
        return jgn.solve_gn(res, p0, opts["iters"], jnp.asarray(opts["dims"], bool), 0.1,
                            min_count=opts.get("min_count", 0),
                            eig_floor=opts.get("eig_floor", 0.0),
                            prior_weight=opts.get("prior_weight", 0.0))
    return jax.jit(solve)


def _mixed_batch():
    """64 rows of each kind with degenerate, zero-weight and non-finite
    rows."""
    s = gn_scene(((0, 64), (1, 64), (2, 64)), seed=9)
    s["pl"][:4] = s["pj"][:4]                          # lines of two equal points
    s["pm"][64:68] = 2 * s["pj"][64:68] - s["pl"][64:68]   # collinear plane points
    s["cp"][68:72] = s["pj"][68:72]                    # on the plane: sign(0) at identity
    s["cp"][5, 0] = np.nan
    s["pj"][75, 2] = np.inf
    s["cp"][130, 1] = np.nan
    return s


@pytest.mark.parametrize("at", ["identity", "pose"])
def test_eval_correspondences_matches_reference(at):
    s = _mixed_batch()
    p = np.zeros(6, np.float32) if at == "identity" else GN_TRUE_PARAMS.astype(np.float32)
    r_j, J_j = (np.asarray(a) for a in jres.eval_correspondences(jnp.asarray(p), _jax_corr(s)))
    corr = tres.Correspondences(*(torch.from_numpy(s[k]) for k in tres.Correspondences._fields))
    r_t, J_t = (a.numpy() for a in tres.eval_correspondences(torch.from_numpy(p), corr))
    np.testing.assert_array_equal(np.isfinite(r_t), np.isfinite(r_j))
    np.testing.assert_array_equal(np.isfinite(J_t), np.isfinite(J_j))
    ok = np.isfinite(r_j)
    np.testing.assert_allclose(r_t[ok], r_j[ok], rtol=1e-5, atol=1e-5)
    # a line row's Jacobian has the direction of (lp - pj) x (lp - pl): an
    # f32 rounding of lp (~1e-6 m at 10-20 m) turns it by ~1e-6 / r
    tol = 1e-5 + np.where(s["kind"] == 0, 2e-5 / np.maximum(np.abs(r_j), 1e-12), 0.0)
    ok = np.isfinite(J_j).all(1)
    assert (np.abs(J_t - J_j)[ok] <= tol[ok, None] + 1e-5 * np.abs(J_j[ok])).all()
    if at == "identity":       # sign(0) = 0: the on-plane rows have r = 0, J = 0
        assert not r_t[68:72].any() and not J_t[68:72].any()
    assert not np.isfinite(r_t[[5, 75, 130]]).any()


@pytest.mark.parametrize("name", ["step_a", "step_b", "mapping", "prior"])
def test_solve_matches_reference(name):
    scene, p0, opts = _case(name)
    want = np.asarray(_jax_solve(name)(_jax_corr(scene), jnp.asarray(p0)))
    args, kw = gn_torch(scene, p0, opts, "cpu")
    got = tgn.solve_correspondences(*args, **kw).numpy()
    assert np.abs(got - p0).max() > 1e-2                     # the solve moved
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def _closure_solve(name, args, kw):
    """The solve as the odometry and mapping steps ran it before the batch:
    each family evaluated on its own rows and concatenated."""
    corr, p0, iters, dims, delta = args
    kinds = corr.kind.numpy()
    cuts = [0] + [i for i in range(1, len(kinds)) if kinds[i] != kinds[i - 1]] + [len(kinds)]
    blocks = [(int(kinds[a]), slice(a, b)) for a, b in zip(cuts[:-1], cuts[1:])]
    cols = kw.get("kind_cols")

    def res(p):
        rs, Js = [], []
        for kind, sl in blocks:
            if kind == 0:
                r, J = tres.point_to_line(p, corr.cp[sl], corr.pj[sl], corr.pl[sl])
            elif kind == 1:
                r, J = tres.point_to_plane_3pt(p, corr.cp[sl], corr.pj[sl], corr.pl[sl],
                                               corr.pm[sl])
            else:
                r, J = tres.point_to_plane_fitted(p, corr.cp[sl], corr.pj[sl],
                                                  corr.scalar[sl])
            rs.append(r)
            Js.append(J if cols is None else J * cols[kind][None, :])
        return torch.cat(rs), torch.cat(Js), corr.weight

    opts = {k: v for k, v in kw.items() if k != "kind_cols"}
    return tgn.solve_gn(res, p0, iters, dims, delta, **opts)


@pytest.mark.parametrize("name", ["step_a", "step_b", "mapping"])
def test_plain_solve_equals_closures(name):
    scene, p0, opts = _case(name)
    args, kw = gn_torch(scene, p0, opts, "cpu")
    assert torch.equal(tgn.solve_correspondences(*args, **kw), _closure_solve(name, args, kw))


@pytest.mark.parametrize("prior", [False, True])
@pytest.mark.parametrize("n", [0, 1, 6, 255, 257, 511, 512, 513, 768, 4096, 4097, 8192,
                               30001])
def test_gn_plan_covers_the_rows(n, prior):
    """The gn kernel's cluster (gn_plan): 1-8 blocks; the blocks' batch
    rows, as csrc/gn.cu cuts them, cover [0, n) once, each starting at a
    multiple of 4; the prior's 6 rows have one owner, the last block; at
    most GN_THREADS rows a block (one a thread) up to 8 blocks' worth, and
    8 blocks past 7 blocks' worth (the 4096-row mapping solve)."""
    blocks, chunk = tgn.gn_plan(n, prior)
    assert 1 <= blocks <= tgn.GN_MAX_BLOCKS and chunk % 4 == 0 and blocks * chunk >= n
    covered = np.zeros(n, int)
    owned = []
    for b in range(blocks):
        first = min(b * chunk, n)
        mine = min(first + chunk, n) - first
        assert first % 4 == 0 or mine == 0
        covered[first:first + mine] += 1
        owned.append(mine + (6 if prior and b == blocks - 1 else 0))
    assert (covered == 1).all()
    rows = n + (6 if prior else 0)
    assert sum(owned) == rows
    if rows <= tgn.GN_MAX_BLOCKS * tgn.GN_THREADS:
        assert max(owned) <= tgn.GN_THREADS
    assert (blocks == 8) == (rows > 7 * tgn.GN_THREADS)


def test_kernels_build_keeps_the_compiler_log(tmp_path, monkeypatch):
    """A build writes the library and its compiler output beside it; a
    second build compiles nothing; a library without its log is built
    again; a failed build raises with the compiler's output."""
    from alego_tpu_torch import kernels
    fake = tmp_path / "nvcc"
    fake.write_text('#!/bin/sh\nwhile [ "$1" != "-o" ]; do shift; done\n'
                    'echo "ptxas info    : Used 42 registers"\n'
                    'case "$3" in *ccl.cu) echo "error: no"; exit 1;; esac\n'
                    'echo lib > "$2"\n')
    fake.chmod(0o755)
    monkeypatch.setattr(kernels, "nvcc", lambda: str(fake))
    monkeypatch.setattr(kernels, "BUILD", tmp_path / "build")
    logs = kernels.build(("gn",))
    assert "Used 42 registers" in logs["gn"]
    lib = kernels._target("gn")
    assert lib.read_text() == "lib\n"
    assert kernels.build_log("gn") == logs["gn"]
    assert kernels.build(("gn",)) == {}
    lib.with_suffix(".log").unlink()
    assert kernels.build_log("gn") == logs["gn"]
    with pytest.raises(RuntimeError, match="error: no"):
        kernels.build(("ccl",))
    assert sorted(f.name for f in (tmp_path / "build").iterdir()) == sorted(
        [lib.name, lib.with_suffix(".log").name])


def _search_inputs():
    rng = np.random.default_rng(21)
    q = rng.uniform(-30, 30, (300, 3)).astype(np.float32)
    r = rng.uniform(-30, 30, (5000, 3)).astype(np.float32)
    return q, rng.random(300) < 0.9, r, rng.random(5000) < 0.6


@pytest.mark.parametrize("fn", ["knn", "nn1", "radius_count", "compose_mats"])
def test_reference_functions_match(fn):
    q, qm, r, rm = _search_inputs()
    tq, tqm, tr, trm = (torch.from_numpy(a) for a in (q, qm, r, rm))
    jq, jqm, jr, jrm = (jnp.asarray(a) for a in (q, qm, r, rm))
    if fn == "knn":      # two chunks, the second ragged
        d, i = tknn.knn(tq, tqm, tr, trm, 5, chunk=4096)
        d_j, i_j = jknn.knn(jq, jqm, jr, jrm, 5, chunk=4096)
    elif fn == "nn1":
        d, i = tknn.nn1(tq, tqm, tr, trm, chunk=2048)
        d_j, i_j = jknn.nn1(jq, jqm, jr, jrm, chunk=2048)
    elif fn == "radius_count":
        got = tknn.radius_count(tq, tr, trm, 4.0)
        want = np.asarray(jknn.radius_count(jq, jr, jrm, 4.0))
        assert got.dtype == torch.int32 and want.max() > 0
        np.testing.assert_array_equal(got.numpy(), want)
        return
    else:
        rng = np.random.default_rng(22)
        A = rng.normal(size=(7, 4, 4)).astype(np.float32)
        B = rng.normal(size=(7, 4, 4)).astype(np.float32)
        np.testing.assert_allclose(tse3.compose_mats(torch.from_numpy(A), torch.from_numpy(B)),
                                   np.asarray(jse3.compose_mats(jnp.asarray(A), jnp.asarray(B))),
                                   rtol=1e-6, atol=1e-6)
        return
    assert i.dtype == torch.int32
    np.testing.assert_array_equal(i.numpy(), np.asarray(i_j))
    np.testing.assert_allclose(d.numpy(), np.asarray(d_j), rtol=1e-6, atol=1e-3)
    assert bool((d[~tqm] == tknn.BIG).all())
