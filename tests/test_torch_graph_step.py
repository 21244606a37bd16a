"""The frame step made capture-safe, and the pipeline's static state.

* ``gauss_newton.degeneracy_projector`` (the cyclic Jacobi ``eigh6`` in
  place of ``torch.linalg.eigh``) against the reference's on random SPD,
  rank-deficient and non-finite 6x6 matrices whose eigenvalues keep clear
  of the floor: P within 1e-5 (the reference's f32 ``eigh`` is the coarser
  side); ``eigh6`` leaves an
  off-diagonal below 1e-12 of the largest entry on spectra spread over nine
  decades;
* the component sizes of segmentation, counted by a scatter-add into a
  fixed buffer, against ``torch.bincount``, bit for bit;
* ``mapping_step`` (the local map built on every mapping frame and selected
  by ``map_dirty`` on the device) against the reference's (``lax.cond``)
  with ``map_dirty`` False and True, from one state and inputs: the pose
  within 1e-4 m / 1e-5 rad, the selected map's masks equal and points
  within 1e-3 of the leaf, and, on the port's side, the map bit for bit the
  cached one or the rebuilt one;
* the mapping step at frames 4, 5 and 6 of one port run, from the port's
  state: per outer solve, on the cached map and the port's scan clouds,
  the active rows per family, the projector's rank and the iterations run
  equal, H0's eigenvalues within 1e-4 of the largest and the second warm
  start within 1e-4 m / 1e-5 rad; the pose within 1e-4 m / 1e-5 rad at
  frames 5 and 6, and at frame 4 (two keyframes) both second outer solves
  at the iteration cap, where the pose is not determined; the rebuilt maps
  at frames 4 and 5 within 1e-3 of the leaf, the port's centroids within
  1e-5 m of the exact ones, and with the port's rebuild on both sides the
  decisions and the resolvable plane normals equal and the pose held where
  no surf row has near-collinear neighbours;
* the static state: every tensor of ``SlamPipeline.state`` keeps its
  ``data_ptr`` across ``process``, ``run_scanned``, the hoisted loop
  attempts, ``_maybe_compact``, an IMU flush, ``reset`` and
  ``load_checkpoint``, and the poses after each equal, bit for bit, an
  eager loop of ``slam_step`` with the same updates between frames.

The reference's searches run its Pallas kernels in interpret mode (see
test_torch_pipeline); its ``mapping_step`` is compiled once for the file,
with its outer solves recorded by ``jax.debug.callback`` (see ``mapped``).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from alego_tpu.models import laser_mapping as jlm, pose_graph as jpg
from alego_tpu.ops import gauss_newton as jgn
from alego_tpu.utils import synthetic

from alego_tpu_torch.models import laser_mapping as tlm, pipeline as tpipe
from alego_tpu_torch.ops import deskew as tdk, gauss_newton as tgn, knn as tknn, se3 as tse3
from alego_tpu_torch.ops import voxel as tvox
from alego_tpu_torch.ops.se3 import rot_to_rpy
from alego_tpu_torch.ops.segmentation import component_sizes

from test_torch_pipeline import assert_pose_close, pallas_search

# one intra-op thread: the suite runs in several test processes at once,
# where more threads per process only contend for the cores
torch.set_num_threads(1)


def _random_symmetric(rng, lam):
    Q, _ = np.linalg.qr(rng.normal(size=(6, 6)))
    A = (Q * lam) @ Q.T
    return 0.5 * (A + A.T)


def _projector_cases(floor):
    """(name, H [6, 6] f32) around ``floor``: full rank, rank-deficient,
    repeated eigenvalues, and non-finite.  The kept eigenvalues lie in
    [2, 50] x floor and the dropped ones in [0, 0.5] x floor, so both f32
    decompositions see the same split (an eigenvalue within f32's rounding
    of ||H|| from the floor could fall on either side)."""
    rng = np.random.default_rng(11)
    out = []
    for k in range(12):
        lam = floor * rng.uniform(2.0, 50.0, 6)
        n_low = k % 4                          # 0-3 directions below the floor
        lam[:n_low] = floor * rng.uniform(0.0, 0.5, n_low)
        if k % 3 == 1:
            lam[:n_low] = 0.0                  # rank-deficient
        if k % 5 == 2:
            lam[3:] = lam[3]                   # a repeated eigenvalue
        out.append((f"case{k}", _random_symmetric(rng, lam).astype(np.float32)))
    bad = out[0][1].copy()
    bad[1, 4] = bad[4, 1] = np.nan
    out.append(("nan", bad))
    inf = out[1][1].copy()
    inf[0, 0] = np.inf
    out.append(("inf", inf))
    return out


@pytest.mark.parametrize("floor", [1.0, 100.0])
def test_degeneracy_projector_matches_reference(floor):
    proj = jax.jit(jgn.degeneracy_projector, static_argnums=1)
    for name, H in _projector_cases(floor):
        P_t = tgn.degeneracy_projector(torch.from_numpy(H), floor).numpy()
        P_j = np.asarray(proj(jnp.asarray(H), floor))
        np.testing.assert_allclose(P_t, P_j, rtol=0, atol=1e-5, err_msg=name)
        if not np.isfinite(H).all():
            assert not P_t.any(), name


def test_eigh6_converges():
    """Spectra over nine decades, with zeros and a repeated eigenvalue,
    against numpy's f64 ``eigvalsh``."""
    rng = np.random.default_rng(12)
    for k in range(12):
        lam = 10.0 ** rng.uniform(-3, 6, 6)
        if k % 3 == 1:
            lam[rng.choice(6, 2, replace=False)] = 0.0
        if k % 4 == 2:
            lam[:3] = lam[0]
        A = torch.from_numpy(_random_symmetric(rng, lam))
        lam_t, V = tgn.eigh6(A)
        D = V.T @ A @ V
        off = (D - torch.diag(torch.diagonal(D))).abs().max()
        assert float(off) <= 1e-12 * float(A.abs().max()), k
        np.testing.assert_allclose(np.sort(lam_t.numpy()), np.linalg.eigvalsh(A.numpy()),
                                   rtol=0, atol=1e-10 * float(A.abs().max()), err_msg=str(k))
        np.testing.assert_allclose((V.T @ V).numpy(), np.eye(6), rtol=0, atol=1e-12)


def test_component_sizes_match_bincount():
    rng = np.random.default_rng(5)
    for n, size in ((1, 10), (17, 1000), (64001, 64000)):
        labels = torch.from_numpy(rng.integers(0, n, size))
        labels[-1] = n - 1            # the sentinel slot, as segmentation uses it
        want = torch.bincount(labels, minlength=n)
        got = component_sizes(labels, n)
        assert got.dtype == want.dtype and torch.equal(got, want)


@pytest.fixture(scope="module")
def tiny_run(cfg, world):
    """A tiny config with hoisted loop attempts that run within 8 frames
    (a 0.3 s age gate, 3 ICP iterations, no rescue), and its frames."""
    cfg = cfg.replace(loop_in_step=False, loop_every_n_frames=3, loop_time_gap=0.3,
                      icp_iters=3, loop_coarse_align=False)
    poses = synthetic.loop_trajectory(8, radius=20.0, speed=1.5, closed=False)
    pts, mask = synthetic.render_sequence(world, poses, cfg, noise=0.01)
    return cfg, pts, mask


# the frames mapped from the state the port carried to them: frame 4 maps
# against two keyframes, 5 and 6 against three
MAPPED = (4, 5, 6)


def _copy(tree):
    return tpipe._unflatten(tree, [t.clone() for _, t in tpipe._flatten(tree)])


@pytest.fixture(scope="module")
def mapping_frames(tiny_run):
    """One port run of the tiny sequence: for each frame f of MAPPED, a copy
    of the port's mapping state after frames 0 to f - 1, and frame f's
    mapping inputs (the front half's features and odometry pose)."""
    cfg, pts, mask = tiny_run
    pipe = tpipe.SlamPipeline(cfg, device="cpu")
    out = {}
    for f in range(max(MAPPED)):
        pipe.process(pts[f], mask[f])
        if f + 1 not in MAPPED:
            continue
        st = _copy(pipe.state)
        t = torch.tensor(0.2 * (f + 1))
        _, T, fc, seg = tpipe.front_step(st, torch.from_numpy(pts[f + 1]),
                                         torch.from_numpy(mask[f + 1]), t, cfg)
        out[f + 1] = st.mapping, (T, fc.less_sharp_pts, fc.less_sharp_valid,
                                  fc.less_flat_pts, fc.less_flat_valid,
                                  seg.outlier_points, seg.outlier_valid, t)
    return out


def _numpy(tree):
    if hasattr(tree, "_fields"):
        return type(tree)(*(_numpy(t) for t in tree))
    return tree.numpy()


def _outer_solves(log, n_corner):
    """Per outer solve of a mapping step, from its recorded events: the warm
    start, the active rows (weighted and finite) of the corner and the surf
    family at it and those rows (``rows``: r, J, w), H0's eigenvalues
    (ascending, f64) and the projector's kept rank, and the iterations run
    (the port's ``iters_out``; on the reference's side its ``while_loop``
    bodies, one residual call each)."""
    out = []
    for tag, *a in log:
        if tag == "solve":
            out.append(dict(warm=a[0], calls=0))
        elif tag == "res":
            s = out[-1]
            if s["calls"] == 0:
                r, J, w = a
                ok = (w > 0) & np.isfinite(r) & np.isfinite(J).all(-1)
                s["active"] = (int(ok[:n_corner].sum()), int(ok[n_corner:].sum()))
                s["rows"] = r, J, w
            s["calls"] += 1
        elif tag == "projector":
            H, P = a
            out[-1].update(eig=np.linalg.eigvalsh(H.astype(np.float64)),
                           rank=int(round(float(np.trace(P)))))
        elif tag == "iters":
            out[-1]["iters"] = int(a[0][0])
    for s in out:
        s.setdefault("iters", s["calls"])
    return out


@pytest.fixture(scope="module")
def mapped(tiny_run, mapping_frames):
    """``mapped(f, local_map)``: frame f of MAPPED mapped by the port and by
    the reference from the port's state and inputs, with the local map
    ``"cached"`` (``map_dirty`` False: the map of the frame before the last
    keyframe), ``"rebuilt"`` (``map_dirty`` True: each side rebuilds it)
    or ``"port"`` (the port's rebuild installed as the cached map on both
    sides); ``port_scan``: the reference fed the port's downsampled scan
    clouds in place of its own.  Returns {"port": (state, T [4, 4], outer
    solves), "ref": (state, T, outer solves, (st, st_ok))}, ``st`` the
    reference's own downsampled surf+outlier cloud of the scan, and with
    ``reverse`` also "reversed": the port's step with each solve's rows
    summed in reverse order.  The reference's
    ``mapping_step`` is compiled once for the file; wrappers of its
    ``solve_gn``, ``degeneracy_projector`` and ``_downsample_scan`` record
    what they compute by ``jax.debug.callback``.  Memoised."""
    cfg = tiny_run[0]
    n_corner = cfg.kf_corner_cap
    log = []

    def record(tag, *arrays):
        jax.debug.callback(lambda *a: log.append((tag,) + tuple(np.asarray(x) for x in a)),
                           *arrays, ordered=True)

    real_solve, real_proj, real_ds = jlm.solve_gn, jgn.degeneracy_projector, jlm._downsample_scan

    def solve_gn(residual_fn, params0, *a, **kw):
        record("solve", params0)

        def res(p):
            r, J, w = residual_fn(p)
            record("res", r, J, w)
            return r, J, w
        return real_solve(res, params0, *a, **kw)

    def projector(H, floor):
        P = real_proj(H, floor)
        record("projector", H, P)
        return P

    feed = {}

    def downsample_scan(*a):
        out = real_ds(*a)
        record("st", out[6], out[7])
        # the port's clouds in place of its own where a check feeds them
        return jax.pure_callback(lambda *own: feed.get("scan", own),
                                 tuple(jax.ShapeDtypeStruct(o.shape, o.dtype) for o in out),
                                 *out)

    step = jax.jit(lambda m, *a: jlm.mapping_step(m, *a, cfg))

    def reference(ms, inputs, scan):
        log.clear()
        feed.clear()
        if scan is not None:
            feed["scan"] = tuple(t.numpy() for t in scan)
        with pytest.MonkeyPatch.context() as mp:
            pallas_search(mp)
            mp.setattr(jlm, "solve_gn", solve_gn)
            mp.setattr(jgn, "degeneracy_projector", projector)
            mp.setattr(jlm, "_downsample_scan", downsample_scan)
            m_np = _numpy(ms)
            ms_j, T_j = step(jlm.MappingState(*m_np)._replace(graph=jpg.PoseGraph(*m_np.graph)),
                             *(jnp.asarray(a.numpy()) for a in inputs))
            T_j = np.asarray(T_j)
            jax.effects_barrier()
        st = [e for e in log if e[0] == "st"][-1][1:]
        return ms_j, T_j, _outer_solves([e for e in log if e[0] != "st"], n_corner), st

    real_solve_t, real_proj_t = tgn.solve_gn, tgn.degeneracy_projector

    def port(ms, inputs, reverse=False):
        events = []

        def solve_gn_t(residual_fn, params0, *a, iters_out=None, **kw):
            events.append(("solve", params0.numpy()))

            def res(p):
                r, J, w = residual_fn(p)
                if events[-1][0] == "solve":       # the warm start's rows
                    events.append(("res", r.numpy(), J.numpy(), w.numpy()))
                if reverse:                        # the sums in another order
                    return r.flip(0), J.flip(0), w.flip(0)
                return r, J, w
            done = torch.zeros(1, dtype=torch.int32)
            out = real_solve_t(res, params0, *a, iters_out=done, **kw)
            events.append(("iters", done.numpy()))
            return out

        def projector_t(H, floor):
            P = real_proj_t(H, floor)
            events.append(("projector", H.numpy(), P.numpy()))
            return P

        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(tgn, "solve_gn", solve_gn_t)
            mp.setattr(tgn, "degeneracy_projector", projector_t)
            ms_t, T_t = tlm.mapping_step(_copy(ms), *inputs, cfg)
        return ms_t, T_t.numpy(), _outer_solves(events, n_corner)

    memo = {}

    def run(f, local_map, port_scan=False, reverse=False):
        key = f, local_map, port_scan
        ms, inputs = mapping_frames[f]
        if local_map == "port":
            rebuilt = tlm._build_local_map(ms, cfg)
            ms = ms._replace(map_corner=rebuilt[0], map_corner_valid=rebuilt[1],
                             map_surf=rebuilt[2], map_surf_valid=rebuilt[3])
        ms = ms._replace(map_dirty=torch.tensor(local_map == "rebuilt"))
        if key not in memo:
            scan = tlm._downsample_scan(*inputs[1:7], cfg) if port_scan else None
            memo[key] = dict(port=port(ms, inputs), ref=reference(ms, inputs, scan))
        if reverse and "reversed" not in memo[key]:
            memo[key]["reversed"] = port(ms, inputs, reverse=True)
        return memo[key]
    return run


def test_mapping_step_selects_the_map(tiny_run, mapping_frames, mapped):
    cfg = tiny_run[0]
    ms, _ = mapping_frames[6]
    assert int(ms.graph.count) >= 2
    rebuilt = tlm._build_local_map(ms, cfg)
    for dirty in (False, True):
        # the cached map is the one of frame 4, before frame 5's keyframe:
        # a rebuild would differ from it
        out = mapped(6, "rebuilt" if dirty else "cached")
        ms_t, T_t, _ = out["port"]
        ms_j, T_j = out["ref"][:2]
        assert_pose_close(T_t, T_j)
        assert int(ms_t.graph.count) == int(ms_j.graph.count)
        assert bool(ms_t.map_dirty) == bool(ms_j.map_dirty)
        want = rebuilt if dirty else (ms.map_corner, ms.map_corner_valid, ms.map_surf,
                                      ms.map_surf_valid)
        for name, w in zip(("map_corner", "map_corner_valid", "map_surf",
                            "map_surf_valid"), want):
            got = getattr(ms_t, name)
            assert torch.equal(got, w), (dirty, name)
            ref = np.asarray(getattr(ms_j, name))
            if got.dtype == torch.bool:
                np.testing.assert_array_equal(got.numpy(), ref, err_msg=f"{dirty} {name}")
            else:
                np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                                           atol=1e-3 * cfg.surf_leaf, err_msg=f"{dirty} {name}")
    assert not torch.equal(rebuilt[3], ms.map_surf_valid), "the cached map is not stale"


@pytest.mark.parametrize("frame", MAPPED)
def test_mapping_solves_decide_alike(tiny_run, mapped, frame):
    """Each outer solve of the scan-to-map step, the port's against the
    reference's on the cached map, the reference fed the port's scan
    clouds (its own f32 centroids lie up to ~4e-4 m off, which moves H0 of
    frame 4's second solve past the tolerance below): the active rows per
    family, the projector's kept rank and the iterations run equal, H0's
    eigenvalues within 1e-4 of the largest, and the warm start of the
    second solve within 1e-4 m and 1e-5 rad."""
    out = mapped(frame, "cached", port_scan=True)
    solves_t, solves_j = out["port"][2], out["ref"][2]
    assert len(solves_t) == len(solves_j) == tiny_run[0].map_outer_iters
    for k, (t, j) in enumerate(zip(solves_t, solves_j)):
        print(f"frame {frame} solve {k + 1}: active {t['active']} / {j['active']}, rank "
              f"{t['rank']} / {j['rank']}, iterations {t['iters']} / {j['iters']}, "
              f"eigenvalues {np.array2string(t['eig'], precision=4)} / "
              f"{np.array2string(j['eig'], precision=4)} "
              f"({np.abs(t['eig'] - j['eig']).max() / j['eig'].max():.1e} of the largest "
              f"apart), warm start {np.abs(t['warm'] - j['warm']).max():.2e} apart")
        assert t["active"] == j["active"], (k, t["active"], j["active"])
        assert t["rank"] == j["rank"], (k, t["rank"], j["rank"])
        assert t["iters"] == j["iters"], (k, t["iters"], j["iters"])
        np.testing.assert_allclose(t["eig"], j["eig"], rtol=0, atol=1e-4 * j["eig"].max())
        np.testing.assert_allclose(t["warm"][:3], j["warm"][:3], rtol=0, atol=1e-4)
        np.testing.assert_allclose(t["warm"][3:], j["warm"][3:], rtol=0, atol=1e-5)


def _pose_gap(T_a, T_b):
    """(largest translation difference in m, largest roll/pitch/yaw
    difference in rad) of two poses [4, 4]."""
    T_a, T_b = (torch.as_tensor(np.array(T, np.float32)) for T in (T_a, T_b))
    d = (rot_to_rpy(T_a[:3, :3]) - rot_to_rpy(T_b[:3, :3])).numpy()
    d = (d + np.pi) % (2 * np.pi) - np.pi
    return float((T_a[:3, 3] - T_b[:3, 3]).abs().max()), float(np.abs(d).max())


@pytest.mark.parametrize("frame", MAPPED)
def test_mapping_pose_where_the_reference_determines_it(tiny_run, mapped, frame):
    """The mapping step's pose on the cached map, each side downsampling
    its own scan: frames 5 and 6 within 1e-4 m and 1e-5 rad.

    Frame 4 maps against two keyframes: H0's weakest eigenvalue (0.02 in
    the first outer solve, 0.39 in the second) lies under
    ``map_eig_floor``, and the projected step never falls under
    ``map_gn_tol``, so both outer solves run all ``map_gn_iters``
    iterations on both sides and the pose is whatever the last iteration
    returns.  The reference does not determine it to the tolerance: the
    port's own plain solve with its rows summed in reverse order (f32
    rounding in another order) turns it by ~1e-4 rad, ten times the
    rotation tolerance, where at frames 5 and 6 it moves by < 1e-8 m and
    0 rad (printed).  So frame 4 asserts that the second outer solve runs
    to the cap on both sides; a change that makes it converge fails here,
    and frame 4's pose is then to be held at 1e-4 m like the others."""
    cfg = tiny_run[0]
    out = mapped(frame, "cached", reverse=True)
    T_t, T_j = out["port"][1], out["ref"][1]
    gap, turned = _pose_gap(T_t, T_j), _pose_gap(T_t, out["reversed"][1])
    print(f"frame {frame}: port against reference {gap[0]:.2e} m, {gap[1]:.2e} rad; the "
          f"port's rows in reverse order {turned[0]:.2e} m, {turned[1]:.2e} rad; "
          f"iterations {[s['iters'] for s in out['port'][2]]} / "
          f"{[s['iters'] for s in out['ref'][2]]}")
    if frame == 4:
        assert out["port"][2][1]["iters"] == out["ref"][2][1]["iters"] == cfg.map_gn_iters
    else:
        assert_pose_close(T_t, T_j)


def _centroid_gap(pts, ok, leaf, cap, out, out_ok):
    """The largest distance of the slots of ``out`` from the exact f64
    centroids of the points of ``pts`` in their voxels, the voxels in
    ascending order of their hashed key (the reference's slot order) and
    cut to ``cap``."""
    keys = tvox.voxel_key(torch.from_numpy(pts), leaf, 256.0).numpy()[ok]
    uniq, inv = np.unique(keys, return_inverse=True)
    inv = inv.reshape(-1)
    sums = np.zeros((len(uniq), 3))
    np.add.at(sums, inv, pts[ok].astype(np.float64))
    n = min(len(uniq), cap)
    assert out_ok[:n].all() and not out_ok[n:].any()
    return float(np.abs(out[:n] - (sums / np.bincount(inv)[:, None])[:n]).max())


# a surf row's 5 neighbours are near-collinear where the two smallest
# eigenvalues of their covariance lie closer than this fraction of the
# largest: f32 cannot resolve the plane's normal there, and the port's and
# the reference's closed-form fits (the same formula, summed in other
# orders) turn it by 6e-4 to 3e-2 rad
COLLINEAR_GAP = 1e-3


def _plane_rows(solves, map_s, map_ok, st, st_ok, n_corner, k):
    """Per outer solve: the active surf rows' normals on each side (the
    translation columns of a fitted-plane row's Jacobian) and the
    eigenvalue gap (l1 - l0) / l2 of their neighbours' covariance (f64),
    the neighbours the port's k-NN finds at the port's warm start."""
    out = []
    for t, j in solves:
        sel = tse3.transform_points(torch.from_numpy(t["warm"]), st)
        _, idx = tknn.knn(sel, st_ok, map_s, map_ok, k)
        nb = map_s[idx.long()].double()
        q = nb - nb.mean(1, keepdim=True)
        ev = torch.linalg.eigvalsh(q.transpose(1, 2) @ q).numpy()
        gap = (ev[:, 1] - ev[:, 0]) / ev[:, 2]
        act = (t["rows"][2][n_corner:] > 0) & (j["rows"][2][n_corner:] > 0)
        n_t, n_j = (s["rows"][1][n_corner:, :3].astype(np.float64) for s in (t, j))
        sin = np.linalg.norm(np.cross(n_t, n_j), axis=1) / np.maximum(
            np.linalg.norm(n_t, axis=1) * np.linalg.norm(n_j, axis=1), 1e-30)
        out.append((gap[act], np.arcsin(np.clip(sin[act], 0.0, 1.0))))
    return out


@pytest.mark.parametrize("frame", (4, 5))
def test_rebuilt_map_matches_reference(tiny_run, mapping_frames, mapped, frame, monkeypatch):
    """The local map rebuilt at a mapping frame.

    * The maps the two sides rebuild: masks equal, points within 1e-3 of
      the leaf; the port's surf map within 1e-5 m of the exact f64
      centroids of its voxels, the reference's (blocked f32 prefix sums)
      within 1e-3 of the leaf.
    * The port's rebuild installed as the cached map on both sides, both
      fed the port's scan clouds: the active rows, the projector's rank
      and the iterations run equal per outer solve, and every active surf
      row whose neighbours f32 can resolve (``COLLINEAR_GAP``) has the
      same normal on both sides, within 1e-3 rad.  The pose is held within
      1e-4 m and 1e-5 rad where no active surf row has near-collinear
      neighbours (frame 4).  At frame 5 such rows are active, their
      normals are decided by f32 rounding, and the pose is not held (the
      gap is printed); a change that removes them makes this check hold
      it.
    The figures printed are the gaps that reach the pose when each side
    maps on its own rebuild and its own scan."""
    cfg = tiny_run[0]
    ms, inputs = mapping_frames[frame]
    calls, real = [], tlm.voxel_downsample
    with monkeypatch.context() as mp:      # the surf map's input points
        mp.setattr(tlm, "voxel_downsample",
                   lambda p, m, *a: calls.append((p, m)) or real(p, m, *a))
        _, _, map_s, map_s_ok = tlm._build_local_map(ms, cfg)
    surf_in = [t.numpy() for t in calls[1]]

    out = mapped(frame, "rebuilt")
    ms_t, ms_j = out["port"][0], out["ref"][0]
    assert torch.equal(ms_t.map_surf, map_s) and torch.equal(ms_t.map_surf_valid, map_s_ok)
    for name in ("map_corner", "map_surf"):
        ok = getattr(ms_t, name + "_valid").numpy()
        np.testing.assert_array_equal(ok, np.asarray(getattr(ms_j, name + "_valid")), name)
        np.testing.assert_allclose(getattr(ms_t, name).numpy(), np.asarray(getattr(ms_j, name)),
                                   rtol=0, atol=1e-3 * cfg.surf_leaf, err_msg=name)
    ok = map_s_ok.numpy()
    port_err = _centroid_gap(*surf_in, cfg.surf_leaf, cfg.map_surf_cap, map_s.numpy(), ok)
    ref_err = _centroid_gap(*surf_in, cfg.surf_leaf, cfg.map_surf_cap,
                            np.asarray(ms_j.map_surf), ok)
    assert port_err <= 1e-5, port_err
    assert ref_err <= 1e-3 * cfg.surf_leaf, ref_err
    # the scans' clouds, point to nearest point: a centroid moved across a
    # voxel face reorders the reference's slots
    st, st_ok = tlm._downsample_scan(*inputs[1:7], cfg)[6:8]
    st_j, st_j_ok = out["ref"][3]
    a, b = st.numpy()[st_ok.numpy()], st_j[st_j_ok]
    scan_gap = float(np.sqrt(((a[:, None] - b[None]) ** 2).sum(-1).min(1)).max())
    own = _pose_gap(out["port"][1], out["ref"][1])

    out = mapped(frame, "port", port_scan=True)
    solves = list(zip(out["port"][2], out["ref"][2]))
    for t, j in solves:
        assert (t["active"], t["rank"], t["iters"]) == (j["active"], j["rank"], j["iters"])
    rows = _plane_rows(solves, map_s, map_s_ok, st, st_ok, cfg.kf_corner_cap, cfg.map_knn)
    shared = _pose_gap(out["port"][1], out["ref"][1])
    print(f"frame {frame}: map_surf port against reference "
          f"{np.abs(map_s.numpy() - np.asarray(ms_j.map_surf))[ok].max():.2e} m (exact "
          f"centroids: port {port_err:.2e}, reference {ref_err:.2e}); the scan's surf+outlier "
          f"cloud {scan_gap:.2e} m ({len(a)} / {len(b)} points); the pose on each side's "
          f"rebuild {own[0]:.2e} m, {own[1]:.2e} rad, on the port's {shared[0]:.2e} m, "
          f"{shared[1]:.2e} rad; near-collinear active surf rows (gap, normals apart in rad) "
          f"{[[(f'{g:.1e}', f'{d:.1e}') for g, d in zip(*r) if g < COLLINEAR_GAP] for r in rows]}")
    for gap, turn in rows:
        resolved = gap >= COLLINEAR_GAP
        assert (turn[resolved] <= 1e-3).all(), turn[resolved].max()
    if all((gap >= COLLINEAR_GAP).all() for gap, _ in rows):
        assert_pose_close(out["port"][1], out["ref"][1])


def _ptrs(pipe):
    return [t.data_ptr() for _, t in tpipe._flatten(pipe.state)]


def _eager_frames(cfg, st, pts, mask, frames, attempt_after=(), clock=None):
    """``slam_step`` over ``frames`` from ``st``, with a hoisted loop
    attempt after each frame in ``attempt_after`` (where the pipeline makes
    its own: after a frame, or a chunk, that crossed the loop cadence).
    ``clock``: the frames' stamps, by default ``f * scan_period``.  Returns
    the state and the poses."""
    out = []
    for f in frames:
        t = f * cfg.scan_period if clock is None else float(clock[f])
        st, pose = tpipe.slam_step(st, torch.from_numpy(pts[f]), torch.from_numpy(mask[f]),
                                   torch.full((), t), cfg,
                                   do_map_static=f % cfg.map_frame_decimation == 0,
                                   do_loop_static=False)
        out.append(pose)
        if f in attempt_after:
            st = st._replace(mapping=tlm.loop_closure_step(st.mapping, cfg)[0])
    return st, torch.stack(out).numpy()


def test_static_state_identity(tiny_run, tmp_path):
    cfg, pts, mask = tiny_run
    pipe = tpipe.SlamPipeline(cfg, device="cpu")
    ptrs = _ptrs(pipe)
    st = tpipe.init_state(cfg, "cpu")

    # an IMU flush before frame 0, then frames 0-3 through process (the
    # hoisted attempt after frame 2)
    imu = (0.0, (0.0, 0.01, 0.02), (0.1, 0.0, 9.8))
    pipe.add_imu(*imu)
    rows = torch.tensor([[imu[0], *imu[1], *imu[2]]])
    st = st._replace(imu=tdk.integrate_imu_chunk(st.imu, rows[:, 0], rows[:, 1:4],
                                                 rows[:, 4:7], 1))
    est = np.stack([pipe.process(pts[f], mask[f]).numpy() for f in range(4)])
    st, want = _eager_frames(cfg, st, pts, mask, range(4), attempt_after=(2,))
    np.testing.assert_array_equal(est, want)
    assert int(pipe.state.mapping.loop_attempts) == 1 and _ptrs(pipe) == ptrs
    tpipe.commit(pipe.state, pipe.state)       # a commit onto itself moves nothing
    assert _ptrs(pipe) == ptrs

    # a forced compaction, a checkpoint, then frames 4-7 through run_scanned
    # (the hoisted attempt after the chunk)
    pipe._maybe_compact(margin=cfg.max_keyframes)
    st = st._replace(mapping=tlm.compact_keyframes(st.mapping, cfg))
    assert pipe.compactions == 1 and _ptrs(pipe) == ptrs
    ck = str(tmp_path / "state.npz")
    pipe.save_checkpoint(ck)
    st_ck = st
    est = pipe.run_scanned(pts[4:8], mask[4:8])
    clock = np.arange(8, dtype=np.float32) * np.float32(cfg.scan_period)
    st, want = _eager_frames(cfg, st, pts, mask, range(4, 8), attempt_after=(7,), clock=clock)
    np.testing.assert_array_equal(est, want)
    assert int(pipe.state.mapping.loop_attempts) == 2 and _ptrs(pipe) == ptrs
    for (path, a), (_, b) in zip(tpipe._flatten(pipe.state), tpipe._flatten(st)):
        assert torch.equal(a, b), path

    # back to the checkpoint: frames 4-5 again
    pipe.load_checkpoint(ck)
    assert _ptrs(pipe) == ptrs and pipe._frame == 4
    est = np.stack([pipe.process(pts[f], mask[f]).numpy() for f in (4, 5)])
    _, want = _eager_frames(cfg, st_ck, pts, mask, (4, 5), attempt_after=(5,))
    np.testing.assert_array_equal(est, want)

    # reset: frames 0-1 again from a fresh state
    pipe.reset()
    assert _ptrs(pipe) == ptrs and int(pipe.state.frame) == 0
    est = pipe.run(pts[:2], mask[:2])
    _, want = _eager_frames(cfg, tpipe.init_state(cfg, "cpu"), pts, mask, range(2))
    np.testing.assert_array_equal(est, want)
    assert _ptrs(pipe) == ptrs
