"""Each CUDA kernel of the port against its plain PyTorch version, on the
GPU.  Skipped without one (a CUDA kernel has no CPU mode).

This file imports torch and numpy only — no jax — so it also runs on the
GPU machine, where the reference is not installed:
``python -m pytest --noconftest tests/test_torch_kernels_gpu.py -q``.
"""

import numpy as np
import pytest
import torch

from alego_tpu_torch import PipelineConfig, tiny_config
from alego_tpu_torch.ops import ccl, nn
from alego_tpu_torch.ops.projection import INVALID_RANGE, project_scan
from alego_tpu_torch.ops.segmentation import _neighbor_connectivity
from alego_tpu_torch.utils import synthetic


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernel has no CPU mode)")
    return torch.device("cuda")


def _edges(image, dev):
    """Edge masks of the seam test image or of a rendered full frame."""
    if image == "seam":
        cfg = tiny_config(horizon_scan=64, ring_width=128, max_raw_points=2048)
        rng = np.random.default_rng(7)
        R, H = cfg.n_scan, 64
        ranges = np.full((R, H), INVALID_RANGE, np.float32)
        ranges[2:9, 5:25] = 10.0 + rng.normal(0, 0.01, (7, 20))
        ranges[10:14, 40:60] = 22.0 + rng.normal(0, 0.01, (4, 20))
        ranges[4:8, 60:] = 15.0
        ranges[4:8, :6] = 15.0
        r = torch.from_numpy(ranges).to(dev)
        return _neighbor_connectivity(r, r < INVALID_RANGE * 0.5, cfg)
    cfg = PipelineConfig()
    pts = synthetic.render_scan(synthetic.make_world(seed=3), np.eye(4), cfg, noise=0.01)
    good = np.isfinite(pts).all(-1)
    img = project_scan(torch.from_numpy(pts[good]).to(dev),
                       torch.ones(int(good.sum()), dtype=torch.bool, device=dev), cfg)
    return _neighbor_connectivity(img.ranges, img.valid & ~img.ground, cfg)


def _image(image, dev):
    """Edge masks (conn_right [R, H], conn_up [R-1, H]) of one test image."""
    R, H = 16, 4000
    cr = torch.zeros((R, H), dtype=torch.bool)
    cu = torch.zeros((R - 1, H), dtype=torch.bool)
    if image == "random":        # a maze: many rounds, seam-crossing runs
        g = torch.Generator().manual_seed(0)
        cr = torch.rand((R, H), generator=g) < 0.7
        cu = torch.rand((R - 1, H), generator=g) < 0.5
    elif image == "serpentine":  # one snake up and down every column
        H = 512
        cr = torch.zeros((R, H), dtype=torch.bool)
        cu = torch.ones((R - 1, H), dtype=torch.bool)
        cr[0, 0:H - 1:2] = True
        cr[R - 1, 1:H - 1:2] = True
    elif image == "all":         # one component, labelled 0
        cr[:], cu[:] = True, True
    elif image == "none":        # every pixel its own component
        pass
    elif image == "seam_only":   # runs joined only across column H-1 -> 0
        cr[::2, H - 1] = True
        cr[1, H - 6:] = True
        cr[1, :5] = True
        cu[3, H - 1] = True
    elif image == "tile_borders":  # components straddling the 64-column tiles
        for c in range(60, H - 64, 192):
            cr[2:12, c:c + 70] = True
            cu[2:11, c + 3] = True
        cr[:, 3900:] = True
        cr[:, :20] = True
        cu[:, 3990] = True
    else:
        return tuple(t.contiguous() for t in _edges(image, dev))
    return cr.to(dev), cu.to(dev)


@pytest.mark.gpu
@pytest.mark.parametrize("image", ["seam", "rendered", "random", "serpentine",
                                   "all", "none", "seam_only", "tile_borders"])
def test_ccl_kernel_matches_plain(cuda, image):
    cr, cu = _image(image, cuda)
    got = ccl.ccl_cuda(cr, cu)
    torch.cuda.synchronize()
    assert torch.equal(got, ccl.ccl_plain(cr, cu))
    n = cr.numel()
    if image in ("serpentine", "all"):
        assert not got.any()
    elif image == "none":
        assert torch.equal(got.flatten().cpu(), torch.arange(n, dtype=torch.int32))


def _nn_case(case, Q=300, N=1500):
    rng = np.random.default_rng({"holes": 0, "front": 1, "empty": 2, "few": 3}[case])
    q = rng.uniform(-50, 50, (Q, 3)).astype(np.float32)
    r = rng.uniform(-50, 50, (N, 3)).astype(np.float32)
    qm = rng.random(Q) < 0.9
    rm = {"holes": rng.random(N) < 0.7, "front": np.arange(N) < 260,
          "empty": np.zeros(N, bool), "few": np.isin(np.arange(N), [3, 700])}[case]
    return q, qm, r, rm


@pytest.mark.gpu
@pytest.mark.parametrize("k", [1, 5, 8])
@pytest.mark.parametrize("case", ["holes", "front", "empty", "few"])
def test_nn_kernels_match_plain(cuda, case, k):
    """Bit-equal: both compute the same f32 operations in the same order."""
    q, qm, r, rm = (torch.from_numpy(a).to(cuda) for a in _nn_case(case))
    if k == 1:
        d, i = nn.nn1_cuda(q, qm, r, rm)
        d_p, i_p = nn.nn1_plain(q, qm, r, rm)
    else:
        d, i = nn.knn_cuda(q, qm, r, rm, k)
        d_p, i_p = nn.knn_plain(q, qm, r, rm, k)
    torch.cuda.synchronize()
    assert torch.equal(d, d_p) and torch.equal(i, i_p)


def _nn1_case(case):
    """1-NN inputs that probe the ref split: (query, qmask, ref, rmask)."""
    rng = np.random.default_rng(11)
    if case in ("surf", "corner"):   # the odometry shapes, front-compacted
        Q, N, q_live, r_live = {"surf": (512, 8192, 234, 7691),
                                "corner": (256, 2048, 102, 239)}[case]
        q = rng.uniform(-40, 40, (Q, 3)).astype(np.float32)
        r = rng.uniform(-40, 40, (N, 3)).astype(np.float32)
        qm, rm = np.arange(Q) < q_live, np.arange(N) < r_live
        rm[rng.integers(0, r_live, r_live // 10)] = False
        return q, qm, r, rm
    if case == "duplicates":         # eight equal copies, one per 1024 refs
        base = rng.uniform(-20, 20, (1024, 3)).astype(np.float32)
        r = np.tile(base, (8, 1))
        q = base[rng.integers(0, 1024, 512)] + rng.normal(0, 0.5, (512, 3)).astype(np.float32)
        rm = rng.random(8192) < 0.5      # a masked first copy passes the tie on
        return q, rng.random(512) < 0.9, r, rm
    if case == "ragged":             # N not a multiple of any chunk
        q = rng.uniform(-50, 50, (77, 3)).astype(np.float32)
        r = rng.uniform(-50, 50, (8191, 3)).astype(np.float32)
        return q, np.ones(77, bool), r, rng.random(8191) < 0.8
    if case == "single":             # Q = 1, N = 1
        return (np.array([[1, 2, 3]], np.float32), np.ones(1, bool),
                np.array([[3, 2, 1]], np.float32), np.ones(1, bool))
    # "no_query": every query invalid
    q = rng.uniform(-50, 50, (300, 3)).astype(np.float32)
    r = rng.uniform(-50, 50, (1500, 3)).astype(np.float32)
    return q, np.zeros(300, bool), r, np.ones(1500, bool)


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["surf", "corner", "duplicates", "ragged",
                                  "single", "no_query"])
def test_nn1_kernel_split_matches_plain(cuda, case):
    q, qm, r, rm = (torch.from_numpy(a).to(cuda) for a in _nn1_case(case))
    d, i = nn.nn1_cuda(q, qm, r, rm)
    d_p, i_p = nn.nn1_plain(q, qm, r, rm)
    torch.cuda.synchronize()
    assert torch.equal(d, d_p) and torch.equal(i, i_p)
    if case == "duplicates":   # every tie went to the first valid copy
        assert bool((i[qm] < 1024).any()) and bool((i[qm] >= 1024).any())
    if case == "no_query":
        assert bool((d == 1e30).all()) and not i.any()


@pytest.mark.gpu
def test_nn1_runs_only_its_kernels(cuda):
    """No PyTorch reduction runs on the device: only the two 1-NN kernels."""
    from torch.profiler import ProfilerActivity, profile
    q, qm, r, rm = (torch.from_numpy(a).to(cuda) for a in _nn1_case("surf"))
    nn.nn1_cuda(q, qm, r, rm)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        nn.nn1_cuda(q, qm, r, rm)
        torch.cuda.synchronize()
    names = {ev.name for ev in prof.events()
             if ev.device_type == torch.autograd.DeviceType.CUDA}
    assert names and all("nn1_" in n for n in names), names


def _knn_case(case):
    """k-NN inputs that probe the ref split, the merge and the fill slots:
    (query, qmask, ref, rmask)."""
    rng = np.random.default_rng(13)
    if case in ("surf", "corner"):   # the mapping shapes, front-compacted
        Q, N, q_live, r_live = {"surf": (3072, 16384, 2243, 11992),
                                "corner": (1024, 8192, 245, 1230)}[case]
        q = rng.uniform(-40, 40, (Q, 3)).astype(np.float32)
        r = rng.uniform(-40, 40, (N, 3)).astype(np.float32)
        qm, rm = np.arange(Q) < q_live, np.arange(N) < r_live
        rm[rng.integers(0, r_live, r_live // 10)] = False
        return q, qm, r, rm
    if case == "duplicates":         # eight equal copies, one per 1024 refs
        base = rng.uniform(-20, 20, (1024, 3)).astype(np.float32)
        r = np.tile(base, (8, 1))
        q = base[rng.integers(0, 1024, 512)] + rng.normal(0, 0.5, (512, 3)).astype(np.float32)
        return q, rng.random(512) < 0.9, r, rng.random(8192) < 0.5
    q = rng.uniform(-50, 50, (300, 3)).astype(np.float32)
    r = rng.uniform(-50, 50, (1500, 3)).astype(np.float32)
    qm, rm = rng.random(300) < 0.9, np.ones(1500, bool)
    if case == "few":                # fewer valid refs than k, with holes:
        rm = np.isin(np.arange(1500), [0, 2, 5, 900])   # fill 1, 3, 4, ...
    elif case == "short":            # N < k: the reference pads the refs
        r, rm = r[:3], np.array([True, False, True])
    elif case == "empty":            # no valid ref
        rm = np.zeros(1500, bool)
    elif case == "no_query":         # no valid query
        qm = np.zeros(300, bool)
    elif case == "ragged":           # N not a multiple of any chunk
        r = rng.uniform(-50, 50, (8191, 3)).astype(np.float32)
        rm = rng.random(8191) < 0.8
    return q, qm, r, rm


@pytest.mark.gpu
@pytest.mark.parametrize("k", [1, 5, 8])
@pytest.mark.parametrize("case", ["surf", "corner", "duplicates", "few", "short",
                                  "empty", "no_query", "ragged"])
def test_knn_kernel_split_matches_plain(cuda, case, k):
    q, qm, r, rm = (torch.from_numpy(a).to(cuda) for a in _knn_case(case))
    d, i = nn.knn_cuda(q, qm, r, rm, k)
    d_p, i_p = nn.knn_plain(q, qm, r, rm, k)
    torch.cuda.synchronize()
    assert torch.equal(d, d_p) and torch.equal(i, i_p)
    if case == "duplicates":   # ties went to the first valid copies
        assert bool((i[qm] < 1024).any()) and bool((i[qm] >= 1024).any())
    if case == "few" and k == 8:   # the four valid refs, then the fill
        got = i[qm].cpu()
        assert bool((got[:, :4].sort(1).values == torch.tensor([0, 2, 5, 900])).all())
        assert bool((got[:, 4:] == torch.tensor([1, 3, 4, 6])).all())
        assert bool((d[qm][:, 4:] == 1e30).all())
    if case == "no_query":
        assert bool((d == 1e30).all()) and not i.any()


@pytest.mark.gpu
def test_knn_runs_only_its_kernels(cuda):
    """No PyTorch reduction runs on the device: only the two k-NN kernels."""
    from torch.profiler import ProfilerActivity, profile
    q, qm, r, rm = (torch.from_numpy(a).to(cuda) for a in _knn_case("surf"))
    nn.knn_cuda(q, qm, r, rm, 5)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        nn.knn_cuda(q, qm, r, rm, 5)
        torch.cuda.synchronize()
    names = {ev.name for ev in prof.events()
             if ev.device_type == torch.autograd.DeviceType.CUDA}
    assert names and all("knn_" in n for n in names), names


def _loop_case(case, dev):
    """The loop-closure shapes: ICP's 1-NN of the decimated latest cloud
    (2048 of 4096, front-compacted with holes) against the voxelised history
    cloud (32768 slots, front-compacted), and the acceptance gate's k = 1
    search of a 4096-point query (every 2nd point of an 8192 cloud, made
    contiguous) against that history, masked to its structure points (more
    than 0.4 m above the cloud's ground level, as the gate masks it)."""
    rng = np.random.default_rng(17)
    hist = np.c_[rng.uniform(-45, 45, (32768, 2)), rng.uniform(-1.5, 3.0, 32768)]
    hist_ok = np.arange(32768) < 30111
    src = hist[rng.integers(0, 30111, 8192)] + rng.normal(0, 0.05, (8192, 3))
    src_ok = np.arange(8192) < 7000
    src_ok[rng.integers(0, 7000, 300)] = False
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    q, qm = t(src.astype(np.float32)), t(src_ok)
    r, rm = t(hist.astype(np.float32)), t(hist_ok)
    if case == "icp":
        q, qm = q[:4096:2], qm[:4096:2]
    else:
        z = torch.sort(torch.where(rm, r[:, 2], float("inf")))[0]
        ground = z[int(float(rm.sum()) * 0.1)]
        rm = rm & (r[:, 2] - ground > 0.4)
        q, qm = q[::2], qm[::2]
    return q, qm, r, rm


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["icp", "acceptance"])
def test_loop_shapes_match_plain(cuda, case):
    """nn1 at 2048 x 32768 (ICP) and the k = 1 k-NN at 4096 x 32768
    (acceptance), bit-equal to their plain versions; the sliced query is
    refused until it is made contiguous, as loop closure does once per
    attempt."""
    q, qm, r, rm = _loop_case(case, cuda)
    assert q.shape[0] == (2048 if case == "icp" else 4096) and r.shape[0] == 32768
    search = ((lambda *a: nn.nn1_cuda(*a)) if case == "icp"
              else (lambda *a: nn.knn_cuda(*a, 1)))
    with pytest.raises(ValueError, match="contiguous"):
        search(q, qm, r, rm)
    q, qm = q.contiguous(), qm.contiguous()
    d, i = search(q, qm, r, rm)
    if case == "icp":
        d_p, i_p = nn.nn1_plain(q, qm, r, rm)
    else:
        d_p, i_p = nn.knn_plain(q, qm, r, rm, 1)
        assert 0 < int(rm.sum()) < int((r[:, 2] > -10).sum())   # a structure-only mask
    torch.cuda.synchronize()
    assert torch.equal(d, d_p) and torch.equal(i, i_p)
    assert bool((d[qm] < 1e30).all())


# ---------------------------------------------------------------------------
# the gn kernel (one Gauss-Newton solve over a Correspondences batch)
# ---------------------------------------------------------------------------

# the pose the scene's rows are seen from: [tx, ty, tz, roll, pitch, yaw]
GN_TRUE_PARAMS = np.array([0.4, -0.3, 0.15, 0.03, -0.02, 0.08])
# the frame's three solves: (rows of each kind in order, solve options)
GN_COMPOSITIONS = {
    # odometry step A: the surf rows (max_flat), z only
    "step_a": (((1, 512),), dict(dims=(0, 0, 1, 0, 0, 0), min_count=10)),
    # odometry step B: surf rows then corner rows (max_sharp), the column
    # masks by kind
    "step_b": (((1, 512), (0, 256)),
               dict(dims=(1, 1, 1, 0, 0, 1), min_count=10,
                    kind_cols=((1, 1, 0, 0, 0, 1), (0, 0, 1, 0, 0, 0),
                               (0, 0, 1, 0, 0, 0)))),
    # mapping: corner rows (kf_corner_cap) then surf and outlier rows,
    # 6-DoF with the degeneracy projector
    "mapping": (((0, 1024), (2, 3072)),
                dict(dims=(1,) * 6, iters=20, eig_floor=1.0)),
}


def rpy_to_rot_np(rpy):
    r, p, y = rpy
    Rx = np.array([[1, 0, 0], [0, np.cos(r), -np.sin(r)], [0, np.sin(r), np.cos(r)]])
    Ry = np.array([[np.cos(p), 0, np.sin(p)], [0, 1, 0], [-np.sin(p), 0, np.cos(p)]])
    Rz = np.array([[np.cos(y), -np.sin(y), 0], [np.sin(y), np.cos(y), 0], [0, 0, 1]])
    return Rz @ Ry @ Rx


def gn_scene(parts, seed, live=0.7, noise=0.01):
    """A seeded batch for one solve, as numpy arrays (the Correspondences
    fields, f32, and kind int32): ``parts`` is ((kind, rows), ...) in row
    order.  Each kind's first ``live`` share of rows has weight 1 and is a
    point of a world plane or line seen from GN_TRUE_PARAMS with
    ``noise`` m of Gaussian noise, its partners drawn on the same plane or
    line (kind 0: two points 0.1 m either side, as the mapping's line fit
    gives them; kind 1: three nearby points of the plane; kind 2: the unit
    normal and offset); the rest is padding with weight 0 and zeros."""
    rng = np.random.default_rng(seed)
    R, t = rpy_to_rot_np(GN_TRUE_PARAMS[3:]), GN_TRUE_PARAMS[:3]
    planes = [(np.array([0, 0, 1.0]), -1.5), (np.array([1.0, 0, 0]), -8.0),
              (np.array([0, 1.0, 0]), 6.0), (np.array([0.6, 0.8, 0]), -9.0)]
    out = {k: [] for k in ("cp", "pj", "pl", "pm", "scalar", "kind", "weight")}
    for kind, n in parts:
        m = int(n * live)
        cp, pj, pl, pm = (np.zeros((n, 3)) for _ in range(4))
        scalar, w = np.zeros(n), np.zeros(n)
        w[:m] = 1.0
        for i in range(m):
            if kind == 0:
                d = rng.normal(size=3)
                d /= np.linalg.norm(d)
                X = rng.uniform(-10, 10, 3) + rng.uniform(-2, 2) * d
                pj[i], pl[i] = X + 0.1 * d, X - 0.1 * d
                X = X + rng.uniform(-0.5, 0.5) * d
            else:
                nrm, off = planes[rng.integers(len(planes))]
                X = rng.uniform(-10, 10, 3)
                X -= (nrm @ X + off) * nrm
                if kind == 1:
                    a = np.cross(nrm, rng.normal(size=3))
                    a /= np.linalg.norm(a)
                    b = np.cross(nrm, a)
                    pj[i] = X + rng.uniform(-0.3, 0.3) * a
                    pl[i] = X + 0.5 * a + rng.uniform(-0.2, 0.2) * b
                    pm[i] = X + 0.5 * b + rng.uniform(-0.2, 0.2) * a
                else:
                    pj[i], scalar[i] = nrm, off
            cp[i] = R.T @ (X + rng.normal(0, noise, 3) - t)
        out["cp"].append(cp)
        out["pj"].append(pj)
        out["pl"].append(pl)
        out["pm"].append(pm)
        out["scalar"].append(scalar)
        out["kind"].append(np.full(n, kind))
        out["weight"].append(w)
    return {k: np.concatenate(v).astype(np.int32 if k == "kind" else np.float32)
            for k, v in out.items()}


def gn_case(name, seed=0):
    """(scene dict, solve keyword arguments) of a composition or an edge
    case: "sign0" (step A from the identity with rows whose point is its
    plane's first point: a zero signed distance, sign(0) = 0),
    "eps_floor" (step B with lines of two equal points and planes of three
    collinear points, at the EPS floor), "zero_weights" (mapping with every
    weight 0: no step), "singular" (every weight 0, no damping, no
    min_count: H = 0, a zero pivot, no step), "nonfinite" (mapping with
    NaN and inf rows of weight 1, dropped) and "prior" (step B with a
    prior toward params0)."""
    base = {"sign0": "step_a", "eps_floor": "step_b", "zero_weights": "mapping",
            "singular": "mapping", "nonfinite": "mapping", "prior": "step_b"}.get(name, name)
    parts, opts = GN_COMPOSITIONS[base]
    scene = gn_scene(parts, seed)
    opts = dict(opts, iters=opts.get("iters", 5))
    params0 = np.zeros(6, np.float32) if name == "sign0" else \
        (GN_TRUE_PARAMS * 0.6).astype(np.float32)
    if name == "sign0":
        scene["cp"][:40] = scene["pj"][:40]
    elif name == "eps_floor":
        scene["pl"][:20] = scene["pj"][:20]                       # plane rows
        scene["pm"][:20] = 2 * scene["pj"][:20] - scene["pl"][20:40]
        scene["pl"][:20] = scene["pl"][20:40]                     # collinear
        scene["pl"][512:532] = scene["pj"][512:532]               # line rows
    elif name in ("zero_weights", "singular"):
        scene["weight"][:] = 0.0
        if name == "singular":
            opts = dict(opts, damping=0.0)
    elif name == "nonfinite":
        scene["cp"][3, 1] = np.nan
        scene["pj"][1500, 0] = np.inf
        scene["pl"][10, 2] = np.nan
    elif name == "prior":
        opts = dict(opts, prior_weight=2.0)
    return scene, params0, opts


def gn_torch(scene, params0, opts, dev):
    """The torch arguments of solve_correspondences for a gn_case."""
    from alego_tpu_torch.ops.residuals import Correspondences
    corr = Correspondences(*(torch.from_numpy(scene[k]).to(dev)
                             for k in Correspondences._fields))
    kw = {k: v for k, v in opts.items() if k not in ("dims", "iters", "kind_cols")}
    if "kind_cols" in opts:
        kw["kind_cols"] = torch.tensor(opts["kind_cols"], dtype=torch.float32).to(dev)
    return (corr, torch.from_numpy(params0).to(dev), opts["iters"],
            torch.tensor(opts["dims"], dtype=torch.bool).to(dev), 0.1), kw


# kernel against plain solve, params (m, rad): the two sum H and g in
# other orders (f64 against cuBLAS's f32), so they agree to the solve's
# convergence on these scenes, not bit for bit
GN_TOL = 1e-5


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["step_a", "step_b", "mapping", "sign0", "eps_floor",
                                  "zero_weights", "singular", "nonfinite", "prior"])
def test_gn_kernel_matches_plain(cuda, case):
    from alego_tpu_torch.ops import gauss_newton as gn
    args, kw = gn_torch(*gn_case(case), cuda)
    done = torch.zeros(1, dtype=torch.int32, device=cuda)
    got = gn.solve_correspondences_cuda(*args, **kw, iters_out=done)
    want = gn.solve_correspondences_plain(*args, **kw)
    torch.cuda.synchronize()
    p0 = args[1]
    if case in ("zero_weights", "singular"):   # no step: params0 to the bit
        assert torch.equal(got, p0) and torch.equal(want, p0)
        assert int(done) == 1                       # the stop after a zero step
        return
    assert bool(torch.isfinite(got).all()) and float((got - p0).abs().max()) > 1e-2
    assert 1 <= int(done) <= args[2]
    err = float((got - want).abs().max())
    assert err <= GN_TOL, f"{case}: kernel and plain solve {err:.3e} apart"


def graph_nodes(graph):
    """The nodes of a CUDA graph captured with ``keep_graph=True``, in the
    order CUDA lists them: (type, kernel name or None, cluster's blocks or
    None), read through libcuda (the CUDA driver API), not the profiler."""
    import ctypes
    cu = ctypes.CDLL("libcuda.so.1")

    def ok(status, what):
        assert status == 0, f"{what}: CUresult {status}"

    class KernelParams(ctypes.Structure):    # CUDA_KERNEL_NODE_PARAMS_v2
        _fields_ = [("func", ctypes.c_void_p), ("grid", ctypes.c_uint * 3),
                    ("block", ctypes.c_uint * 3), ("shared", ctypes.c_uint),
                    ("params", ctypes.c_void_p), ("extra", ctypes.c_void_p),
                    ("kern", ctypes.c_void_p), ("ctx", ctypes.c_void_p)]

    handle = ctypes.c_void_p(graph.raw_cuda_graph())
    count = ctypes.c_size_t(0)
    ok(cu.cuGraphGetNodes(handle, None, ctypes.byref(count)), "cuGraphGetNodes")
    nodes = (ctypes.c_void_p * count.value)()
    ok(cu.cuGraphGetNodes(handle, nodes, ctypes.byref(count)), "cuGraphGetNodes")
    types = {0: "kernel", 1: "memcpy", 2: "memset", 3: "host", 4: "graph", 5: "empty"}
    out = []
    for node in nodes:
        node = ctypes.c_void_p(node)
        kind = ctypes.c_int(-1)
        ok(cu.cuGraphNodeGetType(node, ctypes.byref(kind)), "cuGraphNodeGetType")
        if kind.value != 0:
            out.append((types.get(kind.value, kind.value), None, None))
            continue
        prm = KernelParams()
        ok(cu.cuGraphKernelNodeGetParams_v2(node, ctypes.byref(prm)),
           "cuGraphKernelNodeGetParams")
        name = ctypes.c_char_p()
        if prm.func:
            ok(cu.cuFuncGetName(ctypes.byref(name), ctypes.c_void_p(prm.func)), "cuFuncGetName")
        else:
            ok(cu.cuKernelGetName(ctypes.byref(name), ctypes.c_void_p(prm.kern)),
               "cuKernelGetName")
        value = (ctypes.c_uint * 16)()          # CUlaunchAttributeValue (64 bytes)
        ok(cu.cuGraphKernelNodeGetAttribute(node, 4, value),   # CLUSTER_DIMENSION
           "cuGraphKernelNodeGetAttribute")
        out.append(("kernel", name.value.decode(), value[0] * value[1] * value[2]))
    return out


@pytest.mark.gpu
def test_gn_runs_only_its_kernel(cuda):
    """One launch of gn_solve per solve and no other device work; the count
    grows by one a solve.  The solve's device work is read from a CUDA
    graph that captures it (the wrapper runs the same code eagerly and
    under capture): one node, the gn_solve kernel on gn_plan's cluster,
    whose replay gives the eager answer bit for bit."""
    from alego_tpu_torch import kernels
    from alego_tpu_torch.ops import gauss_newton as gn
    args, kw = gn_torch(*gn_case("mapping"), cuda)
    before = kernels.LAUNCHES["gn"]
    eager = gn.solve_correspondences(*args, **kw)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["gn"] == before + 1
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        out = gn.solve_correspondences(*args, **kw)
    assert kernels.LAUNCHES["gn"] == before + 2
    nodes = graph_nodes(graph)
    blocks = gn.gn_plan(args[0].cp.shape[0], kw.get("prior_weight", 0.0) > 0)[0]
    assert len(nodes) == 1 and nodes[0][0] == "kernel", nodes
    assert "gn_solve" in nodes[0][1] and nodes[0][2] == blocks, nodes
    graph.instantiate()
    out.zero_()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, eager)


def gn_rows_case(rows, seed=3):
    """A mapping solve over ``rows`` rows, a quarter of them lines and the
    rest fitted planes, every row weighted; with 0 or 1 rows a prior
    toward params0 keeps the system well posed."""
    corner = rows // 4
    scene = gn_scene(((0, corner), (2, rows - corner)), seed, live=1.0)
    opts = dict(GN_COMPOSITIONS["mapping"][1])
    if rows < 2:
        opts["prior_weight"] = 2.0
    return scene, (GN_TRUE_PARAMS * 0.6).astype(np.float32), opts


@pytest.mark.gpu
@pytest.mark.parametrize("rows, blocks", [(0, 1), (1, 1), (255, 1), (257, 2), (511, 2),
                                          (513, 3), (2048, 8), (4096, 8), (4097, 8),
                                          (8192, 8), (30000, 8)])
def test_gn_cluster_edges_match_plain(cuda, rows, blocks):
    """Row counts at the edges of the cluster (gauss_newton.gn_plan, 256
    threads a block): no batch row, only the prior's; one row; one block
    one row a thread; a second block; 2 and 3 blocks (the odometry
    solves); 8 blocks one row a thread; two rows a thread (the mapping
    solve); a ragged last block; 4 rows a thread; more rows a block than
    it stages (3456: the rest read from global memory).  Against the
    plain solve, and two launches bit for bit."""
    from alego_tpu_torch.ops import gauss_newton as gn
    args, kw = gn_torch(*gn_rows_case(rows), cuda)
    assert gn.gn_plan(rows, kw.get("prior_weight", 0.0) > 0)[0] == blocks
    got = gn.solve_correspondences_cuda(*args, **kw)
    again = gn.solve_correspondences_cuda(*args, **kw)
    want = gn.solve_correspondences_plain(*args, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    assert bool(torch.isfinite(got).all())
    if rows == 0:       # the prior alone: no step
        assert torch.equal(got, args[1])
    err = float((got - want).abs().max())
    assert err <= GN_TOL, f"{rows} rows: kernel and plain solve {err:.3e} apart"


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["step_b", "mapping"])
def test_gn_kernel_replays_from_a_graph(cuda, case):
    """Captured into a CUDA graph, the solve's cluster launch (step B: 3
    blocks; mapping: 8 blocks and the projector) replays the eager answer
    bit for bit (the sums' order is fixed: thread, warp, block, cluster
    rank; no atomics), on new inputs copied into the captured ones too."""
    from alego_tpu_torch.ops import gauss_newton as gn
    args, kw = gn_torch(*gn_case(case), cuda)
    eager = gn.solve_correspondences_cuda(*args, **kw)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        gn.solve_correspondences_cuda(*args, **kw)
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        out = gn.solve_correspondences_cuda(*args, **kw)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, eager)
    args2, kw2 = gn_torch(*gn_case(case, seed=1), cuda)
    for a, b in zip(args[0], args2[0]):
        a.copy_(b)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, gn.solve_correspondences_cuda(*args2, **kw2))
