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
