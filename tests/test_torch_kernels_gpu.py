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


@pytest.mark.gpu
@pytest.mark.parametrize("image", ["seam", "rendered", "random"])
def test_ccl_kernel_matches_plain(cuda, image):
    if image == "random":   # a maze: many rounds, seam-crossing runs
        g = torch.Generator().manual_seed(0)
        cr = (torch.rand((16, 4000), generator=g) < 0.7).to(cuda)
        cu = (torch.rand((15, 4000), generator=g) < 0.5).to(cuda)
    else:
        cr, cu = (t.contiguous() for t in _edges(image, cuda))
    rounds = torch.zeros(1, dtype=torch.int32, device=cuda)
    got = ccl.ccl_cuda(cr, cu, rounds)
    torch.cuda.synchronize()
    assert 0 < int(rounds) < cr.numel()
    assert torch.equal(got, ccl.ccl_plain(cr, cu))


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
