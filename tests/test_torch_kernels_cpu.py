"""The port's plain CCL / 1-NN / k-NN (the CPU side of each CUDA kernel)
against the reference's Pallas kernels run in interpret mode.  Each CUDA
kernel is held against its plain version in test_torch_kernels_gpu.py,
which imports no jax so that it runs on the GPU machine.

The Pallas NN kernels compute direct difference-squares, as the port does,
so distances agree to rounding (1e-6 relative) and indices agree except on
exact distance ties.  Slots past the valid refs (all at the 1e30 penalty)
are such ties: the Pallas kernel's min-and-mask re-picks an already taken
entry there, the port the next invalid ref; both report d2 = 1e30.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from alego_tpu.config import tiny_config, PipelineConfig
from alego_tpu.ops import projection, segmentation
from alego_tpu.ops.pallas_ccl import ccl_fixpoint_pallas
from alego_tpu.ops.pallas_nn import nn1_pallas, knn_pallas
from alego_tpu.utils import synthetic

from alego_tpu_torch.ops import ccl as tccl, knn as tknn, nn as tnn

# one intra-op thread: the suite runs in several test processes at once,
# where more threads per process only contend for the cores
torch.set_num_threads(1)


def _seam_image():
    """The seam-crossing test image of tests/test_segmentation.py:99-126."""
    cfg = tiny_config(horizon_scan=64, ring_width=128, max_raw_points=2048)
    rng = np.random.default_rng(7)
    R, H = cfg.n_scan, 64
    ranges = np.full((R, H), projection.INVALID_RANGE)
    ranges[2:9, 5:25] = 10.0 + rng.normal(0, 0.01, (7, 20))
    ranges[10:14, 40:60] = 22.0 + rng.normal(0, 0.01, (4, 20))
    ranges[4:8, 60:] = 15.0
    ranges[4:8, :6] = 15.0
    for _ in range(30):
        i, j = rng.integers(0, R), rng.integers(0, H)
        ranges[i, j] = rng.uniform(5, 40)
    valid = ranges < projection.INVALID_RANGE * 0.5
    pts = np.zeros((R, H, 3), np.float32)
    pts[..., 0] = np.where(valid, ranges, 0)
    img = projection.RangeImage(points=jnp.asarray(pts),
                                ranges=jnp.asarray(ranges.astype(np.float32)),
                                valid=jnp.asarray(valid),
                                ground=jnp.zeros((R, H), bool))
    return cfg, img


def _rendered_image():
    """One rendered frame at the full 16 x 4000 geometry."""
    cfg = PipelineConfig()
    world = synthetic.make_world(seed=3)
    pts = synthetic.render_scan(world, np.eye(4), cfg, noise=0.01)
    good = np.isfinite(pts).all(-1)
    n = cfg.max_raw_points
    pad = np.zeros((n, 3), np.float32)
    m = np.zeros(n, bool)
    pad[: good.sum()] = pts[good][:n]
    m[: good.sum()] = True
    return cfg, projection.project_scan(jnp.asarray(pad), jnp.asarray(m), cfg)


@pytest.mark.parametrize("image", ["seam", "rendered"])
def test_plain_ccl_matches_pallas_and_xla(image):
    cfg, img = _seam_image() if image == "seam" else _rendered_image()
    segm = np.asarray(img.valid & ~img.ground)
    conn_r, conn_u = segmentation._neighbor_connectivity(img.ranges, jnp.asarray(segm), cfg)
    labels_xla, _, _ = jax.jit(lambda i: segmentation.label_components(i, cfg))(img)
    got = tccl.ccl_plain(torch.from_numpy(np.array(conn_r)),
                         torch.from_numpy(np.array(conn_u))).numpy()
    np.testing.assert_array_equal(got[segm], np.asarray(labels_xla)[segm])
    labels_pl = jax.jit(lambda r, u: ccl_fixpoint_pallas(r, u, interpret=True))(conn_r, conn_u)
    np.testing.assert_array_equal(got[segm], np.asarray(labels_pl)[segm])
    assert len(np.unique(got[segm])) > 3


def _nn_case(case, Q=300, N=1500):
    rng = np.random.default_rng({"holes": 0, "front": 1, "empty": 2, "few": 3}[case])
    q = rng.uniform(-50, 50, (Q, 3)).astype(np.float32)
    r = rng.uniform(-50, 50, (N, 3)).astype(np.float32)
    qm = rng.random(Q) < 0.9
    if case == "holes":           # mid-array mask holes
        rm = rng.random(N) < 0.7
    elif case == "front":         # front-compacted occupancy, dead tail tiles
        rm = np.zeros(N, bool)
        rm[:260] = True
        rm[40:50] = False
        qm[120:] = False
    elif case == "empty":         # every ref invalid
        rm = np.zeros(N, bool)
    else:                          # fewer valid refs than k
        rm = np.zeros(N, bool)
        rm[[3, 700]] = True
    return q, qm, r, rm


def _check_nn(d_port, i_port, d_ref, i_ref, q, qm, r, rm):
    d_port, i_port = np.asarray(d_port), np.asarray(i_port)
    d_ref, i_ref = np.asarray(d_ref), np.asarray(i_ref)
    np.testing.assert_allclose(d_port[qm], d_ref[qm], rtol=1e-6, atol=0)
    assert (d_port[~qm] == 1e30).all()
    assert ((i_port >= 0) & (i_port < r.shape[0])).all()
    # indices agree except on exact ties: both choices at the same distance,
    # or both in the 1e30 fill past the valid refs
    diff = (i_port != i_ref) & qm.reshape(qm.shape + (1,) * (i_port.ndim - 1))
    fill = (d_port >= 1e30) & (d_ref >= 1e30)
    tie = diff & ~fill
    if tie.any():
        dd = ((q[:, None] - r[None]) ** 2).sum(-1)
        rows = np.nonzero(tie)[0]
        a = np.take_along_axis(dd[rows], i_port[tie].reshape(-1, 1), 1)
        b = np.take_along_axis(dd[rows], i_ref[tie].reshape(-1, 1), 1)
        np.testing.assert_allclose(a, b, rtol=1e-6)


@pytest.mark.parametrize("case", ["holes", "front", "empty", "few"])
def test_plain_nn1_matches_pallas(case):
    q, qm, r, rm = _nn_case(case)
    d_ref, i_ref = nn1_pallas(jnp.asarray(q), jnp.asarray(qm), jnp.asarray(r),
                              jnp.asarray(rm), tq=128, tr=512, interpret=True)
    d, i = tnn.nn1_plain(torch.from_numpy(q), torch.from_numpy(qm),
                         torch.from_numpy(r), torch.from_numpy(rm), chunk=512)
    _check_nn(d, i, d_ref, i_ref, q, qm, r, rm)


@pytest.mark.parametrize("case", ["holes", "front", "empty", "few", "ties"])
def test_nn1_penalty_equals_skipping_invalid_refs(case):
    """The equivalence the 1-NN kernel rests on: the +1e30 penalty on invalid
    refs gives what a search over the valid refs alone gives, with indices
    mapped back, and (1e30, 0) where there is no valid ref or query."""
    q, qm, r, rm = _nn_case("holes" if case == "ties" else case)
    if case == "ties":   # equal-distance copies, the first ones partly masked
        r[750:] = r[:750]
    q_t, qm_t, r_t = (torch.from_numpy(a) for a in (q, qm, r))
    d, i = tnn.nn1_plain(q_t, qm_t, r_t, torch.from_numpy(rm))
    keep = np.nonzero(rm)[0]
    if keep.size:
        d_v, i_v = tnn.nn1_plain(q_t, qm_t, r_t[keep], torch.ones(keep.size, dtype=torch.bool))
        i_v = torch.where(qm_t, torch.from_numpy(keep)[i_v.long()].to(torch.int32), 0)
    else:
        d_v = torch.full((q.shape[0],), 1e30)
        i_v = torch.zeros(q.shape[0], dtype=torch.int32)
    assert torch.equal(d, d_v) and torch.equal(i, i_v)
    assert bool((d[~qm_t] == 1e30).all()) and not i[~qm_t].any()


@pytest.mark.parametrize("Q, N", [(512, 8192), (256, 2048), (1, 1), (77, 8191),
                                  (3072, 16384)])
def test_nn1_grid_fills_the_card(Q, N):
    """The 1-NN grid from the static shapes: whole chunks of 32 refs that
    cover N, within the grid's y limit, and at least two blocks per SM of
    an H100 (132 SMs) wherever the refs allow."""
    sms = 132
    chunk = tnn.nn1_chunk(Q, N, sms)
    chunks = -(-N // chunk)
    assert chunk % 32 == 0 and chunks * chunk >= N and chunks <= 65535
    blocks = -(-Q // tnn.NN1_QUERIES) * chunks
    assert blocks >= 2 * sms or chunk == 32


@pytest.mark.parametrize("k", [1, 5, 8])
@pytest.mark.parametrize("case", ["holes", "front", "empty", "few"])
def test_plain_knn_matches_pallas(case, k):
    q, qm, r, rm = _nn_case(case)
    d_ref, i_ref = knn_pallas(jnp.asarray(q), jnp.asarray(qm), jnp.asarray(r),
                              jnp.asarray(rm), k=k, tq=128, tr=512, interpret=True)
    d, i = tnn.knn_plain(torch.from_numpy(q), torch.from_numpy(qm),
                         torch.from_numpy(r), torch.from_numpy(rm), k, chunk=512)
    assert d.shape == (q.shape[0], k) and i.dtype == torch.int32
    _check_nn(d, i, d_ref, i_ref, q, qm, r, rm)
    n_valid = int(rm.sum())
    assert (np.asarray(d)[qm][:, n_valid:] == 1e30).all()


@pytest.mark.parametrize("Q, N", [(512, 8192), (256, 2048), (1, 1), (77, 8191),
                                  (3072, 16384), (1024, 8192)])
@pytest.mark.parametrize("k", [1, 5, 8])
def test_knn_grid_fills_the_card(Q, N, k):
    """The k-NN grid from the static shapes: whole chunks of 32 refs, at
    least 8 per key a chunk writes, that cover N within the grid's y limit,
    and at least two blocks per SM of an H100 (132 SMs) wherever the refs
    allow."""
    sms = 132
    chunk = tnn.knn_chunk(Q, N, k, sms)
    chunks = -(-N // chunk)
    smallest = -(-8 * k // 32) * 32
    assert chunk % 32 == 0 and chunk >= smallest
    assert chunks * chunk >= N and chunks <= 65535
    blocks = -(-Q // tnn.KNN_QUERIES) * chunks
    assert blocks >= 2 * sms or chunk == smallest


def _knn_skipping_invalid_refs(q, qm, r, rm, k):
    """The k-NN kernel's rule: the k-NN over the valid refs alone, indices
    mapped back, then the fill slots (the lowest indices in [0, max(N, k))
    that are not valid refs, at 1e30, clipped to N - 1); (1e30, 0) for an
    invalid query."""
    Q, N = q.shape[0], r.shape[0]
    keep = np.nonzero(rm)[0]
    n_v = min(k, keep.size)
    d = np.full((Q, k), 1e30, np.float32)
    i = np.zeros((Q, k), np.int32)
    if n_v:
        d_v, i_v = tnn.knn_plain(torch.from_numpy(q), torch.from_numpy(qm),
                                 torch.from_numpy(r[keep]),
                                 torch.ones(keep.size, dtype=torch.bool), n_v)
        d[:, :n_v] = d_v.numpy()
        i[:, :n_v] = keep[i_v.numpy()]
    fill = [j for j in range(max(N, k)) if j >= N or not rm[j]][:k - n_v]
    i[:, n_v:] = np.minimum(fill, N - 1)
    d[~qm], i[~qm] = 1e30, 0
    return d, i


@pytest.mark.parametrize("k", [1, 5, 8])
@pytest.mark.parametrize("case", ["holes", "front", "empty", "few", "short"])
def test_knn_penalty_equals_skipping_invalid_refs(case, k):
    """The equivalence the k-NN kernel rests on: the +1e30 penalty on invalid
    refs gives the valid refs in (d2, idx) order, then the fill slots."""
    if case == "short":   # N < k: the reference pads the refs to k
        q, qm, r, rm = _nn_case("holes")
        r, rm = r[:3], np.array([True, False, True])
    else:
        q, qm, r, rm = _nn_case(case)
    d, i = tnn.knn_plain(*(torch.from_numpy(a) for a in (q, qm, r, rm)), k)
    d_v, i_v = _knn_skipping_invalid_refs(q, qm, r, rm, k)
    np.testing.assert_array_equal(d.numpy(), d_v)
    np.testing.assert_array_equal(i.numpy(), i_v)
    if case == "few" and k > 2:   # valid refs 3 and 700: fill 0, 1, 2, 4, ...
        assert (i_v[qm][:, 2:] == [0, 1, 2, 4, 5, 6][:k - 2]).all()


def test_wrappers_dispatch_plain_on_cpu():
    q, qm, r, rm = (torch.from_numpy(a) for a in _nn_case("holes", 64, 200))
    d, i = tknn.knn_best(q, qm, r, rm, 5)
    d2, i2 = tnn.knn_plain(q, qm, r, rm, 5)
    assert torch.equal(d, d2) and torch.equal(i, i2)
    d, i = tknn.nn1_best(q, qm, r, rm)
    assert torch.equal(d, d2[:, 0]) and torch.equal(i, i2[:, 0])
    with pytest.raises(ValueError):
        tnn.knn_cuda(q, qm, r, rm, 5)      # a CPU tensor never reaches the kernel
    with pytest.raises(ValueError):
        tnn.nn1_cuda(q, qm, r, rm)
    with pytest.raises(ValueError):
        tccl.ccl_cuda(torch.zeros(16, 64, dtype=torch.bool),
                      torch.zeros(15, 64, dtype=torch.bool))
