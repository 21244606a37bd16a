"""Exact fused 1-NN / k-NN: the CUDA kernel wrappers (``csrc/nn1.cu``,
``csrc/nn.cu``) and their plain PyTorch versions.

Port of ``alego_tpu.ops.pallas_nn`` (``nn1_pallas`` / ``knn_pallas``).  Both
sides compute the Pallas function: direct f32 difference-squares with a
+1e30 penalty on invalid refs, 1e30 for invalid queries, d2 clamped to >= 0,
idx clipped to [0, N-1], ties to the lowest ref index.  An invalid query
reports index 0 on both sides (the Pallas kernel leaves it unspecified).

``ops/knn.py`` dispatches on the device of the inputs: a CPU tensor runs
the plain version, a CUDA tensor launches the kernel (or raises — there is
no fallback).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import kernels

BIG = 1e30
MAX_K = 8
# the 1-NN and k-NN grids: query tiles of NN1_QUERIES / KNN_QUERIES x ref
# chunks, about *_BLOCKS_PER_SM blocks on each SM in all
NN1_QUERIES = 64
NN1_BLOCKS_PER_SM = 4
KNN_QUERIES = 64
KNN_BLOCKS_PER_SM = 16
# refs per tile of the plain versions (two [Q, chunk] f32 buffers; 1024
# keeps them in cache on the CPU)
PLAIN_CHUNK = 1024


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------

def _tile_dists(qT: torch.Tensor, rT: torch.Tensor, pen: torch.Tensor,
                d: torch.Tensor, tmp: torch.Tensor):
    """Squared distances from coordinate-major points qT [3, Q] and
    rT [3, n] into d [Q, n], one rounded f32 operation at a time, through
    the caller's buffers d and tmp (no allocation per tile)."""
    torch.sub(qT[0, :, None], rT[0, None, :], out=d)
    d.mul_(d)
    for c in (1, 2):
        torch.sub(qT[c, :, None], rT[c, None, :], out=tmp)
        tmp.mul_(tmp)
        d.add_(tmp)
    return d.add_(pen[None, :])


def knn_plain(query, qmask, ref, rmask, k: int, chunk: int = PLAIN_CHUNK):
    """k best refs per query, ascending, the Pallas contract (see module).

    Streams the refs in chunks; per chunk the k best come
    from repeated min-and-mask (first index on ties), merged with the
    running best by a stable sort that keeps earlier (lower-index) entries
    first on ties."""
    Q, N = query.shape[0], ref.shape[0]
    pen = torch.where(rmask, 0.0, BIG).to(query.dtype)
    if N < k:   # Pallas pads the ref tile: the padding fills empty slots
        ref = torch.cat([ref, ref.new_zeros((k - N, 3))])
        pen = torch.cat([pen, pen.new_full((k - N,), BIG)])
    best_d = query.new_empty((Q, 0))
    best_i = torch.empty((Q, 0), dtype=torch.int64, device=query.device)
    qT, rT = query.T.contiguous(), ref.T.contiguous()
    width = min(chunk, ref.shape[0])
    buf, tmp = query.new_empty((Q, width)), query.new_empty((Q, width))
    for c0 in range(0, ref.shape[0], width):
        n = min(width, ref.shape[0] - c0)
        d = _tile_dists(qT, rT[:, c0:c0 + n], pen[c0:c0 + n], buf[:, :n], tmp[:, :n])
        loc_d, loc_i = [], []
        for j in range(min(k, n)):
            if j:
                d.scatter_(1, a, float("inf"))
            a = torch.argmin(d, dim=1, keepdim=True)
            loc_d.append(torch.gather(d, 1, a))
            loc_i.append(a + c0)
        cat_d = torch.cat([best_d] + loc_d, 1)
        cat_i = torch.cat([best_i] + loc_i, 1)
        cat_d, order = torch.sort(cat_d, dim=1, stable=True)
        best_d = cat_d[:, :k]
        best_i = torch.gather(cat_i, 1, order[:, :k])
    qm = qmask[:, None]
    d = torch.where(qm, torch.clamp(best_d, min=0.0), BIG)
    i = torch.where(qm, torch.clamp(best_i, 0, N - 1), 0).to(torch.int32)
    return d, i


def nn1_plain(query, qmask, ref, rmask, chunk: int = PLAIN_CHUNK):
    d, i = knn_plain(query, qmask, ref, rmask, 1, chunk)
    return d[:, 0], i[:, 0]


# ---------------------------------------------------------------------------
# CUDA kernel wrappers
# ---------------------------------------------------------------------------

def _launcher():
    fn = kernels.library("nn").alego_knn
    if fn.argtypes is None:   # declare once: pointers must not be cut to int
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, i, i, i, i, p, p, p, p]
        fn.restype = ctypes.c_int
    return fn


def _nn1_launcher():
    fn = kernels.library("nn1").alego_nn1
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, i, i, i, p, p, p, p]
        fn.restype = ctypes.c_int
    return fn


def nn1_chunk(Q: int, N: int, sms: int) -> int:
    """Refs per block of the 1-NN grid (a multiple of 32), from the static
    shapes: enough ref chunks that query tiles x chunks come to about
    NN1_BLOCKS_PER_SM blocks on each of ``sms`` SMs."""
    tiles = -(-Q // NN1_QUERIES)
    chunks = -(-NN1_BLOCKS_PER_SM * sms // tiles)
    per = -(-N // chunks)
    return max(32, -(-per // 32) * 32)


def knn_chunk(Q: int, N: int, k: int, sms: int) -> int:
    """Refs per block of the k-NN grid (a multiple of 32), from the static
    shapes: enough ref chunks that query tiles x chunks come to about
    KNN_BLOCKS_PER_SM blocks on each of ``sms`` SMs, and at least 8 refs a
    chunk for each of the k keys per query that a chunk writes for the
    merge."""
    tiles = -(-Q // KNN_QUERIES)
    chunks = -(-KNN_BLOCKS_PER_SM * sms // tiles)
    per = max(-(-N // chunks), 8 * k)
    return -(-per // 32) * 32


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _check_inputs(query, qmask, ref, rmask, k):
    if not 1 <= k <= MAX_K:
        raise ValueError(f"k must be in 1..{MAX_K}, got {k}")
    for name, t, dtype, shape in (("query", query, torch.float32, (None, 3)),
                                  ("qmask", qmask, torch.bool, (None,)),
                                  ("ref", ref, torch.float32, (None, 3)),
                                  ("rmask", rmask, torch.bool, (None,))):
        if t.device.type != "cuda" or t.device != query.device:
            raise ValueError(f"{name} must lie on query's CUDA device, not {t.device}")
        if t.dtype != dtype:
            raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
        if t.dim() != len(shape) or (len(shape) == 2 and t.shape[1] != 3):
            raise ValueError(f"{name} has shape {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if qmask.shape[0] != query.shape[0] or rmask.shape[0] != ref.shape[0]:
        raise ValueError("mask lengths must match their point sets")
    if query.shape[0] == 0 or ref.shape[0] == 0:
        raise ValueError("query and ref must be non-empty")


def knn_cuda(query, qmask, ref, rmask, k: int):
    """k-NN kernel launch; returns (d2 [Q, k] f32, idx [Q, k] int32).  No
    PyTorch op runs on the device besides the allocations."""
    _check_inputs(query, qmask, ref, rmask, k)
    Q, N = query.shape[0], ref.shape[0]
    chunk = knn_chunk(Q, N, k, _sm_count(query.device))
    part = torch.empty((-(-N // chunk), k, Q), dtype=torch.int64, device=query.device)
    d = torch.empty((Q, k), dtype=torch.float32, device=query.device)
    i = torch.empty((Q, k), dtype=torch.int32, device=query.device)
    stream = torch.cuda.current_stream(query.device).cuda_stream
    status = _launcher()(query.data_ptr(), qmask.data_ptr(), ref.data_ptr(),
                         rmask.data_ptr(), Q, N, k, chunk, part.data_ptr(),
                         d.data_ptr(), i.data_ptr(), stream)
    kernels.check(status, "knn kernel")
    kernels.LAUNCHES["knn"] += 1
    return d, i


def nn1_cuda(query, qmask, ref, rmask):
    """1-NN kernel launch; returns (d2 [Q] f32, idx [Q] int32).  No PyTorch
    op runs on the device besides the allocations."""
    _check_inputs(query, qmask, ref, rmask, 1)
    Q, N = query.shape[0], ref.shape[0]
    chunk = nn1_chunk(Q, N, _sm_count(query.device))
    part = torch.empty((-(-N // chunk), Q), dtype=torch.int64, device=query.device)
    d = torch.empty(Q, dtype=torch.float32, device=query.device)
    i = torch.empty(Q, dtype=torch.int32, device=query.device)
    stream = torch.cuda.current_stream(query.device).cuda_stream
    status = _nn1_launcher()(query.data_ptr(), qmask.data_ptr(), ref.data_ptr(),
                             rmask.data_ptr(), Q, N, chunk, part.data_ptr(),
                             d.data_ptr(), i.data_ptr(), stream)
    kernels.check(status, "nn1 kernel")
    kernels.LAUNCHES["nn1"] += 1
    return d, i
