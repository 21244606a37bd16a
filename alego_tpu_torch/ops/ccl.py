"""Connected-component labelling: the CUDA kernels' wrapper (``csrc/ccl.cu``,
union-find with no rounds) and its plain PyTorch version.

Port of ``alego_tpu.ops.pallas_ccl.ccl_fixpoint_pallas``.  Both compute
component-min flat-index labels [R, H] int32 of the 4-connected range image:
``conn_right [R, H]`` joins column c to c+1 (mod H, circular columns) and
``conn_up [R-1, H]`` joins row r to r+1.  The plain version is the
reference's XLA fixpoint (``alego_tpu.ops.segmentation``): horizontal
run-min by doubling reach masks, then a complete vertical sweep, until
nothing changes.

``ccl_labels`` dispatches on the device: a CPU tensor runs the plain
version, a CUDA tensor launches the kernel (or raises).
"""

from __future__ import annotations

import ctypes

import torch

from .. import kernels

# the kernels' limits: int32 flat indices, and one tile of all R rows x
# TILE_W columns of int32 parents in a block's shared memory
TILE_W = 64
MAX_PIXELS = 2 ** 31 - 1
SMEM_BYTES = 227 * 1024   # shared memory one Hopper block can use


# ---------------------------------------------------------------------------
# plain PyTorch version
# ---------------------------------------------------------------------------

def _reach_masks(conn_right: torch.Tensor):
    """masks[k][:, i]: columns i and i + 2^k circularly joined by a run."""
    H = conn_right.shape[1]
    masks = [conn_right]
    d = 1
    while d < H:
        masks.append(masks[-1] & torch.roll(masks[-1], -d, dims=1))
        d *= 2
    return masks


def _row_run_min(lab: torch.Tensor, masks, big: int) -> torch.Tensor:
    for k, Ck in enumerate(masks):
        d = 1 << k
        fwd = torch.where(Ck, torch.roll(lab, -d, dims=1), big)
        bwd = torch.where(torch.roll(Ck, d, dims=1), torch.roll(lab, d, dims=1), big)
        lab = torch.minimum(lab, torch.minimum(fwd, bwd))
    return lab


def ccl_plain(conn_right: torch.Tensor, conn_up: torch.Tensor) -> torch.Tensor:
    R, H = conn_right.shape
    big = R * H
    masks = _reach_masks(conn_right)
    lab = torch.arange(R * H, dtype=torch.int32,
                       device=conn_right.device).reshape(R, H)
    while True:
        rows = list(_row_run_min(lab, masks, big).unbind(0))
        for i in range(1, R):
            rows[i] = torch.minimum(rows[i], torch.where(conn_up[i - 1], rows[i - 1], big))
        for i in range(R - 2, -1, -1):
            rows[i] = torch.minimum(rows[i], torch.where(conn_up[i], rows[i + 1], big))
        new = torch.stack(rows)
        if torch.equal(new, lab):
            return new
        lab = new


# ---------------------------------------------------------------------------
# CUDA kernel wrapper
# ---------------------------------------------------------------------------

def _launcher():
    fn = kernels.library("ccl").alego_ccl
    if fn.argtypes is None:   # declare once: pointers must not be cut to int
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, i, i, p, p]
        fn.restype = ctypes.c_int
    return fn


def ccl_cuda(conn_right: torch.Tensor, conn_up: torch.Tensor) -> torch.Tensor:
    """Kernel launch (three CUDA kernels, one count); returns labels [R, H]
    int32."""
    R, H = conn_right.shape
    for name, t, shape in (("conn_right", conn_right, (R, H)),
                           ("conn_up", conn_up, (R - 1, H))):
        if t.device.type != "cuda" or t.device != conn_right.device:
            raise ValueError(f"{name} must lie on a CUDA device, not {t.device}")
        if t.dtype != torch.bool or tuple(t.shape) != shape:
            raise ValueError(f"{name} must be bool {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not (1 <= R and 1 <= H and R * H <= MAX_PIXELS):
        raise ValueError(f"image {R}x{H} exceeds the kernel's int32 labels")
    if R * TILE_W * 4 > SMEM_BYTES:
        raise ValueError(f"{R} rows do not fit one block's shared memory")
    labels = torch.empty((R, H), dtype=torch.int32, device=conn_right.device)
    stream = torch.cuda.current_stream(conn_right.device).cuda_stream
    status = _launcher()(conn_right.data_ptr(), conn_up.data_ptr(), R, H,
                         labels.data_ptr(), stream)
    kernels.check(status, "ccl kernel")
    kernels.LAUNCHES["ccl"] += 1
    return labels


def ccl_labels(conn_right: torch.Tensor, conn_up: torch.Tensor) -> torch.Tensor:
    if conn_right.device.type == "cpu":
        return ccl_plain(conn_right, conn_up)
    return ccl_cuda(conn_right, conn_up)
