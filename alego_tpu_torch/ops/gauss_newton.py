"""Masked 6-DoF Gauss-Newton with Huber IRLS, the port of
``alego_tpu.ops.gauss_newton``.

The reference's ``lax.while_loop`` (stop after ``iters`` or once the step
falls to ``param_tol``) becomes a fixed ``iters``-long loop whose update is
a masked no-op once the step has fallen below the tolerance: the same result
with no host synchronisation.  ``torch.linalg.solve_ex`` replaces ``solve``,
which would synchronise to raise on a singular system; ``gn_step`` already
zeroes non-finite updates.  The degeneracy projector's 6x6 symmetric
eigendecomposition is a cyclic Jacobi with a fixed number of sweeps in
torch ops (``torch.linalg.eigh`` checks its status on the host), so the
whole solve can be captured in a CUDA graph.

:func:`solve_correspondences` is the frame step's solve over a
:class:`~.residuals.Correspondences` batch: on a CUDA tensor one launch of
the ``csrc/gn.cu`` kernel runs the whole solve (a thread-block cluster of
:func:`gn_plan`'s blocks); on a CPU tensor its plain version, ``solve_gn``
over ``eval_correspondences``, runs.
"""

from __future__ import annotations

import ctypes
from typing import Callable

import torch

from .. import kernels
from ..device import vector
from .residuals import Correspondences, eval_correspondences


def huber_weight(r: torch.Tensor, delta: float) -> torch.Tensor:
    a = torch.abs(r)
    return torch.where(a <= delta, 1.0, delta / torch.clamp(a, min=1e-12))


def _drop_nonfinite(r, J, w):
    row_ok = torch.isfinite(r) & torch.all(torch.isfinite(J), dim=-1)
    return (torch.where(row_ok, r, 0.0), torch.where(row_ok[:, None], J, 0.0),
            w * row_ok.to(w.dtype))


def normal_equations(J: torch.Tensor, Jw: torch.Tensor, r: torch.Tensor):
    """H = J^T Jw [6, 6] and g = Jw^T r [6] in J's dtype (the ``gn`` kernel
    takes these sums in f64)."""
    return J.T @ Jw, Jw.T @ r


def gn_step(params, r, J, weight, dim_mask, huber_delta: float,
            damping: float = 1e-6, min_count: int = 0) -> torch.Tensor:
    """One masked GN update; weight is per-residual validity (0 = padding).
    Non-finite rows are dropped; masked dims are frozen by an identity
    block in H and a zero gradient."""
    r, J, weight = _drop_nonfinite(r, J, weight)
    w = weight * huber_weight(r, huber_delta)
    Jw = J * w[:, None]
    H, g = normal_equations(J, Jw, r)

    m = dim_mask.to(params.dtype)
    eye = torch.eye(6, dtype=params.dtype, device=params.device)
    H = H * (m[:, None] * m[None, :]) + torch.diag(1.0 - m)
    H = H + damping * eye
    g = g * m

    sol, info = torch.linalg.solve_ex(H, g[:, None])
    delta = -sol[:, 0]
    ok = ((torch.sum(weight > 0) >= min_count) & (info == 0)
          & torch.all(torch.isfinite(delta)))
    return params + torch.where(ok, delta, 0.0)


# the 15 pairs of a 6x6 matrix in 5 rounds of 3 disjoint pairs (a
# round-robin tournament): the rotations of a round commute, so each round
# is one orthogonal matrix
_JACOBI_ROUNDS = (((0, 1), (2, 5), (3, 4)), ((0, 2), (1, 3), (4, 5)),
                  ((0, 3), (2, 4), (1, 5)), ((0, 4), (3, 5), (1, 2)),
                  ((0, 5), (1, 4), (2, 3)))
# sweeps of the cyclic Jacobi: convergence is quadratic; after 6 the
# off-diagonal is below 1e-12 of the largest entry on spectra spread over
# nine decades (tests/test_torch_graph_step.py)
JACOBI_SWEEPS = 6
_jacobi_tables: dict = {}


def _jacobi_table(device: torch.device):
    """Per round: the flat indices of (a_pp, a_qq, a_pq) of its 3 pairs
    [9], and for the round's rotation J (flat [36]) the index of each entry
    in the rotations' (cos, sin) pairs [6] with its sign (0 off the
    pairs).  Built once per device by fills (never copied from the host)
    and kept."""
    tab = _jacobi_tables.get(device)
    if tab is None:
        tab = []
        for pairs in _JACOBI_ROUNDS:
            take = [p * 6 + p for p, _ in pairs] + [q * 6 + q for _, q in pairs] \
                + [p * 6 + q for p, q in pairs]
            src, sign = [0] * 36, [0.0] * 36
            for k, (p, q) in enumerate(pairs):
                src[p * 6 + p] = src[q * 6 + q] = 2 * k
                src[p * 6 + q] = src[q * 6 + p] = 2 * k + 1
                sign[p * 6 + p] = sign[q * 6 + q] = sign[p * 6 + q] = 1.0
                sign[q * 6 + p] = -1.0
            tab.append((vector(take, torch.int64, device),
                        vector(src, torch.int64, device),
                        vector(sign, torch.float64, device)))
        _jacobi_tables[device] = tab
    return tab


def eigh6(A: torch.Tensor):
    """Eigenvalues [6] and eigenvectors [6, 6] (columns) of a symmetric 6x6
    matrix by cyclic Jacobi in f64: JACOBI_SWEEPS x 5 rounds, each annihilating
    three disjoint off-diagonal pairs with the rotation of angle phi / 2,
    phi = atan2(2 a_pq sgn(d), |d|), d = a_qq - a_pp (|angle| <= pi/4;
    (cos, sin) of the half angle as the principal square root of
    exp(i phi)).  14 small ops a round, no host synchronisation and no
    data-dependent control flow.  Unordered, signs unspecified."""
    A = A.to(torch.float64)
    V = torch.eye(6, dtype=torch.float64, device=A.device)
    one = torch.ones(3, dtype=torch.float64, device=A.device)
    for _ in range(JACOBI_SWEEPS):
        for take, src, sign in _jacobi_table(A.device):
            app, aqq, apq = torch.take(A, take).reshape(3, 3)
            d = aqq - app
            # a_pq sgn(d): the sign of a_pq d on the magnitude of a_pq
            y = torch.copysign(apq, apq * d)
            phi = torch.atan2(y + y, torch.abs(d))
            cs = torch.view_as_real(torch.sqrt(torch.polar(one, phi)))
            J = (torch.take(cs, src) * sign).reshape(6, 6)
            A = J.T @ A @ J
            V = V @ J
    return torch.diagonal(A), V


def degeneracy_projector(H: torch.Tensor, eig_floor: float) -> torch.Tensor:
    """LOAM-style degeneracy guard P = V diag(lam > floor) V^T; a non-finite
    H gives P = 0 (keep the warm start).  The eigenvectors come from
    :func:`eigh6` in f64 and P is formed in H's dtype, as the reference
    forms it from its ``eigh``; only P is used, so the eigenvectors' order
    and signs do not matter."""
    finite = torch.all(torch.isfinite(H))
    eye = torch.eye(H.shape[0], dtype=H.dtype, device=H.device)
    lam, V = eigh6(torch.where(finite, H, eye))
    V = V.to(H.dtype)
    keep = ((lam > eig_floor) & finite).to(H.dtype)
    return (V * keep[None, :]) @ V.T


def solve_gn(residual_fn: Callable[[torch.Tensor], tuple],
             params0: torch.Tensor, iters: int, dim_mask: torch.Tensor,
             huber_delta: float, damping: float = 1e-6,
             min_count: int = 0, param_tol: float = 1e-4,
             eig_floor: float = 0.0, prior_weight: float = 0.0,
             max_step: float = 1.0, iters_out=None) -> torch.Tensor:
    """GN with at most ``iters`` iterations and Ceres-style early stop.

    ``eig_floor > 0`` projects every update through the degeneracy
    projector built once, before the loop, from the warm-start
    linearisation (upstream LeGO-LOAM's iterCount == 0 test).
    ``prior_weight > 0`` adds a Tikhonov prior toward ``params0`` on the
    masked dims.  Each step is capped at ``max_step`` (the bounding role of
    Ceres's trust region).  ``iters_out`` ([1] int32 on params0's device,
    or None) receives the iterations run, the reference's ``while_loop``
    count, written on the device."""
    _check_iters_out(iters_out, params0)
    dt, dev = params0.dtype, params0.device
    m = dim_mask.to(dt)
    eye = torch.eye(6, dtype=dt, device=dev)

    def res_with_prior(p):
        r, J, w = _drop_nonfinite(*residual_fn(p))
        if prior_weight > 0.0:
            sw = torch.sqrt(torch.full((), prior_weight, dtype=dt, device=dev))
            r_p = sw * (p - params0)
            w_p = 1.0 / torch.clamp(huber_weight(r_p, huber_delta), min=1e-12)
            r = torch.cat([r, r_p])
            J = torch.cat([J, sw * eye])
            w = torch.cat([w, w_p])
        return r, J, w

    rJw = res_with_prior(params0)
    P = eye
    if eig_floor > 0.0:
        r, J, w = rJw
        hw = w * huber_weight(r, huber_delta)
        H0, _ = normal_equations(J, J * hw[:, None], r)
        H0 = H0 * (m[:, None] * m[None, :]) + torch.diag(1.0 - m)
        P = degeneracy_projector(H0, eig_floor)
    mc = min_count + (6 if prior_weight > 0.0 else 0)

    p = params0
    live = torch.ones((), dtype=torch.bool, device=dev)
    done = torch.zeros((), dtype=torch.int32, device=dev)
    for it in range(iters):
        r, J, w = rJw if it == 0 else res_with_prior(p)
        p_new = gn_step(p, r, J, w, dim_mask, huber_delta, damping, mc)
        d = P @ (p_new - p)
        if max_step > 0.0:
            s = torch.max(torch.abs(d))
            d = d * torch.clamp(max_step / torch.clamp(s, min=1e-12), max=1.0)
        p_new = p + d
        step = torch.max(torch.abs(p_new - p))
        p = torch.where(live, p_new, p)
        if iters_out is not None:
            done = done + live.to(torch.int32)
        live = live & (step > param_tol)
    if iters_out is not None:
        iters_out.copy_(done.reshape(1))
    return p


def _check_iters_out(iters_out, params0):
    if iters_out is not None and (iters_out.dtype != torch.int32
                                  or iters_out.device != params0.device
                                  or tuple(iters_out.shape) != (1,)):
        raise ValueError("iters_out must be a [1] int32 tensor on params0's device")


# Dim masks for the reference's two-step scan-to-scan split
SURF_DIMS = (0, 0, 1, 0, 0, 0)      # z only (utility.h:224-232)
CORNER_DIMS = (1, 1, 0, 0, 0, 1)    # x, y, yaw (utility.h:162-167)
STEP_B_DIMS = (1, 1, 1, 0, 0, 1)    # union: joint second solve
FULL_DIMS = (1, 1, 1, 1, 1, 1)      # scan-to-map 6-DoF


def dims(mask: tuple, like: torch.Tensor) -> torch.Tensor:
    """A dim mask as a bool tensor on ``like``'s device, written by fills
    (``torch.tensor(..., device=cuda)`` would copy from the host and wait)."""
    return vector(mask, torch.bool, like.device)


# ---------------------------------------------------------------------------
# the solve over a Correspondences batch: plain version and CUDA kernel
# ---------------------------------------------------------------------------

def solve_correspondences_plain(corr: Correspondences, params0, iters: int,
                                dim_mask, huber_delta: float, *, kind_cols=None,
                                damping: float = 1e-6, min_count: int = 0,
                                param_tol: float = 1e-4, eig_floor: float = 0.0,
                                prior_weight: float = 0.0, max_step: float = 1.0,
                                iters_out=None):
    """The plain version of the ``gn`` kernel: :func:`solve_gn` over the
    batch's rows evaluated by kind, each row's Jacobian multiplied by its
    kind's row of ``kind_cols`` [3, 6] (None: no column mask).
    ``iters_out``: as the kernel's, the iterations run."""
    def residuals(p):
        r, J = eval_correspondences(p, corr)
        if kind_cols is not None:
            k = corr.kind[:, None]
            J = J * torch.where(k == 0, kind_cols[0],
                                torch.where(k == 1, kind_cols[1], kind_cols[2]))
        return r, J, corr.weight

    return solve_gn(residuals, params0, iters, dim_mask, huber_delta, damping,
                    min_count, param_tol, eig_floor, prior_weight, max_step, iters_out=iters_out)


# the gn kernel's launch (csrc/gn.cu): threads per block, and the most
# blocks in its cluster (the portable cluster size)
GN_THREADS, GN_MAX_BLOCKS = 256, 8


def gn_plan(n: int, prior: bool) -> tuple:
    """The ``gn`` kernel's cluster over ``n`` batch rows (and the prior's 6
    rows): (blocks, chunk).  One block per ``GN_THREADS`` rows, at most
    ``GN_MAX_BLOCKS``; block b owns the batch rows [b * chunk, min((b + 1)
    * chunk, n)), chunk a multiple of 4 (so each block's slice of every
    field starts 16-byte aligned for its bulk copy), and the last block
    also the prior's rows."""
    rows = n + (6 if prior else 0)
    blocks = min(GN_MAX_BLOCKS, max(1, -(-rows // GN_THREADS)))
    chunk = -(-n // blocks)
    return blocks, chunk + (-chunk) % 4


def _gn_launcher():
    fn = kernels.library("gn").alego_gn_solve
    if fn.argtypes is None:   # declare once: pointers must not be cut to int
        p, i, d = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
        fn.argtypes = [p] * 7 + [i, i, i, p, p, p, p, p, i, d, d, i, d, d, d, d, p]
        fn.restype = ctypes.c_int
    return fn


def _check_batch(corr: Correspondences, params0, dim_mask, kind_cols):
    dev = params0.device
    n = corr.cp.shape[0]
    want = [("cp", torch.float32, (n, 3)), ("pj", torch.float32, (n, 3)),
            ("pl", torch.float32, (n, 3)), ("pm", torch.float32, (n, 3)),
            ("scalar", torch.float32, (n,)), ("kind", torch.int32, (n,)),
            ("weight", torch.float32, (n,))]
    named = [(name, getattr(corr, name), dt, sh) for name, dt, sh in want]
    named += [("params0", params0, torch.float32, (6,)),
              ("dim_mask", dim_mask, torch.bool, (6,))]
    if kind_cols is not None:
        named.append(("kind_cols", kind_cols, torch.float32, (3, 6)))
    for name, t, dt, sh in named:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{name} must lie on params0's CUDA device, not {t.device}")
        if t.dtype != dt:
            raise ValueError(f"{name} must be {dt}, got {t.dtype}")
        if tuple(t.shape) != sh:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, not {sh}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def solve_correspondences_cuda(corr: Correspondences, params0, iters: int,
                               dim_mask, huber_delta: float, *, kind_cols=None,
                               damping: float = 1e-6, min_count: int = 0,
                               param_tol: float = 1e-4, eig_floor: float = 0.0,
                               prior_weight: float = 0.0, max_step: float = 1.0,
                               iters_out=None):
    """One launch of the ``gn`` kernel: the whole solve, on a cluster of
    :func:`gn_plan`'s blocks; returns the params [6].  ``iters_out`` ([1]
    int32 on the device, or None) receives the iterations run.  No PyTorch
    op runs on the device besides the output's allocation.  A refused
    launch raises."""
    _check_batch(corr, params0, dim_mask, kind_cols)
    _check_iters_out(iters_out, params0)
    out = torch.empty(6, dtype=torch.float32, device=params0.device)
    stream = torch.cuda.current_stream(params0.device).cuda_stream
    n = corr.cp.shape[0]
    status = _gn_launcher()(
        corr.cp.data_ptr(), corr.pj.data_ptr(), corr.pl.data_ptr(), corr.pm.data_ptr(),
        corr.scalar.data_ptr(), corr.kind.data_ptr(), corr.weight.data_ptr(),
        n, *gn_plan(n, prior_weight > 0.0), None if kind_cols is None else kind_cols.data_ptr(),
        dim_mask.data_ptr(), params0.data_ptr(), out.data_ptr(),
        None if iters_out is None else iters_out.data_ptr(), int(iters),
        float(huber_delta), float(damping), int(min_count), float(param_tol),
        float(eig_floor), float(prior_weight), float(max_step), stream)
    kernels.check(status, "gn kernel")
    kernels.LAUNCHES["gn"] += 1
    return out


def solve_correspondences(corr: Correspondences, params0, iters: int, dim_mask,
                          huber_delta: float, *, kind_cols=None, damping: float = 1e-6,
                          min_count: int = 0, param_tol: float = 1e-4,
                          eig_floor: float = 0.0, prior_weight: float = 0.0,
                          max_step: float = 1.0):
    """:func:`solve_gn` over the rows of ``corr`` (see
    :func:`solve_correspondences_plain`): the ``gn`` kernel for tensors on
    the GPU, its plain version for tensors on the CPU."""
    solve = (solve_correspondences_plain if params0.device.type == "cpu"
             else solve_correspondences_cuda)
    return solve(corr, params0, iters, dim_mask, huber_delta, kind_cols=kind_cols,
                 damping=damping, min_count=min_count, param_tol=param_tol,
                 eig_floor=eig_floor, prior_weight=prior_weight, max_step=max_step)
