# Frozen copy of alego_tpu_torch/ops/chain_solver.py for the benchmark's reference: plain
# PyTorch only, its imports made local; see portbench/reference/__init__.py.
"""Factored O(N) solve of the pose-graph chain Hessian, the port of
``alego_tpu.ops.chain_solver``.

The chain + prior part of the pose-graph normal equations is exactly
``T = J^T Info J`` with ``J = Dg @ B``: ``Dg = blockdiag(Jr_i)`` and
``B = I - subdiag(Ad_i)`` unit block-bidiagonal.  So

    T^{-1} = B^{-1} Dg^{-1} Info^{-1} Dg^{-T} B^{-T}

is two block-bidiagonal triangular solves, per-block 6x6 solves and a
diagonal scale, and T is never formed (forming it squares the
conditioning).  The triangular solves are affine prefix recursions
``x_i = A_i x_{i-1} + b_i``; the reference runs them as
``lax.associative_scan``, here they are a log-depth doubling scan of batched
6x6 affine maps (11 steps at N = 2048).  The doubling scan composes the maps
in another order than XLA's scan, so results agree with the reference to
f32 rounding, not bit for bit.
"""

from __future__ import annotations

import torch


def affine_scan_carry(A: torch.Tensor, b: torch.Tensor, reverse: bool = False):
    """Prefix-compose the affine recursion x_i = A_i @ x_{i-1} + b_i,
    returning both composed maps.

    A [N, 6, 6], b [N, 6, K] -> (A_out [N, 6, 6], x [N, 6, K]) where
    ``A_out[i]`` is the product A_i @ ... @ A_0 (reversed analogously).
    With ``reverse=True`` the recursion is x_i = A_i @ x_{i+1} + b_i."""
    if reverse:
        A_out, x = affine_scan_carry(A.flip(0), b.flip(0))
        return A_out.flip(0), x.flip(0)
    N = A.shape[0]
    d = 1
    while d < N:
        # element i absorbs the composed prefix ending at i - d:
        # (A_i, b_i) <- (A_i A_{i-d}, A_i b_{i-d} + b_i)
        A_hi, b_hi = A[d:], b[d:]
        A = torch.cat([A[:d], A_hi @ A[:-d]], 0)
        b = torch.cat([b[:d], A_hi @ b[:-d] + b_hi], 0)
        d *= 2
    return A, b


def affine_scan(A: torch.Tensor, b: torch.Tensor, reverse: bool = False
                ) -> torch.Tensor:
    """Prefix-compose the affine recursion x_i = A_i @ x_{i-1} + b_i:
    A [N, 6, 6], b [N, 6, K] -> x [N, 6, K] (``reverse``: x_i = A_i @ x_{i+1}
    + b_i)."""
    return affine_scan_carry(A, b, reverse=reverse)[1]


def _solve(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Batched dense solve with no error check (nothing waits on the
    device)."""
    return torch.linalg.solve_ex(A, B)[0]


def solve_small_refined(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Small dense solve in the dtype of ``A`` through an f32 factorisation
    and one step of iterative refinement, as the reference computes it (for
    the near-identity blocks it serves, one step reaches ~f64 accuracy)."""
    A32 = A.to(torch.float32)
    X0 = _solve(A32, B.to(torch.float32)).to(A.dtype)
    R = B - A @ X0
    return X0 + _solve(A32, R.to(torch.float32)).to(A.dtype)


def chain_solve(Ad: torch.Tensor, Jr: torch.Tensor, info: torch.Tensor,
                rhs: torch.Tensor) -> torch.Tensor:
    """Solve (J^T diag(info) J) x = rhs for the block-bidiagonal chain J.

    Ad   [N, 6, 6]: subdiagonal couplings; Ad[0] must be zero (prior row).
    Jr   [N, 6, 6]: invertible per-row factor blocks (~ I).
    info [N, 6]:    per-row positive diagonal information.
    rhs  [N, 6, K].
    Runs in the dtype of its inputs (f64 through :func:`solve_small_refined`).
    """
    AdT = Ad.transpose(-1, -2)
    JrT = Jr.transpose(-1, -2)
    # y = B^{-T} rhs: y_i = rhs_i + Ad_{i+1}^T y_{i+1}
    M = torch.cat([AdT[1:], torch.zeros_like(AdT[:1])], 0)
    y = affine_scan(M, rhs, reverse=True)
    # diagonal part: Dg^{-1} Info^{-1} Dg^{-T}
    solve = _solve if Ad.dtype == torch.float32 else solve_small_refined
    u = solve(Jr, solve(JrT, y) / info[..., None])
    # x = B^{-1} u: x_i = u_i + Ad_i x_{i-1}
    return affine_scan(Ad, u, reverse=False)
