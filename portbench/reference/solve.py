"""The reference's Gauss-Newton solve over a batch of correspondence rows
(the program's ``gn`` kernel solves the same problem on the card).

Straightforward: each iteration evaluates the rows on the device (the frozen
residuals), sums H = J^T W J and g = J^T W r in float64, and does the 6x6
algebra on the host in NumPy float64: the masked dims frozen, damping, the
degeneracy projector from the warm start's H (``eig_floor``), the step cap,
and the stop once the step falls to ``param_tol``.  Rows with a non-finite
residual or Jacobian are dropped; Huber weights as the program's."""

from __future__ import annotations

import numpy as np
import torch

from .residuals import Correspondences, eval_correspondences

SURF_DIMS = (0, 0, 1, 0, 0, 0)
CORNER_DIMS = (1, 1, 0, 0, 0, 1)
STEP_B_DIMS = (1, 1, 1, 0, 0, 1)
FULL_DIMS = (1, 1, 1, 1, 1, 1)


def dims(mask: tuple, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(mask, dtype=torch.bool, device=like.device)


def _sums(p: np.ndarray, corr: Correspondences, kind_cols, huber_delta: float, dtype):
    """H [6, 6], g [6] and the number of live rows at params ``p``."""
    pt = torch.tensor(p, dtype=dtype, device=corr.cp.device)
    r, J = eval_correspondences(pt, corr)
    if kind_cols is not None:
        J = J * kind_cols[corr.kind.long()]
    ok = torch.isfinite(r) & torch.all(torch.isfinite(J), dim=-1)
    r = torch.where(ok, r, 0.0).double()
    J = torch.where(ok[:, None], J, 0.0).double()
    w = corr.weight.double() * ok
    a = torch.abs(r)
    hw = w * torch.where(a <= huber_delta, 1.0, huber_delta / torch.clamp(a, min=1e-12))
    Jw = J * hw[:, None]
    out = torch.cat([(J.T @ Jw).reshape(-1), Jw.T @ r, torch.sum(w > 0).reshape(1).double()])
    out = out.cpu().numpy()
    return out[:36].reshape(6, 6), out[36:42], out[42]


def solve_correspondences(corr: Correspondences, params0, iters: int, dim_mask,
                          huber_delta: float, *, kind_cols=None, damping: float = 1e-6,
                          min_count: int = 0, param_tol: float = 1e-4,
                          eig_floor: float = 0.0, prior_weight: float = 0.0,
                          max_step: float = 1.0):
    """GN with at most ``iters`` iterations; returns the params [6] in
    ``params0``'s dtype and device."""
    m = dim_mask.cpu().numpy().astype(np.float64)
    mm = np.outer(m, m)
    free = np.diag(1.0 - m)
    p0 = params0.detach().cpu().numpy().astype(np.float64)
    mc = min_count + (6 if prior_weight > 0.0 else 0)
    p, P = p0.copy(), np.eye(6)
    for it in range(iters):
        H, g, count = _sums(p, corr, kind_cols, huber_delta, params0.dtype)
        if prior_weight > 0.0:
            H = H + prior_weight * np.eye(6)
            g = g + prior_weight * (p - p0)
            count += 6
        if it == 0 and eig_floor > 0.0:
            H0 = H * mm + free
            if np.all(np.isfinite(H0)):
                lam, V = np.linalg.eigh(H0)
                P = (V * (lam > eig_floor)) @ V.T
            else:
                P = np.zeros((6, 6))
        A = H * mm + free + damping * np.eye(6)
        try:
            delta = -np.linalg.solve(A, g * m)
        except np.linalg.LinAlgError:
            delta = np.zeros(6)
        if not (count >= mc and np.all(np.isfinite(delta))):
            delta = np.zeros(6)
        d = P @ delta
        if max_step > 0.0:
            d = d * min(max_step / max(np.max(np.abs(d)), 1e-12), 1.0)
        p = p + d
        if np.max(np.abs(d)) <= param_tol:
            break
    return torch.tensor(p, dtype=params0.dtype, device=params0.device)
