"""Masked 6-DoF Gauss-Newton with Huber IRLS, the port of
``alego_tpu.ops.gauss_newton``.

The reference's ``lax.while_loop`` (stop after ``iters`` or once the step
falls to ``param_tol``) becomes a fixed ``iters``-long loop whose update is
a masked no-op once the step has fallen below the tolerance: the same result
with no host synchronisation.  ``torch.linalg.solve_ex`` replaces ``solve``,
which would synchronise to raise on a singular system; ``gn_step`` already
zeroes non-finite updates.
"""

from __future__ import annotations

from typing import Callable

import torch


def huber_weight(r: torch.Tensor, delta: float) -> torch.Tensor:
    a = torch.abs(r)
    return torch.where(a <= delta, 1.0, delta / torch.clamp(a, min=1e-12))


def _drop_nonfinite(r, J, w):
    row_ok = torch.isfinite(r) & torch.all(torch.isfinite(J), dim=-1)
    return (torch.where(row_ok, r, 0.0), torch.where(row_ok[:, None], J, 0.0),
            w * row_ok.to(w.dtype))


def gn_step(params, r, J, weight, dim_mask, huber_delta: float,
            damping: float = 1e-6, min_count: int = 0) -> torch.Tensor:
    """One masked GN update; weight is per-residual validity (0 = padding).
    Non-finite rows are dropped; masked dims are frozen by an identity
    block in H and a zero gradient."""
    r, J, weight = _drop_nonfinite(r, J, weight)
    w = weight * huber_weight(r, huber_delta)
    Jw = J * w[:, None]
    H = J.T @ Jw
    g = Jw.T @ r

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


def degeneracy_projector(H: torch.Tensor, eig_floor: float) -> torch.Tensor:
    """LOAM-style degeneracy guard P = V diag(lam > floor) V^T; a non-finite
    H gives P = 0 (keep the warm start)."""
    finite = torch.all(torch.isfinite(H))
    eye = torch.eye(H.shape[0], dtype=H.dtype, device=H.device)
    lam, V = torch.linalg.eigh(torch.where(finite, H, eye))
    keep = (lam > eig_floor).to(H.dtype) * finite.to(H.dtype)
    return (V * keep[None, :]) @ V.T


def solve_gn(residual_fn: Callable[[torch.Tensor], tuple],
             params0: torch.Tensor, iters: int, dim_mask: torch.Tensor,
             huber_delta: float, damping: float = 1e-6,
             min_count: int = 0, param_tol: float = 1e-4,
             eig_floor: float = 0.0, prior_weight: float = 0.0,
             max_step: float = 1.0) -> torch.Tensor:
    """GN with at most ``iters`` iterations and Ceres-style early stop.

    ``eig_floor > 0`` projects every update through the degeneracy
    projector built once, before the loop, from the warm-start
    linearisation (upstream LeGO-LOAM's iterCount == 0 test).
    ``prior_weight > 0`` adds a Tikhonov prior toward ``params0`` on the
    masked dims.  Each step is capped at ``max_step`` (the bounding role of
    Ceres's trust region)."""
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
        H0 = J.T @ (J * hw[:, None])
        H0 = H0 * (m[:, None] * m[None, :]) + torch.diag(1.0 - m)
        P = degeneracy_projector(H0, eig_floor)
    mc = min_count + (6 if prior_weight > 0.0 else 0)

    p = params0
    live = torch.ones((), dtype=torch.bool, device=dev)
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
        live = live & (step > param_tol)
    return p


# Dim masks for the reference's two-step scan-to-scan split
SURF_DIMS = (0, 0, 1, 0, 0, 0)      # z only (utility.h:224-232)
CORNER_DIMS = (1, 1, 0, 0, 0, 1)    # x, y, yaw (utility.h:162-167)
STEP_B_DIMS = (1, 1, 1, 0, 0, 1)    # union: joint second solve
FULL_DIMS = (1, 1, 1, 1, 1, 1)      # scan-to-map 6-DoF


def dims(mask: tuple, like: torch.Tensor) -> torch.Tensor:
    """A dim mask as a bool tensor on ``like``'s device, written by fills
    (``torch.tensor(..., device=cuda)`` would copy from the host and wait)."""
    out = torch.zeros(len(mask), dtype=torch.bool, device=like.device)
    for i, on in enumerate(mask):
        if on:
            out[i] = True
    return out
