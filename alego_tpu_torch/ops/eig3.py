"""Closed-form batched 3x3 symmetric eigen-analysis and neighbour fits,
the port of ``alego_tpu.ops.eig3`` that mapping calls.

The closed forms are kept (trigonometric eigenvalues, Cayley-Hamilton
eigenvectors, the centred total-least-squares plane) so the port tracks the
reference fit for fit; ``torch.linalg.eigh`` would pick other eigenvector
signs and round differently.
"""

from __future__ import annotations

import math

import torch

EPS = 1e-12


def det_3x3(A: torch.Tensor) -> torch.Tensor:
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    return a * (e * i - f * h) - b * (d * i - f * g) + c * (d * h - e * g)


def _eye(like: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=like.dtype, device=like.device)


def sym_eigvals_3x3(C: torch.Tensor) -> torch.Tensor:
    """Eigenvalues of symmetric [..., 3, 3], ascending [l0 <= l1 <= l2]."""
    q = torch.diagonal(C, dim1=-2, dim2=-1).sum(-1) / 3.0
    B = C - q[..., None, None] * _eye(C)
    p2 = torch.sum(B * B, dim=(-2, -1)) / 6.0
    p = torch.sqrt(torch.clamp(p2, min=EPS))
    detB = det_3x3(B)
    r = detB / torch.clamp(2 * p ** 3, min=EPS)
    r = torch.clamp(r, -1.0, 1.0)
    phi = torch.acos(r) / 3.0
    l2 = q + 2 * p * torch.cos(phi)
    l0 = q + 2 * p * torch.cos(phi + 2 * math.pi / 3)
    l1 = 3 * q - l0 - l2
    return torch.stack([l0, l1, l2], -1)


def _best_column(A: torch.Tensor) -> torch.Tensor:
    """Column of [..., 3, 3] with the largest squared norm (first on ties)."""
    norms = torch.sum(A * A, dim=-2)
    best = torch.argmax(norms, dim=-1)
    idx = best[..., None, None].expand(A.shape[:-1] + (1,))
    return torch.gather(A, -1, idx)[..., 0]


def principal_direction(C: torch.Tensor, eigvals: torch.Tensor) -> torch.Tensor:
    """Unit eigenvector of the largest eigenvalue of symmetric [..., 3, 3]:
    by Cayley-Hamilton (C - l0 I)(C - l1 I) has columns along it."""
    I = _eye(C)
    A = (C - eigvals[..., 0, None, None] * I) @ (C - eigvals[..., 1, None, None] * I)
    v = _best_column(A)
    return v / torch.sqrt(torch.clamp(torch.sum(v * v, -1, keepdim=True), min=EPS))


def pca_line_fit(neighbors: torch.Tensor, valid: torch.Tensor):
    """Line test on K-NN sets (LM.cpp:523-552): (center, direction, eigvals)."""
    w = valid[..., None].to(neighbors.dtype)
    cnt = torch.clamp(torch.sum(w, -2), min=1.0)
    center = torch.sum(neighbors * w, -2) / cnt
    d = (neighbors - center[..., None, :]) * w
    C = torch.einsum("...ki,...kj->...ij", d, d)
    ev = sym_eigvals_3x3(C)
    return center, principal_direction(C, ev), ev


def plane_fit(neighbors: torch.Tensor, valid: torch.Tensor, tol: float):
    """Centred total-least-squares plane: (unit_n, d0, plane_ok) with the
    residual ``unit_n . p + d0``; plane_ok needs every valid neighbour within
    ``tol`` of the plane (LM.cpp:582-597)."""
    w = valid[..., None].to(neighbors.dtype)
    cnt = torch.clamp(torch.sum(w, -2), min=1.0)
    center = torch.sum(neighbors * w, -2) / cnt
    q = (neighbors - center[..., None, :]) * w
    C = torch.einsum("...ki,...kj->...ij", q, q)
    ev = sym_eigvals_3x3(C)
    I = _eye(C)
    A0 = (C - ev[..., 1, None, None] * I) @ (C - ev[..., 2, None, None] * I)
    v = _best_column(A0)
    n2 = torch.sum(v * v, -1, keepdim=True)
    ez = I[2].expand(v.shape)
    unit_n = torch.where(n2 > 1e-20, v / torch.sqrt(torch.clamp(n2, min=EPS)), ez)
    d0 = -torch.sum(unit_n * center, -1)
    dist = torch.abs(torch.einsum("...ki,...i->...k", neighbors, unit_n) + d0[..., None])
    plane_ok = torch.all(torch.where(valid, dist <= tol, True), -1)
    return unit_n, d0, plane_ok
