# Frozen copy of alego_tpu_torch/ops/eig3.py for the benchmark's reference: plain
# PyTorch only, its imports made local; see portbench/reference/__init__.py.
"""Closed-form batched 3x3 symmetric eigen-analysis, neighbour fits, the
Kabsch rotation and the SPD 3x3 solve, the port of ``alego_tpu.ops.eig3``.

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


def _unit_or(v: torch.Tensor, fallback: torch.Tensor):
    """Normalise v; where |v|^2 <= 1e-12 use ``fallback`` (already
    unit): degenerate eigenspaces leave some directions unobservable, and
    any orthonormal completion is optimal there."""
    n2 = torch.sum(v * v, -1, keepdim=True)
    safe = v / torch.sqrt(torch.clamp(n2, min=EPS))
    return torch.where(n2 > 1e-12, safe, fallback)


def _perp(v: torch.Tensor) -> torch.Tensor:
    """A deterministic unit vector orthogonal to unit v."""
    I = _eye(v)
    e = torch.where(torch.abs(v[..., :1]) < 0.9, I[0].expand(v.shape), I[1].expand(v.shape))
    w = torch.linalg.cross(v, e, dim=-1)
    return w / torch.sqrt(torch.clamp(torch.sum(w * w, -1, keepdim=True), min=EPS))


def rotation_from_covariance(S: torch.Tensor) -> torch.Tensor:
    """Kabsch rotation from a 3x3 cross-covariance: the R maximising
    ``tr(R S)`` over SO(3), in closed form (no SVD).

    With S = U diag(s) V^T, Kabsch gives R = V D U^T.  V = eigvecs(S^T S)
    and U's columns are S v_i / s_i; both bases are built right-handed
    (third column by a cross product), so the reflection case resolves by
    itself: R = sum_i v_i u_i^T.  Every degenerate case has a paired
    fallback (u_i from v_i), so S = 0 gives the identity.  S is scaled to
    unit Frobenius norm first: ICP covariances reach ~1e6, where the
    Cayley-Hamilton products would overflow f32."""
    fro = torch.sqrt(torch.clamp(torch.sum(S * S, dim=(-2, -1), keepdim=True), min=1e-35))
    Sn = S / fro
    M = Sn.transpose(-1, -2) @ Sn
    ev = sym_eigvals_3x3(M)                     # ascending [l0, l1, l2], <= 1
    I = _eye(S)
    e0 = I[0].expand(S.shape[:-2] + (3,))

    # v2 by Cayley-Hamilton; where l2 ~ l1 the product vanishes: fall back to
    # the top eigenplane (best column of M - l0 I), then to e0 (isotropy).
    # v0 has the strong signal exactly when the top plane is degenerate, so
    # the middle vector is v1 = v2 x v0.
    M0 = M - ev[..., 0, None, None] * I
    plane = _unit_or(_best_column(M0), e0)
    M1 = M - ev[..., 1, None, None] * I
    v2 = _unit_or(_best_column(M0 @ M1), plane)
    v0raw = _best_column(M1 @ (M - ev[..., 2, None, None] * I))
    v0raw = v0raw - torch.sum(v0raw * v2, -1, keepdim=True) * v2
    v0 = _unit_or(v0raw, _perp(v2))
    v1 = torch.linalg.cross(v2, v0, dim=-1)     # right-handed [v0, v1, v2]

    # u-basis fallbacks pair with the v-basis (u_i -> v_i): S ~ 0 (no ICP
    # correspondence in range) must give the identity, not a fixed rotation
    u2 = _unit_or((Sn @ v2[..., None])[..., 0], v2)
    u1raw = (Sn @ v1[..., None])[..., 0]
    u1raw = u1raw - torch.sum(u1raw * u2, -1, keepdim=True) * u2
    v1p = v1 - torch.sum(v1 * u2, -1, keepdim=True) * u2
    u1 = _unit_or(u1raw, _unit_or(v1p, _perp(u2)))
    u0 = torch.linalg.cross(u1, u2, dim=-1)
    return (v2[..., :, None] * u2[..., None, :]
            + v1[..., :, None] * u1[..., None, :]
            + v0[..., :, None] * u0[..., None, :])
