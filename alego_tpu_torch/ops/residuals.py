"""Batched LiDAR residuals + analytic Jacobians, the port of
``alego_tpu.ops.residuals``.

Parameter layout is the Ceres block ``[tx, ty, tz, roll, pitch, yaw]``; the
transformed point is ``lp = Rz(yaw) Ry(pitch) Rx(roll) cp + t``.  Each
family returns ``(r [N], J [N, 6])`` for the whole correspondence set.
:class:`Correspondences` tags each row with its family, so that one GN
solve takes a batch of mixed rows (``gauss_newton.solve_correspondences``,
whose CUDA kernel evaluates the same formulas row by row).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .se3 import rpy_to_rot, drotp_drpy

EPS = 1e-9

# row kinds of a Correspondences batch
LINE, PLANE_3PT, PLANE_FITTED = 0, 1, 2


def _transform(params: torch.Tensor, cp: torch.Tensor):
    """lp = R cp + t and d(lp)/d(params) [N, 3, 6]."""
    R = rpy_to_rot(params[3:6])
    lp = cp @ R.T + params[:3]
    J_rot = drotp_drpy(params[3:6], cp)
    J_t = torch.eye(3, dtype=cp.dtype, device=cp.device).expand(J_rot.shape)
    return lp, torch.cat([J_t, J_rot], dim=-1)


def _line(lp, dlp, pj, pl):
    u = lp - pj
    v = lp - pl
    w = pj - pl
    k = torch.sqrt(torch.sum(w * w, -1) + EPS)
    c = torch.linalg.cross(u, v)
    m = torch.sqrt(torch.sum(c * c, -1) + EPS)
    r = m / k
    dm_dlp = torch.linalg.cross(w, c) / m[..., None]
    J = torch.einsum("ni,nij->nj", dm_dlp, dlp) / k[..., None]
    return r, J


def _plane_3pt(lp, dlp, pj, pl, pm):
    n = torch.linalg.cross(pj - pl, pj - pm)
    n_norm = torch.sqrt(torch.sum(n * n, -1) + EPS)
    signed = torch.sum((lp - pj) * n, -1) / n_norm
    dr_dlp = torch.sign(signed)[..., None] * n / n_norm[..., None]
    J = torch.einsum("ni,nij->nj", dr_dlp, dlp)
    return torch.abs(signed), J


def _plane_fitted(lp, dlp, unit_n, d0):
    r = torch.sum(unit_n * lp, -1) + d0
    J = torch.einsum("ni,nij->nj", unit_n, dlp)
    return r, J


def point_to_line(params, cp, pj, pl):
    """|(lp-pj) x (lp-pl)| / |pj-pl| and its Jacobian (utility.h:126-174)."""
    return _line(*_transform(params, cp), pj, pl)


def point_to_plane_3pt(params, cp, pj, pl, pm):
    """Scan-to-scan surf residual |n.(lp-pj)|/|n| from 3 plane points."""
    return _plane_3pt(*_transform(params, cp), pj, pl, pm)


def point_to_plane_fitted(params, cp, unit_n, d0):
    """Scan-to-map residual n.lp + d against a fitted unit-normal plane."""
    return _plane_fitted(*_transform(params, cp), unit_n, d0)


class Correspondences(NamedTuple):
    """A batch of residual rows for one GN solve.

    kind 0 = line (pj, pl used), kind 1 = plane-3pt (pj, pl, pm),
    kind 2 = fitted plane (pj = unit normal, scalar = d0).
    """

    cp: torch.Tensor      # [N, 3] current-frame point
    pj: torch.Tensor      # [N, 3]
    pl: torch.Tensor      # [N, 3]
    pm: torch.Tensor      # [N, 3]
    scalar: torch.Tensor  # [N]
    kind: torch.Tensor    # [N] int32
    weight: torch.Tensor  # [N] float (0 = padding)


def correspondence_rows(kind: int, cp, weight, pj=None, pl=None, pm=None,
                        scalar=None) -> Correspondences:
    """Rows of one kind; the fields that kind does not read are zeros."""
    z3 = torch.zeros_like(cp)
    return Correspondences(
        cp, z3 if pj is None else pj, z3 if pl is None else pl,
        z3 if pm is None else pm,
        torch.zeros_like(weight) if scalar is None else scalar,
        torch.full(weight.shape, kind, dtype=torch.int32, device=weight.device),
        weight)


def join_correspondences(*parts: Correspondences) -> Correspondences:
    """The rows of ``parts`` in order, each field one contiguous tensor."""
    return Correspondences(*(torch.cat(f).contiguous() for f in zip(*parts)))


def eval_correspondences(params: torch.Tensor, corr: Correspondences):
    """Evaluate all residual families branch-free and select by kind.  The
    transform is evaluated once for the three (the reference evaluates it
    per family: the same operations on the same inputs)."""
    lp, dlp = _transform(params, corr.cp)
    r0, J0 = _line(lp, dlp, corr.pj, corr.pl)
    r1, J1 = _plane_3pt(lp, dlp, corr.pj, corr.pl, corr.pm)
    r2, J2 = _plane_fitted(lp, dlp, corr.pj, corr.scalar)
    k = corr.kind[:, None]
    r = torch.where(corr.kind == 0, r0, torch.where(corr.kind == 1, r1, r2))
    J = torch.where(k == 0, J0, torch.where(k == 1, J1, J2))
    return r, J
