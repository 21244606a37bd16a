"""Batched LiDAR residuals + analytic Jacobians, the port of
``alego_tpu.ops.residuals``.

Parameter layout is the Ceres block ``[tx, ty, tz, roll, pitch, yaw]``; the
transformed point is ``lp = Rz(yaw) Ry(pitch) Rx(roll) cp + t``.  Each
family returns ``(r [N], J [N, 6])`` for the whole correspondence set.
"""

from __future__ import annotations

import torch

from .se3 import rpy_to_rot, drotp_drpy

EPS = 1e-9


def _transform(params: torch.Tensor, cp: torch.Tensor):
    """lp = R cp + t and d(lp)/d(params) [N, 3, 6]."""
    R = rpy_to_rot(params[3:6])
    lp = cp @ R.T + params[:3]
    J_rot = drotp_drpy(params[3:6], cp)
    J_t = torch.eye(3, dtype=cp.dtype, device=cp.device).expand(J_rot.shape)
    return lp, torch.cat([J_t, J_rot], dim=-1)


def point_to_line(params, cp, pj, pl):
    """|(lp-pj) x (lp-pl)| / |pj-pl| and its Jacobian (utility.h:126-174)."""
    lp, dlp = _transform(params, cp)
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


def point_to_plane_3pt(params, cp, pj, pl, pm):
    """Scan-to-scan surf residual |n.(lp-pj)|/|n| from 3 plane points."""
    lp, dlp = _transform(params, cp)
    n = torch.linalg.cross(pj - pl, pj - pm)
    n_norm = torch.sqrt(torch.sum(n * n, -1) + EPS)
    signed = torch.sum((lp - pj) * n, -1) / n_norm
    dr_dlp = torch.sign(signed)[..., None] * n / n_norm[..., None]
    J = torch.einsum("ni,nij->nj", dr_dlp, dlp)
    return torch.abs(signed), J


def point_to_plane_fitted(params, cp, unit_n, d0):
    """Scan-to-map residual n.lp + d against a fitted unit-normal plane."""
    lp, dlp = _transform(params, cp)
    r = torch.sum(unit_n * lp, -1) + d0
    J = torch.einsum("ni,nij->nj", unit_n, dlp)
    return r, J
