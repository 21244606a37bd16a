"""SO(3)/SE(3) utilities (batched), the part of ``alego_tpu.ops.se3`` that
the frame step calls.

Conventions match the reference: rotations compose as
``Rz(yaw) @ Ry(pitch) @ Rx(roll)``, pose params are the Ceres block layout
``[tx, ty, tz, roll, pitch, yaw]``, and every function takes arbitrary
leading batch dimensions.
"""

from __future__ import annotations

import torch


def rpy_to_rot(rpy: torch.Tensor) -> torch.Tensor:
    """R = Rz(yaw) Ry(pitch) Rx(roll); rpy[..., 0:3] = roll, pitch, yaw."""
    r, p, y = rpy[..., 0], rpy[..., 1], rpy[..., 2]
    sr, cr = torch.sin(r), torch.cos(r)
    sp, cp = torch.sin(p), torch.cos(p)
    sy, cy = torch.sin(y), torch.cos(y)
    row0 = torch.stack([cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr], -1)
    row1 = torch.stack([sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr], -1)
    row2 = torch.stack([-sp, cp * sr, cp * cr], -1)
    return torch.stack([row0, row1, row2], -2)


def rot_to_rpy(R: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`rpy_to_rot` (ZYX decomposition, gimbal-safe clamp)."""
    sp = torch.clamp(-R[..., 2, 0], -1.0, 1.0)
    pitch = torch.asin(sp)
    roll = torch.atan2(R[..., 2, 1], R[..., 2, 2])
    yaw = torch.atan2(R[..., 1, 0], R[..., 0, 0])
    return torch.stack([roll, pitch, yaw], -1)


def yaw_to_rot(yaw: torch.Tensor) -> torch.Tensor:
    """Pure z-axis rotation; odometry integrates yaw only (LO.cpp:581)."""
    zeros = torch.zeros_like(yaw)
    return rpy_to_rot(torch.stack([zeros, zeros, yaw], -1))


def params_to_mat(params: torch.Tensor) -> torch.Tensor:
    """[..., 6] -> [..., 4, 4] homogeneous transform."""
    T = torch.zeros(params.shape[:-1] + (4, 4), dtype=params.dtype,
                    device=params.device)
    T[..., :3, :3] = rpy_to_rot(params[..., 3:6])
    T[..., :3, 3] = params[..., :3]
    T[..., 3, 3] = 1.0
    return T


def mat_to_params(T: torch.Tensor) -> torch.Tensor:
    return torch.cat([T[..., :3, 3], rot_to_rpy(T[..., :3, :3])], -1)


def transform_points(params: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply pose params [..., 6] to points [..., N, 3]: R p + t."""
    R = rpy_to_rot(params[..., 3:6])
    return pts @ R.transpose(-1, -2) + params[..., None, :3]


def inv_mat(T: torch.Tensor) -> torch.Tensor:
    Rt = T[..., :3, :3].transpose(-1, -2)
    out = torch.zeros_like(T)
    out[..., :3, :3] = Rt
    out[..., :3, 3] = -torch.einsum("...ij,...j->...i", Rt, T[..., :3, 3])
    out[..., 3, 3] = 1.0
    return out


def drotp_drpy(rpy: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """d(R(rpy) p)/d(rpy): [..., 3(xyz), 3(d/droll, d/dpitch, d/dyaw)].

    The exact partials of Rz(y)Ry(p)Rx(r) p, including the reference's own
    correction of the dy/dpitch z-term (see alego_tpu.ops.se3)."""
    r, pt, y = rpy[..., 0], rpy[..., 1], rpy[..., 2]
    sr, cr = torch.sin(r), torch.cos(r)
    sp, cp = torch.sin(pt), torch.cos(pt)
    sy, cy = torch.sin(y), torch.cos(y)
    px, py, pz = p[..., 0], p[..., 1], p[..., 2]

    dx_dr = (cy * sp * cr + sr * sy) * py + (sy * cr - cy * sr * sp) * pz
    dy_dr = (-cy * sr + sy * sp * cr) * py + (-sr * sy * sp - cy * cr) * pz
    dz_dr = cp * cr * py - cp * sr * pz

    dx_dp = -cy * sp * px + cy * cp * sr * py + cy * cr * cp * pz
    dy_dp = -sp * sy * px + sy * cp * sr * py + sy * cp * cr * pz
    dz_dp = -cp * px - sp * sr * py - sp * cr * pz

    dx_dy = -sy * cp * px - (sy * sp * sr + cr * cy) * py + (cy * sr - sy * cr * sp) * pz
    dy_dy = cp * cy * px + (-sy * cr + cy * sp * sr) * py + (cy * cr * sp + sy * sr) * pz
    dz_dy = torch.zeros_like(dx_dy)

    col_r = torch.stack([dx_dr, dy_dr, dz_dr], -1)
    col_p = torch.stack([dx_dp, dy_dp, dz_dp], -1)
    col_y = torch.stack([dx_dy, dy_dy, dz_dy], -1)
    return torch.stack([col_r, col_p, col_y], -1)
