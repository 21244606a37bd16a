"""SO(3)/SE(3) utilities (batched), the port of ``alego_tpu.ops.se3``.

Conventions match the reference: rotations compose as
``Rz(yaw) @ Ry(pitch) @ Rx(roll)``, pose params are the Ceres block layout
``[tx, ty, tz, roll, pitch, yaw]``, and every function takes arbitrary
leading batch dimensions.  The pose-graph solve uses the se(3) exponential
map with twists ordered ``[rho(3), phi(3)]``, in f32 or f64.
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


def rot_to_quat(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> unit quaternion [w, x, y, z], branch-free: four
    candidate constructions, the one with the largest pivot of
    ``[tr, m00, m11, m22]`` kept (the first on ties, as ``argmax`` gives)."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    def pivot(v):
        return torch.sqrt(torch.clamp(v, min=1e-12)) / 2

    qw0 = pivot(1.0 + tr)
    q0 = torch.stack([qw0, (m21 - m12) / (4 * qw0), (m02 - m20) / (4 * qw0),
                      (m10 - m01) / (4 * qw0)], -1)
    qx1 = pivot(1.0 + m00 - m11 - m22)
    q1 = torch.stack([(m21 - m12) / (4 * qx1), qx1, (m01 + m10) / (4 * qx1),
                      (m02 + m20) / (4 * qx1)], -1)
    qy2 = pivot(1.0 - m00 + m11 - m22)
    q2 = torch.stack([(m02 - m20) / (4 * qy2), (m01 + m10) / (4 * qy2), qy2,
                      (m12 + m21) / (4 * qy2)], -1)
    qz3 = pivot(1.0 - m00 - m11 + m22)
    q3 = torch.stack([(m10 - m01) / (4 * qz3), (m02 + m20) / (4 * qz3),
                      (m12 + m21) / (4 * qz3), qz3], -1)
    cands = torch.stack([q0, q1, q2, q3], -2)
    idx = torch.argmax(torch.stack([tr, m00, m11, m22], -1), -1)
    q = torch.gather(cands, -2, idx[..., None, None].expand(idx.shape + (1, 4)))[..., 0, :]
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


def quat_to_rot(q: torch.Tensor) -> torch.Tensor:
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    row0 = torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1)
    row1 = torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1)
    row2 = torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1)
    return torch.stack([row0, row1, row2], -2)


def params_to_mat(params: torch.Tensor) -> torch.Tensor:
    """[..., 6] -> [..., 4, 4] homogeneous transform."""
    T = torch.zeros(params.shape[:-1] + (4, 4), dtype=params.dtype,
                    device=params.device)
    T[..., :3, :3] = rpy_to_rot(params[..., 3:6])
    T[..., :3, 3] = params[..., :3]
    T[..., 3, 3].fill_(1.0)
    return T


def mat_to_params(T: torch.Tensor) -> torch.Tensor:
    return torch.cat([T[..., :3, 3], rot_to_rpy(T[..., :3, :3])], -1)


def transform_points(params: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply pose params [..., 6] to points [..., N, 3]: R p + t."""
    R = rpy_to_rot(params[..., 3:6])
    return pts @ R.transpose(-1, -2) + params[..., None, :3]


def compose_mats(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    return A @ B


def inv_mat(T: torch.Tensor) -> torch.Tensor:
    Rt = T[..., :3, :3].transpose(-1, -2)
    out = torch.zeros_like(T)
    out[..., :3, :3] = Rt
    out[..., :3, 3] = -torch.einsum("...ij,...j->...i", Rt, T[..., :3, 3])
    out[..., 3, 3].fill_(1.0)
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


# ---------------------------------------------------------------------------
# se(3) exponential / logarithm, twist = [rho(3), phi(3)] (loop closure:
# the pose-graph solve and the loop-correction smear)
# ---------------------------------------------------------------------------

def _eye3(like: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=like.dtype, device=like.device)


def hat(v: torch.Tensor) -> torch.Tensor:
    """[..., 3] -> [..., 3, 3] skew-symmetric."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    return torch.stack([
        torch.stack([zero, -z, y], -1),
        torch.stack([z, zero, -x], -1),
        torch.stack([-y, x, zero], -1),
    ], -2)


def so3_exp(phi: torch.Tensor) -> torch.Tensor:
    theta = torch.clamp(torch.linalg.vector_norm(phi, dim=-1, keepdim=True), min=1e-12)
    th = theta[..., None]
    K = hat(phi / theta)
    I = _eye3(phi)
    # 1 - cos t = 2 sin^2(t/2): stable in f32 for small t
    one_minus_cos = 2.0 * torch.sin(th / 2) ** 2
    R = I + torch.sin(th) * K + one_minus_cos * (K @ K)
    return torch.where(th < 1e-6, I + hat(phi), R)


def so3_log(R: torch.Tensor) -> torch.Tensor:
    tr = torch.diagonal(R, dim1=-2, dim2=-1).sum(-1)
    theta = torch.acos(torch.clamp((tr - 1) / 2, -1.0, 1.0))
    w = torch.stack([R[..., 2, 1] - R[..., 1, 2],
                     R[..., 0, 2] - R[..., 2, 0],
                     R[..., 1, 0] - R[..., 0, 1]], -1)
    th = theta[..., None]
    scale = torch.where(th < 1e-6, 0.5,
                        th / torch.clamp(2 * torch.sin(th), min=1e-12))
    return scale * w


def _so3_left_jacobian(phi: torch.Tensor) -> torch.Tensor:
    theta = torch.linalg.vector_norm(phi, dim=-1)
    th = torch.clamp(theta, min=1e-9)[..., None, None]
    K = hat(phi / torch.clamp(theta, min=1e-9)[..., None])
    I = _eye3(phi)
    one_minus_cos = 2.0 * torch.sin(th / 2) ** 2          # stable 1 - cos
    J = I + (one_minus_cos / th) * K + ((th - torch.sin(th)) / th) * (K @ K)
    # f32: (th - sin th) cancels catastrophically below ~1e-3
    return torch.where(theta[..., None, None] < 1e-3, I + 0.5 * hat(phi), J)


def se3_exp(xi: torch.Tensor) -> torch.Tensor:
    """[..., 6] twist [rho, phi] -> [..., 4, 4]."""
    rho, phi = xi[..., :3], xi[..., 3:]
    T = torch.zeros(xi.shape[:-1] + (4, 4), dtype=xi.dtype, device=xi.device)
    T[..., :3, :3] = so3_exp(phi)
    T[..., :3, 3] = torch.einsum("...ij,...j->...i", _so3_left_jacobian(phi), rho)
    T[..., 3, 3].fill_(1.0)
    return T


def se3_log(T: torch.Tensor) -> torch.Tensor:
    """[..., 4, 4] -> [..., 6] twist [rho, phi]."""
    phi = so3_log(T[..., :3, :3])
    # V^-1 in closed form, with f32-stable trig: 1 - cos = 2 sin^2(t/2)
    theta = torch.linalg.vector_norm(phi, dim=-1)
    K = hat(phi)
    I = _eye3(T)
    th = torch.clamp(theta, min=1e-9)[..., None, None]
    A = torch.sin(th) / th
    B = 2.0 * torch.sin(th / 2) ** 2 / (th * th)
    coef = (1 - A / (2 * torch.clamp(B, min=1e-12))) / (th * th)
    # series limit 1/12 as theta -> 0: A / 2B loses precision below ~1e-2 in f32
    coef = torch.where(th < 1e-2, 1.0 / 12.0, coef)
    Vinv = I - 0.5 * K + coef * (K @ K)
    rho = torch.einsum("...ij,...j->...i", Vinv, T[..., :3, 3])
    return torch.cat([rho, phi], -1)


def adjoint(T: torch.Tensor) -> torch.Tensor:
    """[..., 4, 4] -> [..., 6, 6] adjoint for twist order [rho, phi]."""
    R = T[..., :3, :3]
    Ad = torch.zeros(T.shape[:-2] + (6, 6), dtype=T.dtype, device=T.device)
    Ad[..., :3, :3] = R
    Ad[..., :3, 3:] = hat(T[..., :3, 3]) @ R
    Ad[..., 3:, 3:] = R
    return Ad
