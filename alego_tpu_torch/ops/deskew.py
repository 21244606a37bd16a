"""IMU integration and scan de-skew, the port of ``alego_tpu.ops.deskew``
(the reference's ``imuHandler``/``adjustDistortion``, LO.cpp:636-881).

The buffer is a fixed-capacity ring of integrated samples; integration is a
pure update of it, and de-skew interpolates orientation and shift for every
point at once (``searchsorted`` + gather).  Nothing here reads the device on
the host: the ring index, the ``dt`` gate, the ring's start and the
fewer-than-2-samples no-op are all device ``where``s.  Every division that
feeds a rounding or a clip divides by a device tensor (``device.const``).
Enabled with ``cfg.use_imu`` or ``cfg.use_odom``.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..device import at, const
from .se3 import rpy_to_rot

GRAVITY = 9.81


class ImuBuffer(NamedTuple):
    """Fixed-capacity ring of integrated IMU samples (utility.h:70, the
    reference's ring arrays LO.cpp:842-845); slot ``count % Q`` is the
    write position."""

    times: torch.Tensor   # [Q]
    rpy: torch.Tensor     # [Q, 3]
    velo: torch.Tensor    # [Q, 3] world-frame velocity
    shift: torch.Tensor   # [Q, 3] world-frame position
    count: torch.Tensor   # int32 total samples ever appended


def init_buffer(capacity: int, device, dtype=torch.float32) -> ImuBuffer:
    # empty slots pad with +inf-like times so the array stays ascending for
    # the searchsorted interpolation in _interp
    def z(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)
    return ImuBuffer(
        times=torch.full((capacity,), 1e18, dtype=dtype, device=device),
        rpy=z(capacity, 3), velo=z(capacity, 3), shift=z(capacity, 3),
        count=torch.zeros((), dtype=torch.int32, device=device),
    )


def _mod(x: torch.Tensor, m: float) -> torch.Tensor:
    """``jnp.mod`` for floats: the truncated remainder moved to the sign of
    the (positive) divisor, exact like the reference's (``torch.remainder``
    rounds ``x - m * floor(x / m)`` instead)."""
    r = torch.fmod(x, m)
    return torch.where((r != 0) & (r < 0), r + m, r)


def _set(a: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``a.at[k].set(v)`` for a 0-dim device index."""
    return a.index_copy(0, k.reshape(1), v.reshape((1,) + a.shape[1:]).to(a.dtype))


def integrate_imu(buf: ImuBuffer, t, rpy, lin_acc) -> ImuBuffer:
    """Append one sample: gravity-compensate in body frame (LO.cpp:847-849),
    rotate to world, integrate velocity and shift (LO.cpp:869-880).
    ``t`` is a 0-dim tensor, ``rpy`` and ``lin_acc`` [3] tensors."""
    r, p = rpy[0], rpy[1]
    acc = torch.stack([
        lin_acc[0] + GRAVITY * torch.sin(p),
        lin_acc[1] - GRAVITY * torch.cos(p) * torch.sin(r),
        lin_acc[2] - GRAVITY * torch.cos(p) * torch.cos(r),
    ])
    acc_w = rpy_to_rot(rpy) @ acc

    Q = buf.times.shape[0]
    k = torch.remainder(buf.count, Q).long()
    prev = torch.remainder(buf.count - 1, Q).long()
    dt = t - at(buf.times, prev)
    ok = (buf.count > 0) & (dt < 1.0) & (dt > 0)
    velo_p, shift_p = at(buf.velo, prev), at(buf.shift, prev)
    velo = torch.where(ok, velo_p + acc_w * dt, 0.0)
    shift = torch.where(ok, shift_p + velo_p * dt + 0.5 * acc_w * dt * dt, 0.0)
    return ImuBuffer(
        times=_set(buf.times, k, t),
        rpy=_set(buf.rpy, k, rpy),
        velo=_set(buf.velo, k, velo),
        shift=_set(buf.shift, k, shift),
        count=buf.count + 1,
    )


def integrate_imu_chunk(buf: ImuBuffer, ts, rpys, accs, n: int) -> ImuBuffer:
    """Append the first ``n`` samples of ts [C], rpys [C, 3], accs [C, 3]
    (device tensors) in order.  The integration is sequential (velocity and
    shift accumulate); the reference runs it as one on-device loop with a
    masked tail, here it is a host loop over the ``n`` real samples only,
    ~30 small ops each (~8 samples per scan at 40 Hz)."""
    for i in range(n):
        buf = integrate_imu(buf, ts[i], rpys[i], accs[i])
    return buf


def integrate_odom(buf: ImuBuffer, t, rpy, pos, velo) -> ImuBuffer:
    """Append an external-odometry sample (the ``use_odom`` input path,
    LO.cpp:737-795): pose and velocity come from the message instead of
    being integrated from accelerations."""
    k = torch.remainder(buf.count, buf.times.shape[0]).long()
    return ImuBuffer(
        times=_set(buf.times, k, t),
        rpy=_set(buf.rpy, k, rpy),
        velo=_set(buf.velo, k, velo),
        shift=_set(buf.shift, k, pos),
        count=buf.count + 1,
    )


def _interp(buf: ImuBuffer, t: torch.Tensor):
    """Linear interpolation of rpy/shift/velo at times t [N].

    The ring is unrotated into ascending-time order first (one [Q] gather):
    before the first wrap the oldest slot is 0 and empty slots pad with 1e18
    so the order is the identity; after a wrap the oldest slot is
    ``count % Q``.  Angles blend along the shortest arc across ±π."""
    Q = buf.times.shape[0]
    start = torch.where(buf.count > Q, torch.remainder(buf.count, Q), 0)
    idx = torch.remainder(start + torch.arange(Q, dtype=torch.int32,
                                               device=t.device), Q).long()
    times = buf.times[idx]
    hi = torch.clamp(torch.searchsorted(times, t.contiguous()), 1, Q - 1)
    lo = hi - 1
    t0, t1 = times[lo], times[hi]
    a = torch.clamp((t - t0) / torch.clamp(t1 - t0, min=1e-9), 0.0, 1.0)[:, None]
    rpy_o, shift_o, velo_o = buf.rpy[idx], buf.shift[idx], buf.velo[idx]
    d = rpy_o[hi] - rpy_o[lo]
    d = _mod(d + math.pi, 2 * math.pi) - math.pi
    rpy = rpy_o[lo] + a * d
    shift = shift_o[lo] * (1 - a) + shift_o[hi] * a
    velo = velo_o[lo] * (1 - a) + velo_o[hi] * a
    return rpy, shift, velo


def deskew(points, cols, valid, scan_time, buf: ImuBuffer, cfg,
           orient_start=None, orient_diff=None):
    """Rotate every return into the sweep-start frame (LO.cpp:663-733).

    points [..., 3], cols [...] column index, valid mask, scan_time a 0-dim
    tensor.  Firing time: with ``orient_start``/``orient_diff`` (the
    cloud_info orientation fields, IP.cpp:120-130) each point's time is its
    integer column rank from the sweep's start column over the measured
    span; otherwise the uniform ``col / H * scan_period``.  Points pass
    through bit for bit when the buffer holds fewer than 2 samples, and
    invalid points always do.
    """
    shape = points.shape[:-1]
    pts = points.reshape(-1, 3)
    H = cfg.horizon_scan
    if orient_start is not None and orient_diff is not None:
        res = const(cfg.ang_res_x, pts)
        c0 = torch.round(orient_start / res - 0.5).to(torch.int32)
        rel_cols = torch.remainder(cols.reshape(-1) - c0, H).to(pts.dtype)
        rel = rel_cols * res
        rel_t = rel / torch.clamp(orient_diff, min=1e-3) * cfg.scan_period
        rel_t = torch.clamp(rel_t, 0.0, cfg.scan_period)
    else:
        rel_t = (cols.reshape(-1).to(pts.dtype) / const(H, pts)
                 * cfg.scan_period)
    t_abs = scan_time + rel_t

    rpy_c, shift_c, _ = _interp(buf, t_abs)
    # the sweep start, interpolated once (the reference interpolates it for
    # every point, each to the same value)
    rpy_s, shift_s, velo_s = _interp(buf, scan_time.reshape(1).to(pts.dtype))
    R_c = rpy_to_rot(rpy_c)
    R_s = rpy_to_rot(rpy_s)[0]

    shift_from_start = shift_c - shift_s - velo_s * rel_t[:, None]
    moved = torch.einsum("nij,nj->ni", R_c, pts) + shift_from_start
    out = moved @ R_s          # R_start^T applied to each row

    ok = (buf.count >= 2) & valid.reshape(-1)
    out = torch.where(ok[:, None], out, pts)
    return out.reshape(*shape, 3)
