"""IMU integration buffer, the state part of ``alego_tpu.ops.deskew``.

The frame step keeps this buffer in its state so the state layout matches
the reference's; integration and de-skew themselves (``use_imu`` /
``use_odom``) are not ported yet.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class ImuBuffer(NamedTuple):
    """Fixed-capacity ring of integrated IMU samples (utility.h:70)."""

    times: torch.Tensor   # [Q]
    rpy: torch.Tensor     # [Q, 3]
    velo: torch.Tensor    # [Q, 3] world-frame velocity
    shift: torch.Tensor   # [Q, 3] world-frame position
    count: torch.Tensor   # int32 total samples ever appended


def init_buffer(capacity: int, device, dtype=torch.float32) -> ImuBuffer:
    # empty slots pad with +inf-like times so the array stays ascending
    def z(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)
    return ImuBuffer(
        times=torch.full((capacity,), 1e18, dtype=dtype, device=device),
        rpy=z(capacity, 3), velo=z(capacity, 3), shift=z(capacity, 3),
        count=torch.zeros((), dtype=torch.int32, device=device),
    )
