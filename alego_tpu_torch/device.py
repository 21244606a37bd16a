"""Device selection for the port's entry points.

Entry points run on the GPU unless the caller asks for another device
explicitly (``device="cpu"``, as the tests do).  Without a GPU they raise
rather than carry on silently on the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means ``cuda``; a CUDA device without a GPU raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port on the CPU")
    return dev


def const(value, like: torch.Tensor) -> torch.Tensor:
    """A 0-dim tensor of ``like``'s dtype and device.

    Dividing by a Python float lets CUDA rewrite ``a / s`` as
    ``a * (1 / s)``, which rounds differently; dividing by a device tensor
    keeps the IEEE quotient the reference computes before every ``floor``
    that bins points (rings, columns, voxels)."""
    return torch.full((), value, dtype=like.dtype, device=like.device)


def at(a: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """``a[i]`` for a 0-dim index tensor on ``a``'s device, without reading
    the index on the host (indexing with a tensor scalar may)."""
    return a.index_select(0, i.long().reshape(1))[0]


def vector(values, dtype, device) -> torch.Tensor:
    """A 1-D tensor of Python numbers on ``device``, written by fills: a
    copy from the host would wait for the device's queue (and so would
    ``out[i] = v``, which copies a host scalar into a 0-dim view)."""
    out = torch.empty(len(values), dtype=dtype, device=device)
    for i, v in enumerate(values):
        out[i].fill_(float(v))
    return out
