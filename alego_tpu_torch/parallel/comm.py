"""The process group of the port's multi-device programs: the counterpart
of the reference's ``Mesh`` (``alego_tpu/parallel/multichip.py:37``).

The reference runs ``parallel/`` as one program over a mesh through
``shard_map``.  The port is SPMD with one process per device: each shard
function becomes a per-rank function over a ``torch.distributed`` group, and
the reference's collectives become :class:`Comm`'s methods:

* ``lax.axis_index`` -> ``Comm.rank``;
* ``lax.all_gather`` -> :meth:`Comm.all_gather`;
* ``lax.psum`` -> :meth:`Comm.all_reduce_sum`: an all-gather summed in rank
  order, so every rank holds the same bits (a ring reduction promises no
  order);
* ``lax.ppermute``'s one-row halos -> :meth:`Comm.halos`: an all-gather of
  each rank's edge rows (O(D) rows);
* and one the reference does not need, since one controller reads every
  host branch there: :meth:`Comm.read`, a device flag decided on rank 0 and
  broadcast.  Every host branch the ranks must take alike goes through it,
  so a rank whose copy differs by an ulp cannot enter a collective the
  others skip.

Transport follows the device and is never switched silently: NCCL for CUDA
tensors (one rank per card), gloo for CPU tensors, and gloo with CUDA
tensors only when the caller names ``backend="gloo"`` for a CUDA run: each
collective then copies its (small) operands to host memory and back
("staged"), which lets several ranks share one card.

Outside a process group a ``Comm`` is a group of one: every collective is
the identity and :meth:`read` is ``bool``.
"""

from __future__ import annotations

import time

import torch
import torch.distributed as dist


class Comm:
    """This rank's view of the default process group: its rank, the world
    size, its device, the collectives, and what they cost (seconds, calls,
    the largest all-gather's bytes)."""

    def __init__(self, device=None):
        live = dist.is_available() and dist.is_initialized()
        self.rank = dist.get_rank() if live else 0
        self.size = dist.get_world_size() if live else 1
        self.backend = dist.get_backend() if live else None
        self.device = torch.device("cpu" if device is None else device)
        self.reset()

    def reset(self):
        """Set the cost counters to 0."""
        self._seconds = 0.0
        self._events = []
        self.calls = 0
        self.max_gather_bytes = 0

    @property
    def staged(self) -> bool:
        """Collectives of CUDA tensors go through host memory (gloo)."""
        return self.backend == "gloo" and self.device.type == "cuda"

    @property
    def seconds(self) -> float:
        """Seconds spent in collectives.  On the card each collective is
        timed by two CUDA events recorded on the stream around it, so the
        collectives add no synchronise of their own: the stream's time from
        the work queued before it to its result, the wait for the slowest
        rank and a staged copy's host round trip included.  Reading this
        waits for the last event."""
        if self._events:
            self._events[-1][1].synchronize()
            self._seconds += sum(a.elapsed_time(b) for a, b in self._events) / 1e3
            self._events.clear()
        return self._seconds

    def _start(self):
        if self.device.type == "cuda":
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    def _stop(self, t0):
        if self.device.type == "cuda":
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self._events.append((t0, ev))
        else:
            self._seconds += time.perf_counter() - t0
        self.calls += 1

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """[D, *t.shape]: every rank's ``t`` in rank order."""
        if self.size == 1:
            return t[None]
        t0 = self._start()
        x = t.contiguous()
        as_bool = x.dtype == torch.bool
        if as_bool:                      # gloo has no bool collectives
            x = x.to(torch.uint8)
        if self.staged:
            x = x.cpu()
        parts = [torch.empty_like(x) for _ in range(self.size)]
        dist.all_gather(parts, x)
        out = torch.stack(parts)
        self.max_gather_bytes = max(self.max_gather_bytes,
                                    out.numel() * out.element_size())
        out = out.to(t.device)
        if as_bool:
            out = out.bool()
        self._stop(t0)
        return out

    def all_reduce_sum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of every rank's ``t``, added in rank order."""
        if self.size == 1:
            return t
        return self.all_gather(t).sum(0)

    def halos(self, first: torch.Tensor, last: torch.Tensor):
        """(previous rank's ``last``, next rank's ``first``), wrapping around
        at the edges as ``ppermute``'s cyclic shifts do; the caller masks
        the edge ranks' wrapped values."""
        both = self.all_gather(torch.stack([first, last]))
        return both[(self.rank - 1) % self.size, 1], both[(self.rank + 1) % self.size, 0]

    def read(self, flag) -> bool:
        """Rank 0's value of the device bool ``flag``, on every rank (one
        host read, and one broadcast when the group has more than one
        rank)."""
        if self.size == 1:
            return bool(flag)
        t0 = self._start()
        x = torch.as_tensor(flag, device=self.device).to(torch.int32).reshape(1)
        if self.staged:
            x = x.cpu()
        dist.broadcast(x, src=0)
        out = bool(x.item())
        self._stop(t0)
        return out
