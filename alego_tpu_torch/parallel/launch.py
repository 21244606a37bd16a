"""Run one SPMD function on several ranks, one process each.

``launch(fn, world_size, *args)`` starts ``world_size`` processes with the
``spawn`` start method, joins them into one ``torch.distributed`` group
through a ``FileStore`` in a temporary directory (no network), calls
``fn(comm, *args)`` on every rank with that rank's :class:`~.comm.Comm`, and
returns rank 0's result.  ``fn`` must be importable (a module-level function
of this package): a child imports it by name and imports nothing else.

Failures never hang the caller: a rank that raises makes ``launch`` stop the
others and raise with that rank's traceback, a collective that waits longer
than ``COLLECTIVE_TIMEOUT_S`` raises in its rank, and a group still running
after ``timeout`` seconds is killed and ``launch`` raises ``TimeoutError``.

Backends: ``nccl`` (CUDA, one card per rank; fewer cards than ranks
raises), ``gloo`` on the CPU, and ``gloo`` with ``device="cuda"``: the
ranks share the card(s) and each collective is staged through host memory
(the run prints that it is).  On the card the kernels are built once here,
before the ranks start, so that they do not race on the build directory.
"""

from __future__ import annotations

import datetime
import os
import pickle
import tempfile
import time
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from .comm import Comm


# a collective waiting longer than this raises in its rank
COLLECTIVE_TIMEOUT_S = 120.0


def _rank_main(rank, world_size, backend, device, cards, tmp, fn, args):
    try:
        # one intra-op thread per rank: the ranks share the host's cores
        torch.set_num_threads(1)
        if device == "cuda":
            dev = torch.device("cuda", rank % cards)
            torch.cuda.set_device(dev)
        else:
            dev = torch.device(device)
        store = dist.FileStore(os.path.join(tmp, "store"), world_size)
        dist.init_process_group(
            backend, store=store, rank=rank, world_size=world_size,
            timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))
        out = fn(Comm(dev), *args)
        dist.destroy_process_group()
        if rank == 0:
            with open(os.path.join(tmp, "result.tmp"), "wb") as f:
                pickle.dump(out, f)
            os.replace(os.path.join(tmp, "result.tmp"), os.path.join(tmp, "result.pkl"))
    except BaseException:
        # record the traceback before anything else can fail (the peers
        # lose this rank as soon as it stops), then leave at once
        with open(os.path.join(tmp, f"error_{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        os._exit(1)


def launch(fn, world_size: int, *args, backend: str | None = None, device: str = "cuda",
           cards: int | None = None, timeout: float = 600.0):
    """``fn(comm, *args)`` on ``world_size`` ranks; returns rank 0's result.
    The ranks run on the card(s) unless ``device="cpu"``; ``backend``
    defaults to ``nccl`` on the card and ``gloo`` on the CPU.  On the card
    rank r takes card r % ``cards`` of the first ``cards`` visible ones (all
    of them by default): ``cards=1`` puts every gloo rank on card 0."""
    backend = backend or ("nccl" if device == "cuda" else "gloo")
    if device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass device='cpu' to run "
                               "the ranks on the CPU")
        visible = torch.cuda.device_count()
        cards = visible if cards is None else cards
        if backend == "nccl" and min(cards, visible) < world_size:
            raise ValueError(
                f"{world_size} ranks over NCCL need {world_size} cards, but only "
                f"{min(cards, visible)} are visible or asked for; NCCL refuses two ranks "
                "on one card (backend='gloo' stages the collectives through host memory)")
        if not 1 <= cards <= visible:
            raise ValueError(f"cards={cards}, but {visible} cards are visible")
        from .. import kernels
        kernels.build()
        if backend == "gloo":
            print(f"launch: {world_size} ranks on {min(cards, world_size)} card(s), "
                  "transport gloo, collectives staged through host memory (CUDA compute)",
                  flush=True)
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="alego_ranks_") as tmp:
        procs = [ctx.Process(target=_rank_main,
                             args=(r, world_size, backend, device, cards, tmp, fn, args))
                 for r in range(world_size)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        try:
            while True:
                codes = [p.exitcode for p in procs]
                failed = [r for r, c in enumerate(codes) if c not in (None, 0)]
                if failed:
                    first = _first_failure(tmp, failed)
                    raise RuntimeError(f"rank {first} of {world_size} failed "
                                       f"(exit code {codes[first]}):\n" + _error(tmp, first))
                if all(c == 0 for c in codes):
                    break
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{world_size} ranks still running after {timeout} s "
                                       f"(exit codes {codes}); stopped")
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
            for p in procs:
                p.join()
        with open(os.path.join(tmp, "result.pkl"), "rb") as f:
            return pickle.load(f)


def _first_failure(tmp, failed):
    """The rank that failed first (its traceback was written first): the
    others may only have lost their peer."""
    def written(r):
        path = os.path.join(tmp, f"error_{r}.txt")
        return os.path.getmtime(path) if os.path.exists(path) else float("inf")
    return min(failed, key=lambda r: (written(r), r))


def _error(tmp, rank):
    path = os.path.join(tmp, f"error_{rank}.txt")
    if not os.path.exists(path):
        return "(no traceback: the process died)"
    with open(path) as f:
        return f.read()
