"""Full-sequence distributed single-map SLAM, the port of
``alego_tpu.parallel.distributed``: one map, one pose graph, D ranks.

* the front half (projection, de-skew, features, odometry) runs replicated
  on every rank: single-frame sequential work with no map state;
* the scan-to-map 5-NN association runs on the row-sharded local map
  (``parallel/map_shard``);
* loop closure's pose-graph solves run on the distributed Schur solver
  (``parallel/schur``);
* every host branch (the loop attempt's gate, the compaction check) is
  read on rank 0 and broadcast (``Comm.read``), so the ranks enter the same
  collectives; the mapping step and the loop attempt past its gate read
  nothing on the host.

:class:`DistributedSlamPipeline` is ``SlamPipeline`` with those three hooks,
so the frame's math and the host cadences are the single-device ones in the
same order: mapping on every ``map_frame_decimation``'th frame, the loop
attempt every ``loop_every_n_frames`` frames (inside the step with
``loop_in_step=True``, which is the reference's distributed cadence;
hoisted after the frame with ``loop_in_step=False``, as ``SlamPipeline``
runs it), and ``compact_keyframes`` near capacity every 16 frames.

Unlike ``SlamPipeline`` on the card, the step runs eagerly (no CUDA
graphs), and so does its loop attempt: its association and solve are
collectives, and the attempt's gate is a broadcast.  It writes into the
same static state.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..config import PipelineConfig
from ..device import resolve_device
from ..models.pipeline import SlamPipeline
from .comm import Comm
from .sharded_mapping import make_sharded_assoc, make_schur_graph_optimizer


class DistributedSlamPipeline(SlamPipeline):
    """One SLAM instance whose map association and pose-graph solves are
    distributed over the ranks of ``comm`` (one instance per rank, all fed
    the same scans; ``parallel.launch`` starts the ranks and checks that an
    NCCL group has a card per rank).  The API is ``SlamPipeline``'s.
    Outside a process group ``comm`` is a group of one.  The frame step
    runs eagerly on every device (its hooks are collectives)."""

    _graphed = False

    def __init__(self, cfg: PipelineConfig, comm: Optional[Comm] = None, device=None,
                 dtype=torch.float32):
        if comm is None:
            comm = Comm(resolve_device(device))
        self.comm = comm
        self._assoc = make_sharded_assoc(cfg, comm)
        if cfg.loop_closure_enabled:
            self._graph_optimizer = make_schur_graph_optimizer(cfg, comm)
        self._read = comm.read
        super().__init__(cfg, device=comm.device if device is None else device, dtype=dtype)
