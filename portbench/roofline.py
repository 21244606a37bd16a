"""The kernels' work and the card's peaks: the least time each launch of
the program's four CUDA kernels could take, from the shapes it was launched
with.

The peaks are NVIDIA's published figures for one H100 SXM at its 700 W
limit: 3.35 TB/s of HBM bandwidth, 67 TFLOP/s of float32 outside the tensor
cores.  A launch's bound is the larger of its bytes over the bandwidth and
its operations over the float32 rate.  Bytes count each input read once and
each output written once.  Operations:

- ``ccl`` (the range image's components): none counted, bound by bytes;
- ``nn1`` / ``knn``: 9 per query and ref pair (three differences, three
  squares, two sums, one compare), at the launch's padded shapes: the
  kernels compute every pair, invalid refs with a penalty;
- ``gn`` (a whole Gauss-Newton solve): 206 per row for one iteration, the
  least a solve runs (the iterations run are not read on the host), with
  60 bytes a row.

A replayed CUDA graph runs no Python, so the launches are recorded where
they are captured: :class:`Launches` wraps the program's four kernel
wrappers and ``torch.cuda.CUDAGraph``'s capture and replay, keeps each
graph's launches, and counts each graph's replays while ``counting``.
"""

from __future__ import annotations

import collections

PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12
GN_OPS_PER_ROW = 206
GN_BYTES_PER_ROW = 60
NN_OPS_PER_PAIR = 9


def bound_s(nbytes: float, nops: float) -> float:
    return max(nbytes / PEAK_BYTES_PER_S, nops / PEAK_F32_OPS_PER_S)


def ccl_work(conn_right, conn_up):
    R, H = conn_right.shape
    return R * H + (R - 1) * H + 4 * R * H, 0


def nn_work(query, ref, k):
    Q, N = query.shape[0], ref.shape[0]
    return 13 * Q + 13 * N + 8 * Q * k, NN_OPS_PER_PAIR * Q * N


def gn_work(n_rows):
    return GN_BYTES_PER_ROW * n_rows + 64, GN_OPS_PER_ROW * n_rows


class Launches:
    """Records each CUDA graph's kernel launches at capture and counts
    replays; ``bound_s()`` is the summed bound of the launches replayed
    while counting."""

    def __init__(self):
        self.per_graph = collections.defaultdict(list)   # id(graph) -> [(kernel, s)]
        self.replays = collections.Counter()
        self.counting = False
        self._open = None

    def install(self):
        import torch
        from alego_tpu_torch.ops import ccl, gauss_newton, nn

        rec = self

        def wrap(mod, name, kernel, work):
            fn = getattr(mod, name)

            def recorded(*args, **kwargs):
                if rec._open is not None:
                    rec.per_graph[rec._open].append((kernel, bound_s(*work(*args, **kwargs))))
                return fn(*args, **kwargs)
            setattr(mod, name, recorded)

        wrap(ccl, "ccl_cuda", "ccl", lambda cr, cu: ccl_work(cr, cu))
        wrap(nn, "nn1_cuda", "nn1", lambda q, qm, r, rm: nn_work(q, r, 1))
        wrap(nn, "knn_cuda", "knn", lambda q, qm, r, rm, k: nn_work(q, r, k))
        wrap(gauss_newton, "solve_correspondences_cuda", "gn",
             lambda corr, *a, **kw: gn_work(corr.cp.shape[0]))

        G = torch.cuda.CUDAGraph
        begin, end, replay = G.capture_begin, G.capture_end, G.replay

        def capture_begin(graph, *a, **kw):
            rec._open = id(graph)
            return begin(graph, *a, **kw)

        def capture_end(graph, *a, **kw):
            rec._open = None
            return end(graph, *a, **kw)

        def counted_replay(graph, *a, **kw):
            if rec.counting:
                rec.replays[id(graph)] += 1
            return replay(graph, *a, **kw)

        G.capture_begin, G.capture_end, G.replay = capture_begin, capture_end, counted_replay

    def bound_s(self) -> dict:
        """{kernel: summed bound (s)} over the replays counted."""
        out = collections.Counter()
        for g, n in self.replays.items():
            for kernel, s in self.per_graph.get(g, ()):
                out[kernel] += n * s
        return dict(out)
