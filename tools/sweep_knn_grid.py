#!/usr/bin/env python3
"""Bare launch time of the k-NN kernel (``csrc/nn.cu``) against the size of
its grid.

Usage: ``python3 tools/sweep_knn_grid.py [--blocks-per-sm 2 4 8 16 32] [--k 5]``
from the root of the repository, on a machine with a CUDA GPU.

At the two mapping shapes (corner 1024x8192 with 245x1230 live, surf
3072x16384 with 2243x11992 live; front-compacted, 10% of the live refs
masked, points uniform in a 80 m cube from seed 13, as in
``tests/test_torch_kernels_gpu.py``), for each k and each target of blocks
per SM: the chunk that ``knn_chunk`` picks for it, the output held
bit-equal to ``knn_plain``, and the time of the bare C launch as
``chip_smoke._median_ms`` takes it (CUDA events around back-to-back calls).
Prints one JSON object with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = {"corner": (1024, 8192, 245, 1230), "surf": (3072, 16384, 2243, 11992)}


def _inputs(Q, N, q_live, r_live, dev):
    import torch
    rng = np.random.default_rng(13)
    q = rng.uniform(-40, 40, (Q, 3)).astype(np.float32)
    r = rng.uniform(-40, 40, (N, 3)).astype(np.float32)
    qm, rm = np.arange(Q) < q_live, np.arange(N) < r_live
    rm[rng.integers(0, r_live, r_live // 10)] = False
    return tuple(torch.from_numpy(a).to(dev) for a in (q, qm, r, rm))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--blocks-per-sm", type=int, nargs="+", default=[2, 4, 8, 16, 32])
    ap.add_argument("--k", type=int, nargs="+", default=[5])
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("sweep_knn_grid: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from alego_tpu_torch.ops import nn
    from chip_smoke import _median_ms

    dev = torch.device("cuda")
    sms = nn._sm_count(dev)
    stream = torch.cuda.current_stream().cuda_stream
    launch = nn._launcher()
    default = nn.KNN_BLOCKS_PER_SM
    rows = []
    for label, shape in SHAPES.items():
        q, qm, r, rm = _inputs(*shape, dev)
        Q, N = q.shape[0], r.shape[0]
        for k in args.k:
            d_p, i_p = nn.knn_plain(q, qm, r, rm, k)
            d, i = torch.empty_like(d_p), torch.empty_like(i_p)
            for bps in args.blocks_per_sm:
                nn.KNN_BLOCKS_PER_SM = bps
                chunk = nn.knn_chunk(Q, N, k, sms)
                nn.KNN_BLOCKS_PER_SM = default
                chunks = -(-N // chunk)
                part = torch.empty((chunks, k, Q), dtype=torch.int64, device=dev)
                ptrs = (q.data_ptr(), qm.data_ptr(), r.data_ptr(), rm.data_ptr(), Q, N,
                        k, chunk, part.data_ptr(), d.data_ptr(), i.data_ptr(), stream)
                nn.kernels.check(launch(*ptrs), "knn kernel")
                torch.cuda.synchronize()
                assert torch.equal(d, d_p) and torch.equal(i, i_p), (label, k, bps)
                ms = _median_ms(lambda: launch(*ptrs))
                rows.append(dict(shape=label, k=k, blocks_per_sm=bps, chunk=chunk,
                                 chunks=chunks, bare_ms=ms))
                print(f"{label} {Q}x{N}, k={k}: {bps} blocks/SM -> {chunks} chunks "
                      f"of {chunk}, bare launch {ms:.4f} ms", flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(json.dumps({"device": smi, "default_blocks_per_sm": default, "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
