#!/usr/bin/env python3
"""What moved the port's held answers when the degeneracy projector's
eigendecomposition changed from ``torch.linalg.eigh`` to the fixed-sweep
Jacobi (``ops.gauss_newton.eigh6``), which a CUDA graph can capture.

Usage: ``python3 tools/projector_attribution.py`` from the root of the
repository, on a machine with a CUDA GPU.

Runs each of these ``chip_smoke.py`` paths three ways and prints their
answers as one JSON object: the main path's 32 frames (unaligned ATE,
keyframes), the 192-frame loop path (loop pairs, attempts, ATE of the
streamed and of the corrected keyframe poses) and the skewed circuit
through ``run_scanned`` without de-skew (its ATE and loops):

- ``eigh``: the projector as it was (``torch.linalg.eigh``, which checks
  its status on the host, so the step runs eagerly);
- ``jacobi``: the projector of the graphed step (``SlamPipeline``);
- ``jacobi_perturbed``: the Jacobi projector with N(0, 1e-7) added to
  every entry of P (a fixed seed on the card), eagerly: how far a change at
  the projector's rounding level moves each answer.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def eigh_projector(H, eig_floor: float):
    """The projector before the Jacobi: P = V diag(lam > floor) V^T from
    ``torch.linalg.eigh`` in H's dtype."""
    import torch
    finite = torch.all(torch.isfinite(H))
    eye = torch.eye(H.shape[0], dtype=H.dtype, device=H.device)
    lam, V = torch.linalg.eigh(torch.where(finite, H, eye))
    keep = (lam > eig_floor).to(H.dtype) * finite.to(H.dtype)
    return (V * keep[None, :]) @ V.T


def main():
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("projector_attribution: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    from alego_tpu_torch import PipelineConfig
    from alego_tpu_torch.models.pipeline import SlamPipeline
    from alego_tpu_torch.ops import gauss_newton as gn
    from alego_tpu_torch.utils.metrics import ate_rmse

    cfg = PipelineConfig().replace(loop_in_step=False)
    gt, pts, mask = cs.render(cfg, cs.N_CIRCUIT)
    gt_s, pts_s, mask_s, _ = cs.render_skewed(cfg, cs.N_CIRCUIT)
    gt_rel = np.einsum("ij,njk->nik", np.linalg.inv(gt_s[0]), gt_s)
    times = np.arange(cs.N_CIRCUIT, dtype=np.float32) * np.float32(cfg.scan_period)
    jacobi = gn.degeneracy_projector
    gen = torch.Generator(device="cuda")

    def perturbed(H, eig_floor):
        P = jacobi(H, eig_floor)
        return P + 1e-7 * torch.randn(P.shape, generator=gen, device=P.device, dtype=P.dtype)

    out = {}
    for way, proj, graphed in (("eigh", eigh_projector, False), ("jacobi", jacobi, True),
                               ("jacobi_perturbed", perturbed, False)):
        gn.degeneracy_projector = proj
        SlamPipeline._graphed = graphed
        gen.manual_seed(0)
        main_path = SlamPipeline(cfg, device="cuda")
        est = main_path.run(pts[:cs.N_FRAMES], mask[:cs.N_FRAMES])
        res = dict(main_ate_m=ate_rmse(est[:, :3, 3], gt[:cs.N_FRAMES, :3, 3], align=False),
                   main_keyframes=int(main_path.state.mapping.graph.count))
        loop = SlamPipeline(cfg, device="cuda")
        loop.run(pts, mask)
        lr = cs._loop_results(loop, gt)
        res.update({f"loop_{k}": lr[k] for k in ("ate_m", "kf_ate_m", "loop_pairs",
                                                 "attempts")})
        skew = SlamPipeline(cfg, device="cuda")
        est = np.concatenate([skew.run_scanned(pts_s[i:i + 16], mask_s[i:i + 16],
                                               times=times[i:i + 16])
                              for i in range(0, cs.N_CIRCUIT, 16)])
        res.update(no_deskew_ate_m=ate_rmse(est[:, :3, 3], gt_rel[:, :3, 3], align=False),
                   no_deskew_loops=int(skew.state.mapping.graph.loop_count))
        out[way] = res
        print(f"{way}: {json.dumps(res)}", flush=True)
    gn.degeneracy_projector = jacobi
    SlamPipeline._graphed = True
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(json.dumps(dict(device=smi, **out)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
