"""The distributed pose-graph solve, the port of ``alego_tpu.parallel.schur``:
block substructuring of the FACTORED chain system over the group.

The production solve (``models/pose_graph.optimize``) never forms the
Hessian: the chain + prior normal matrix is ``J^T Info J`` with ``J``
block-bidiagonal, inverted by two triangular solves.  This module
distributes exactly that algorithm.  Eliminating each rank's block interior
from the triangular factor is the Schur reduction of a bidiagonal system,
and it is subtraction-free, hence f32-stable:

* each rank assembles only ITS ``nb = N / D`` rows of (Ad, Jr, info, b, Vs)
  from its pose and chain rows; the one-row block halos (pose ``lo - 1``,
  pose and chain row ``lo + nb``) come from the neighbours' edge rows;
* each triangular solve is a local affine scan over the block, an
  all-gather of the D block-boundary carries ([6, 6 + K] per rank,
  independent of N), the replicated D-step carry recursion and a local
  correction;
* the L loop factors fold in through the matrix inversion lemma: the
  6L x 6L core is one all-reduce, solved replicated.

Per-rank memory O((N/D) K) with K = 1 + 6L; traffic per GN iteration: the
halo rows, 2 carry gathers, one [6L, 6L + 1] all-reduce and the gather of
the [N, 6] step, no term but the last scaling with N.  The arithmetic is a
regrouping of the single-device factored solve in f32 (the reference's
solver has no f64 refinement): it agrees with the port's ``optimize`` to f32
rounding.
"""

from __future__ import annotations

import torch

from ..device import vector
from ..models import pose_graph as pg
from ..ops import se3
from ..ops.chain_solver import affine_scan_carry
from .comm import Comm


def per_device_bytes(N: int, n_dev: int, Lf: int) -> int:
    """Per-rank assembly + solve footprint (f32 bytes): the sharded rhs and
    solution buffers and the replicated Woodbury core."""
    nb = N // n_dev
    K = 1 + 6 * Lf
    buffers = 3 * nb * 6 * K             # rhs + scan image + corrected
    core = (6 * Lf) ** 2 + 2 * 6 * Lf    # Woodbury core + Vty
    carries = 4 * n_dev * 6 * (K + 6)    # boundary exchanges
    return 4 * (buffers + core + carries)


def _solve(A, B):
    return torch.linalg.solve_ex(A, B)[0]


def make_schur_solver(comm: Comm, N: int, Lf: int, chain_sigma, iters: int = 3,
                      max_step: float = pg.MAX_STEP):
    """fn(PoseGraph) -> PoseGraph, the GN solve distributed over ``comm``'s
    group.  The graph is the same on every rank (each reads its own rows);
    ``N`` is its capacity and must divide by the group size, ``Lf`` its
    loop-factor capacity."""
    D, rank = comm.size, comm.rank
    if N % D:
        raise ValueError(f"graph capacity {N} must divide by the group size {D}")
    nb = N // D
    lo = rank * nb

    def carry_chain(packed, reverse: bool):
        """The incoming boundary value of this rank's block from the
        gathered per-block composed maps ``packed`` [D, 6, 6 + K']
        (A | y), folded over the blocks before it (after it, ``reverse``)."""
        A0, y0 = packed[..., :6], packed[..., 6:]
        val = torch.zeros_like(y0[0])
        order = range(D - 1, -1, -1) if reverse else range(D)
        stop = D - 1 - rank if reverse else rank
        for n, d in enumerate(order):
            if n == stop:
                return val
            val = y0[d] + A0[d] @ val
        return val

    def gn_delta(poses_blk, rel_blk, r_l, Ji_l, Jj_l, li, lj, w_l, r_p, count):
        """This rank's rows of the GN step from its pose and chain rows."""
        dtype, dev = poses_blk.dtype, poses_blk.device
        sigma = vector(chain_sigma, dtype, dev)
        info_c = 1.0 / sigma
        I6 = torch.eye(6, dtype=dtype, device=dev)
        rows = lo + torch.arange(nb, device=dev)

        # the halos: pose lo-1 from the previous rank, pose and chain row
        # lo+nb from the next; the edge ranks' wrapped values are garbage,
        # and every consumer below masks them (kf > 0, kf < count, lo+nb < N)
        edge_first = torch.stack([poses_blk[0], rel_blk[0]])
        edge_last = torch.stack([poses_blk[-1], rel_blk[-1]])
        prev, nxt = comm.halos(edge_first, edge_last)
        posesW = torch.cat([prev[0][None], poses_blk, nxt[0][None]], 0)   # lo-1 .. lo+nb
        relW = torch.cat([rel_blk, nxt[1][None]], 0)                      # lo .. lo+nb

        # ---- factors lo .. lo+nb ----
        r_f, Jr_f, Ad_f = pg._between_parts(posesW[:-1], posesW[1:], relW)
        kf = lo + torch.arange(nb + 1, device=dev)
        fmask = (kf > 0) & (kf < count)

        # ---- rows lo .. lo+nb-1 ----
        row_chain = fmask[:nb] & (rows > 0)
        Ad = Ad_f[:nb] * row_chain.to(dtype)[:, None, None]
        Jr = torch.where(row_chain[:, None, None], Jr_f[:nb], I6)
        is0 = rows == 0
        w_p = (count > 0).to(dtype)
        ones = torch.ones(6, dtype=dtype, device=dev)
        info0 = torch.where(count > 0, info_c, ones)
        info = torch.where(row_chain[:, None], info_c[None, :], ones[None, :])
        info = torch.where(is0[:, None], info0[None, :], info)

        # ---- gradient rows: b[k] = Jj(f_k)^T W r_k + Ji(f_{k+1})^T W r_{k+1}
        Ji_f = -Jr_f @ Ad_f
        wf = fmask.to(dtype)[:, None]
        gj = torch.einsum("nki,nk->ni", Jr_f * info_c[None, :, None], r_f) * wf
        gi = torch.einsum("nki,nk->ni", Ji_f * info_c[None, :, None], r_f) * wf
        b = gj[:nb] + gi[1:]
        b = b + torch.where(is0[:, None], (info_c * w_p * r_p)[None, :], 0.0)

        # loop gradient + sqrt-weighted columns: endpoints in this block
        sw = torch.sqrt(w_l)
        li_loc, lj_loc = li.long() - lo, lj.long() - lo
        in_i = (li_loc >= 0) & (li_loc < nb)
        in_j = (lj_loc >= 0) & (lj_loc < nb)
        li_c, lj_c = li_loc.clamp(0, nb - 1), lj_loc.clamp(0, nb - 1)
        gli = torch.einsum("lki,lk->li", Ji_l, r_l) * w_l[:, None]
        glj = torch.einsum("lki,lk->li", Jj_l, r_l) * w_l[:, None]
        b = b.index_add(0, li_c, gli * in_i[:, None]).index_add(0, lj_c, glj * in_j[:, None])

        lf = torch.arange(Lf, device=dev)
        V = torch.zeros((nb, Lf, 6, 6), dtype=dtype, device=dev)
        V.index_put_((li_c, lf), Ji_l.transpose(1, 2) * (sw * in_i)[:, None, None],
                     accumulate=True)
        V.index_put_((lj_c, lf), Jj_l.transpose(1, 2) * (sw * in_j)[:, None, None],
                     accumulate=True)
        Vs = V.permute(0, 2, 1, 3).reshape(nb, 6, Lf * 6)
        rhs = torch.cat([-b[:, :, None], Vs], 2)                       # [nb, 6, K]

        # ---- the distributed factored solve of T x = rhs ----
        AdT = Ad.transpose(-1, -2)
        JrT = Jr.transpose(-1, -2)
        # (1) y = B^{-T} rhs: y_m = rhs_m + Ad_{m+1}^T y_{m+1}; the block's
        #     last row needs the NEXT block's first Ad, factor lo+nb
        Ad_next = Ad_f[nb] * (fmask[nb] & (lo + nb < N)).to(dtype)
        M = torch.cat([AdT[1:], Ad_next.T[None]], 0)
        A_sfx, y_loc = affine_scan_carry(M, rhs, reverse=True)
        inc = carry_chain(comm.all_gather(torch.cat([A_sfx[0], y_loc[0]], 1)), reverse=True)
        y = y_loc + A_sfx @ inc
        # (2) diagonal: u = Jr^{-1} (Jr^{-T} y / info)
        u = _solve(Jr, _solve(JrT, y) / info[..., None])
        # (3) x = B^{-1} u: x_m = u_m + Ad_m x_{m-1}
        A_pfx, x_loc = affine_scan_carry(Ad, u, reverse=False)
        inc2 = carry_chain(comm.all_gather(torch.cat([A_pfx[-1], x_loc[-1]], 1)),
                           reverse=False)
        x = x_loc + A_pfx @ inc2

        # ---- the Woodbury loop fold-in: ONE all-reduce, independent of N ----
        y_b, Z = x[:, :, 0], x[:, :, 1:]
        core_loc = torch.einsum("nik,nil->kl", Vs, Z)
        vty_loc = torch.einsum("nik,ni->k", Vs, y_b)
        packed = comm.all_reduce_sum(torch.cat([core_loc, vty_loc[:, None]], 1))
        core = torch.eye(Lf * 6, dtype=dtype, device=dev) + packed[:, :-1]
        return y_b - Z @ _solve(core, packed[:, -1])

    def gn_iter(g: pg.PoseGraph) -> pg.PoseGraph:
        dev = g.poses.device
        active = torch.arange(N, device=dev) < g.count
        # loop parts (replicated, O(Lf))
        li, lj = g.loop_i.long(), g.loop_j.long()
        r_l, Jr_l, Ad_l = pg._between_parts(g.poses[li], g.poses[lj], g.loop_rel)
        lmask = torch.arange(Lf, device=dev) < g.loop_count
        w_l = torch.where(lmask, g.loop_w, 0.0)
        Ji_l = -Jr_l @ Ad_l
        r_p = se3.se3_log(se3.inv_mat(g.chain_rel[0]) @ g.poses[0])
        d_blk = gn_delta(g.poses[lo:lo + nb], g.chain_rel[lo:lo + nb], r_l, Ji_l, Jr_l,
                         li, lj, w_l, r_p, g.count)
        delta = comm.all_gather(d_blk).reshape(N, 6)
        step = torch.clamp(torch.max(torch.abs(delta)), min=1e-12)
        delta = delta * torch.clamp(torch.full_like(step, max_step) / step, max=1.0)
        upd = g.poses @ se3.se3_exp(delta)
        return g._replace(poses=torch.where(active[:, None, None], upd, g.poses))

    def solve(g: pg.PoseGraph) -> pg.PoseGraph:
        for _ in range(iters):
            g = gn_iter(g)
        return g

    return solve
