"""SE(3) pose-graph optimisation (the GTSAM/iSAM2 replacement), the port of
``alego_tpu.models.pose_graph``.

The factor set is three fixed-shape arrays (prior, chain, loops); the
residual is the right-trivialised ``Log(Z^-1 Xi^-1 Xj)`` with the adjoint
Jacobians and ``Jr^-1 ~ I + ad(r)/2``.  :func:`optimize` is the production
solve: the chain + prior normal matrix is inverted in factored form
(``ops/chain_solver``) and the L loop factors fold in through the matrix
inversion lemma; the system is assembled in f64, solved in f32 and refined
once against an f64 residual.  :func:`optimize_dense` assembles the dense
system, the oracle the tests hold :func:`optimize` against (never called on
the main path: at N = 2048 its system is 1.2 GB).

At capacity a keyframe or loop factor is rejected and counted in
``overflow`` / ``loop_overflow``, never overwriting stored constraints.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..device import fixed_loop, vector
from ..ops import se3
from ..ops.chain_solver import chain_solve


class PoseGraph(NamedTuple):
    poses: torch.Tensor          # [N, 4, 4] current estimates (active: [:count])
    chain_rel: torch.Tensor      # [N, 4, 4] X_{i-1}^-1 X_i at insertion
    loop_i: torch.Tensor         # [L] loop factor endpoints
    loop_j: torch.Tensor
    loop_rel: torch.Tensor       # [L, 4, 4]
    loop_w: torch.Tensor         # [L] (0 = empty slot)
    count: torch.Tensor          # int32 active poses
    loop_count: torch.Tensor     # int32 active loop factors
    overflow: torch.Tensor       # int32 keyframes rejected at capacity
    loop_overflow: torch.Tensor  # int32 loop factors rejected at capacity


def init_graph(max_kf: int, max_loops: int, device,
               dtype=torch.float32) -> PoseGraph:
    eye = torch.eye(4, dtype=dtype, device=device)

    def i32():
        return torch.zeros((), dtype=torch.int32, device=device)

    return PoseGraph(
        poses=eye.repeat(max_kf, 1, 1), chain_rel=eye.repeat(max_kf, 1, 1),
        loop_i=torch.zeros(max_loops, dtype=torch.int32, device=device),
        loop_j=torch.zeros(max_loops, dtype=torch.int32, device=device),
        loop_rel=eye.repeat(max_loops, 1, 1),
        loop_w=torch.zeros(max_loops, dtype=dtype, device=device),
        count=i32(), loop_count=i32(), overflow=i32(), loop_overflow=i32(),
    )


def add_keyframe(g: PoseGraph, pose: torch.Tensor, do: torch.Tensor) -> PoseGraph:
    """Append a pose; the measured between is prev^-1 @ pose (LM.cpp:655-658).

    ``do`` (bool tensor): when False the call is a value-level no-op.  The
    row is written in place (``index_copy_``) with its old value where the
    save is off, so no buffer is copied and nothing waits on the device."""
    cap = g.poses.shape[0]
    at_cap = g.count >= cap
    write = do & ~at_cap
    k = torch.clamp(g.count, max=cap - 1).long().reshape(1)
    prev = g.poses[torch.clamp(k - 1, min=0)][0]
    rel = torch.where(k == 0, pose, se3.inv_mat(prev) @ pose)
    g.poses.index_copy_(0, k, torch.where(write, pose, g.poses[k][0])[None])
    g.chain_rel.index_copy_(0, k, torch.where(write, rel, g.chain_rel[k][0])[None])
    return g._replace(count=g.count + write.to(torch.int32),
                      overflow=g.overflow + (do & at_cap).to(torch.int32))


def add_loop_factor(g: PoseGraph, i, j, rel, weight) -> PoseGraph:
    """Append a loop factor.  At capacity the factor is rejected and counted
    in ``loop_overflow``: overwriting the newest slot would silently drop an
    accepted constraint."""
    cap = g.loop_w.shape[0]
    at_cap = g.loop_count >= cap
    l = torch.clamp(g.loop_count, max=cap - 1).long().reshape(1)

    def put(a, v):
        v = torch.as_tensor(v, device=a.device).to(a.dtype).reshape((1,) + a.shape[1:])
        return torch.where(at_cap, a, a.index_copy(0, l, v))

    return g._replace(
        loop_i=put(g.loop_i, i), loop_j=put(g.loop_j, j),
        loop_rel=put(g.loop_rel, rel), loop_w=put(g.loop_w, weight),
        loop_count=torch.where(at_cap, g.loop_count, g.loop_count + 1),
        loop_overflow=g.loop_overflow + at_cap.to(torch.int32))


def _between_parts(Xi, Xj, Z):
    """r = Log(Z^-1 Xi^-1 Xj) and the factor blocks: Jj = Jr_inv,
    Ji = -Jr_inv @ Ad with Ad = Adj(Xj^-1 Xi)."""
    r = se3.se3_log(se3.inv_mat(Z) @ se3.inv_mat(Xi) @ Xj)
    # Jr^{-1}(r) ~ I + 0.5 ad(r)
    ad = torch.zeros(r.shape[:-1] + (6, 6), dtype=r.dtype, device=r.device)
    rho, phi = r[..., :3], r[..., 3:]
    ad[..., :3, :3] = se3.hat(phi)
    ad[..., :3, 3:] = se3.hat(rho)
    ad[..., 3:, 3:] = se3.hat(phi)
    Jr_inv = torch.eye(6, dtype=r.dtype, device=r.device) + 0.5 * ad
    return r, Jr_inv, se3.adjoint(se3.inv_mat(Xj) @ Xi)


def _between_residual(Xi, Xj, Z):
    """r and the (Ji, Jj) Jacobians w.r.t. right perturbations of i, j."""
    r, Jr_inv, Ad = _between_parts(Xi, Xj, Z)
    return r, -Jr_inv @ Ad, Jr_inv


def _loop_weights(g: PoseGraph):
    l_act = torch.arange(g.loop_w.shape[0], device=g.loop_w.device) < g.loop_count
    return torch.where(l_act, g.loop_w, 0.0)


def _assemble_and_solve(g: PoseGraph, chain_sigma):
    """One GN iteration: dense H delta = -b over 6N dofs (the oracle)."""
    N = g.poses.shape[0]
    dtype, dev = g.poses.dtype, g.poses.device
    idx = torch.arange(N, device=dev)
    active = idx < g.count
    prev = torch.clamp(idx - 1, min=0)

    r_c, Ji_c, Jj_c = _between_residual(g.poses[prev], g.poses, g.chain_rel)
    w_c = (active & (idx > 0)).to(dtype)
    info_c = 1.0 / vector(chain_sigma, dtype, dev)
    r_p = se3.se3_log(se3.inv_mat(g.chain_rel[0]) @ g.poses[0])
    w_p = (g.count > 0).to(dtype)
    li, lj = g.loop_i.long(), g.loop_j.long()
    r_l, Ji_l, Jj_l = _between_residual(g.poses[li], g.poses[lj], g.loop_rel)
    w_l = _loop_weights(g)

    H = torch.zeros((N, N, 6, 6), dtype=dtype, device=dev)
    b = torch.zeros((N, 6), dtype=dtype, device=dev)

    def add_factor(i, j, r, Ji, Jj, w, info):
        WJi = Ji * (w[..., None, None] * info[None, :, None])
        WJj = Jj * (w[..., None, None] * info[None, :, None])
        H.index_put_((i, i), torch.einsum("nki,nkj->nij", Ji, WJi), accumulate=True)
        H.index_put_((j, j), torch.einsum("nki,nkj->nij", Jj, WJj), accumulate=True)
        H.index_put_((i, j), torch.einsum("nki,nkj->nij", Ji, WJj), accumulate=True)
        H.index_put_((j, i), torch.einsum("nki,nkj->nij", Jj, WJi), accumulate=True)
        b.index_add_(0, i, torch.einsum("nki,nk->ni", WJi, r))
        b.index_add_(0, j, torch.einsum("nki,nk->ni", WJj, r))

    add_factor(prev, idx, r_c, Ji_c, Jj_c, w_c, info_c)
    add_factor(li, lj, r_l, Ji_l, Jj_l, w_l, torch.ones(6, dtype=dtype, device=dev))
    prior_info = info_c * w_p          # strong unary on node 0
    H[0, 0] += torch.diag(prior_info)
    b[0] += prior_info * r_p

    # inactive poses: identity blocks keep the system well-posed
    Hd = H.permute(0, 2, 1, 3).reshape(N * 6, N * 6)
    act = active.to(dtype).repeat_interleave(6)
    Hd = Hd * (act[:, None] * act[None, :]) + torch.diag(1.0 - act)
    delta = -torch.linalg.solve(Hd, b.reshape(-1) * act).reshape(N, 6)
    return delta, active


def optimize_dense(g: PoseGraph, chain_sigma, iters: int) -> PoseGraph:
    """GN with a dense O(N^2)-memory assembly: the simple oracle."""
    for _ in range(iters):
        delta, active = _assemble_and_solve(g, chain_sigma)
        upd = g.poses @ se3.se3_exp(delta)
        g = g._replace(poses=torch.where(active[:, None, None], upd, g.poses))
    return g


# trust region of :func:`optimize`: no node moves more than this per step
MAX_STEP = 1.0


def _gn_parts(g: PoseGraph, sigma: torch.Tensor):
    """One GN iteration's factored system: (Ad, Jr, info, b, Vs).

    The chain + prior normal matrix is ``T = J^T diag(info) J`` with J
    block-bidiagonal from (Ad, Jr); ``b`` is the whole gradient
    ``J_all^T W r`` with the loops; ``Vs`` holds the sqrt-weighted loop
    columns, so the loop Hessian term is ``Vs Vs^T``."""
    N = g.poses.shape[0]
    Lf = g.loop_w.shape[0]
    dtype, dev = g.poses.dtype, g.poses.device
    info_c = 1.0 / sigma
    I6 = torch.eye(6, dtype=dtype, device=dev)
    idx = torch.arange(N, device=dev)
    active = idx < g.count
    prev = torch.clamp(idx - 1, min=0)

    # ---- chain rows i = 1 .. count-1 ----
    r_c, Jr_c, Ad_c = _between_parts(g.poses[prev], g.poses, g.chain_rel)
    row_chain = active & (idx > 0)
    # the prior sits at row 0 (Jr = I, Ad = 0); identity rows (Jr = I,
    # Ad = 0, info = 1) decouple the inactive suffix
    Ad = Ad_c * row_chain.to(dtype)[:, None, None]
    Jr = torch.where(row_chain[:, None, None], Jr_c, I6)
    w_p = (g.count > 0).to(dtype)
    info = torch.where(row_chain[:, None], info_c[None, :], torch.ones((1, 6), dtype=dtype, device=dev))
    info[0] = torch.where(g.count > 0, info_c, torch.ones(6, dtype=dtype, device=dev))

    # ---- gradient b = J^T Info r over all factors ----
    # accumulated by index_put_, which adds the duplicates of an index in
    # their order on the card too (index_add_'s atomics would not: the
    # loops that share node 0 would make a solve differ from run to run)
    w_c = row_chain.to(dtype)
    WJi = (-Jr_c @ Ad_c) * (w_c[:, None, None] * info_c[None, :, None])
    WJj = Jr_c * (w_c[:, None, None] * info_c[None, :, None])
    b = torch.zeros((N, 6), dtype=dtype, device=dev)
    b.index_put_((prev,), torch.einsum("nki,nk->ni", WJi, r_c), accumulate=True)
    b.index_put_((idx,), torch.einsum("nki,nk->ni", WJj, r_c), accumulate=True)
    r_p = se3.se3_log(se3.inv_mat(g.chain_rel[0]) @ g.poses[0])
    b[0] += info_c * w_p * r_p

    # ---- loop factors: gradient + sqrt-weighted low-rank columns ----
    li, lj = g.loop_i.long(), g.loop_j.long()
    r_l, Jr_l, Ad_l = _between_parts(g.poses[li], g.poses[lj], g.loop_rel)
    Ji_l = -Jr_l @ Ad_l
    w_l = _loop_weights(g)
    b.index_put_((li,), torch.einsum("lki,lk->li", Ji_l, r_l) * w_l[:, None], accumulate=True)
    b.index_put_((lj,), torch.einsum("lki,lk->li", Jr_l, r_l) * w_l[:, None], accumulate=True)

    # Vs[n, :, l, :] += J_l^T sqrt(w_l) at n = loop_i[l] and n = loop_j[l];
    # built as [N, L, 6, 6] (inactive slots add zeros at node 0)
    sw = torch.sqrt(w_l)[:, None, None]
    lf = torch.arange(Lf, device=dev)
    V = torch.zeros((N, Lf, 6, 6), dtype=dtype, device=dev)
    V.index_put_((li, lf), Ji_l.transpose(1, 2) * sw, accumulate=True)
    V.index_put_((lj, lf), Jr_l.transpose(1, 2) * sw, accumulate=True)
    Vs = V.permute(0, 2, 1, 3).reshape(N, 6, Lf * 6)
    return Ad, Jr, info, b, Vs


def _apply_system(Ad, Jr, info, Vs, d):
    """(T + Vs Vs^T) d with T = (Dg B)^T Info (Dg B) applied in factored
    form: two bidiagonal shifts, diagonal scales and the low-rank term, in
    the dtype of the inputs (the f64 refinement residual)."""
    # (B d)_i = d_i - Ad_i d_{i-1}   (Ad[0] = 0 covers the prior row)
    d_prev = torch.cat([torch.zeros_like(d[:1]), d[:-1]], 0)
    Bd = d - torch.einsum("nij,nj->ni", Ad, d_prev)
    r1 = info * torch.einsum("nij,nj->ni", Jr, Bd)
    # Dg^T r1, then (B^T y)_i = y_i - Ad_{i+1}^T y_{i+1}
    y = torch.einsum("nji,nj->ni", Jr, r1)
    y_next = torch.cat([y[1:], torch.zeros_like(y[:1])], 0)
    Ad_next = torch.cat([Ad[1:], torch.zeros_like(Ad[:1])], 0)
    Td = y - torch.einsum("nji,nj->ni", Ad_next, y_next)
    Vtd = torch.einsum("nik,ni->k", Vs, d)
    return Td + torch.einsum("nik,k->ni", Vs, Vtd)


def _factored_solver(Ad, Jr, info, Vs):
    """b -> delta = -(T + Vs Vs^T)^{-1} b, in the dtype of the inputs.

    The chain solve over the 6L loop columns, ``Z = T^-1 Vs``, and the
    matrix inversion lemma's 6L x 6L core are formed once; each solve then
    costs one single-column chain solve and the core solve (the reference's
    ``_factored_delta`` is one such solve)."""
    Z = chain_solve(Ad, Jr, info, Vs)
    core = torch.eye(Vs.shape[-1], dtype=Vs.dtype, device=Vs.device) \
        + torch.einsum("nik,nil->kl", Vs, Z)

    def solve(b):
        y = chain_solve(Ad, Jr, info, -b[:, :, None])[:, :, 0]     # T^-1 (-b)
        Vty = torch.einsum("nik,ni->k", Vs, y)
        return y - Z @ torch.linalg.solve_ex(core, Vty)[0]

    return solve


def optimize(g: PoseGraph, chain_sigma, iters: int, max_step: float = MAX_STEP,
             loop=fixed_loop) -> PoseGraph:
    """Production GN: factored O(N) chain solve + low-rank loop fold-in,

        delta = -(T + Vs Vs^T)^{-1} b
              = -(T^{-1} b) + T^{-1} Vs (I + Vs^T T^{-1} Vs)^{-1} Vs^T T^{-1} b,

    one chain solve over the 6L loop columns (shared by both solves below)
    and a 6L x 6L core solve.  The reference's mixed precision: the system
    is assembled in f64, solved in f32, and one f64 residual
    ``-b - (T + Vs Vs^T) delta`` is solved again in f32 and added.  A global
    trust-region scale keeps every node's step within ``max_step``.
    ``iters`` GN iterations, no early stop, run by ``loop``
    (``device.fixed_loop``'s contract) over the poses."""
    dtype, dev = g.poses.dtype, g.poses.device
    active = torch.arange(g.poses.shape[0], device=dev) < g.count
    sigma = vector(chain_sigma, torch.float64, dev)

    def iteration(carry):
        poses, = carry
        g64 = g._replace(poses=poses.double(), chain_rel=g.chain_rel.double(),
                         loop_rel=g.loop_rel.double(), loop_w=g.loop_w.double())
        Ad, Jr, info, b, Vs = _gn_parts(g64, sigma)
        solve32 = _factored_solver(Ad.float(), Jr.float(), info.float(), Vs.float())
        delta = solve32(b.float()).double()
        res = -b - _apply_system(Ad, Jr, info, Vs, delta)
        delta = (delta + solve32(-res.float()).double()).to(dtype)
        step = torch.clamp(torch.max(torch.abs(delta)), min=1e-12)
        delta = delta * torch.clamp(torch.full_like(step, max_step) / step, max=1.0)
        upd = poses @ se3.se3_exp(delta)
        return torch.where(active[:, None, None], upd, poses),

    poses, = loop(iteration, (g.poses,), iters)
    return g._replace(poses=poses)


def graph_energy(g: PoseGraph, chain_sigma) -> torch.Tensor:
    """Total weighted squared residual of chain + prior + loop factors: the
    objective :func:`optimize` minimises (loop closure solves from two
    initialisations and keeps the lower-energy result)."""
    dtype, dev = g.poses.dtype, g.poses.device
    idx = torch.arange(g.poses.shape[0], device=dev)
    info = 1.0 / vector(chain_sigma, dtype, dev)
    prev = g.poses[torch.clamp(idx - 1, min=0)]
    r_c = se3.se3_log(se3.inv_mat(g.chain_rel) @ se3.inv_mat(prev) @ g.poses)
    w_c = ((idx < g.count) & (idx > 0)).to(dtype)
    e = torch.sum(w_c[:, None] * r_c * r_c * info[None, :])
    r_p = se3.se3_log(se3.inv_mat(g.chain_rel[0]) @ g.poses[0])
    e = e + (g.count > 0).to(dtype) * torch.sum(r_p * r_p * info)
    r_l = se3.se3_log(se3.inv_mat(g.loop_rel) @ se3.inv_mat(g.poses[g.loop_i.long()])
                      @ g.poses[g.loop_j.long()])
    return e + torch.sum(_loop_weights(g)[:, None] * r_l * r_l)
