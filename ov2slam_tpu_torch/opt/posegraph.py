"""SE(3) pose-graph optimization: relative-pose chain + loop edges (port of
``ov2slam_tpu/opt/posegraph.py``).

Replaces the reference's localPoseGraph / fullPoseGraph Ceres problems
(optimizer.cpp:2346-2592, :2783-2865): relative-pose factors between
consecutive keyframes plus loop-closure edges, solved with LM; gauge-fixed
poses (``pose_opt`` False) stay put. E padded edge slots (weight 0), closed-
form 6x6 Jacobians (``residuals.relpose_jacobians``), dense (6F, 6F) normal
equations scatter-added (``index_add_``: atomics on the card, so sums land
in a run-dependent order, float32 reassociation only) and solved densely
by Cholesky (the JAX package solves by LU: the same solution to float32
rounding).

The solver takes a leading batch dimension: ``relax_full_trajectory`` solves
its S independent segments as one batch (one batched Cholesky solve per
iteration) where the JAX package vmaps. The LM loop runs a fixed number
of iterations; a problem whose step became tiny is frozen with
``torch.where``, as the JAX ``while_loop`` under ``vmap`` freezes it, so the
loop never reads the device.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ov2slam_tpu_torch.core import lie, smallalg
from ov2slam_tpu_torch.core.lie import SE3
from ov2slam_tpu_torch.opt import residuals as res


class PoseGraphProblem(NamedTuple):
    """Leading dims (B,) optional on every field."""
    R: torch.Tensor            # (F, 3, 3) world-to-cam
    t: torch.Tensor            # (F, 3)
    pose_opt: torch.Tensor     # (F,) bool — False = gauge-fixed
    edge_i: torch.Tensor       # (E,) int64
    edge_j: torch.Tensor       # (E,) int64
    # measured relative pose T_ij = T_i T_j^-1 (world-to-cam convention)
    meas_R: torch.Tensor       # (E, 3, 3)
    meas_t: torch.Tensor       # (E, 3)
    edge_weight: torch.Tensor  # (E,) 0 = padding


class PoseGraphResult(NamedTuple):
    R: torch.Tensor
    t: torch.Tensor
    cost0: torch.Tensor
    cost: torch.Tensor


def _gather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (B, F, ...) rows at idx (B, E) -> (B, E, ...)."""
    b = torch.arange(x.shape[0], device=x.device)[:, None]
    return x[b, idx]


def _edge_res_jac(p: PoseGraphProblem, R, t):
    Ti = SE3(_gather(R, p.edge_i), _gather(t, p.edge_i))
    Tj = SE3(_gather(R, p.edge_j), _gather(t, p.edge_j))
    return res.relpose_jacobians(Ti, Tj, SE3(p.meas_R, p.meas_t))


def solve_pose_graph(p: PoseGraphProblem, max_iters: int = 10,
                     lam0: float = 1e-6) -> PoseGraphResult:
    """LM on the pose graph (batched over a leading dim when the fields have
    one): one normal-equation build and dense solve per iteration, the step
    kept only where it lowers the cost, damping halved on success and x10 on
    failure, frozen once |dx|^2 < 1e-14."""
    batched = p.R.dim() == 4
    if not batched:
        p = PoseGraphProblem(*(a[None] for a in p))
    dt, dev = p.t.dtype, p.t.device
    B, F = p.R.shape[:2]
    pose_w = p.pose_opt.to(dt)                                  # (B, F)
    sw = torch.sqrt(p.edge_weight)[..., None]                   # (B, E, 1)
    bidx = torch.arange(B, device=dev)[:, None]
    ii = (bidx * F + p.edge_i) * F                              # (B, E)
    jj = (bidx * F + p.edge_j) * F
    gi, gj = bidx * F + p.edge_i, bidx * F + p.edge_j
    blocks_idx = torch.cat([ii + p.edge_i, jj + p.edge_j, ii + p.edge_j,
                            jj + p.edge_i], dim=1).reshape(-1)
    g_idx = torch.cat([gi, gj], dim=1).reshape(-1)
    const6 = torch.repeat_interleave(1.0 - pose_w, 6, dim=-1)   # (B, 6F)
    mask6 = torch.repeat_interleave(pose_w, 6, dim=-1)

    def eval_cost(R, t):
        r, _, _ = _edge_res_jac(p, R, t)
        return torch.sum(torch.sum(r * r, dim=-1) * p.edge_weight, dim=-1)

    def step(R, t, damp):
        r, Ja, Jb = _edge_res_jac(p, R, t)
        rw = r * sw
        Jaw = Ja * sw[..., None] * _gather(pose_w, p.edge_i)[..., None, None]
        Jbw = Jb * sw[..., None] * _gather(pose_w, p.edge_j)[..., None, None]
        JtJ = lambda A, C: torch.einsum("beij,beik->bejk", A, C)  # noqa: E731
        Jtr = lambda A: torch.einsum("beij,bei->bej", A, rw)       # noqa: E731
        vals = torch.cat([JtJ(Jaw, Jaw), JtJ(Jbw, Jbw), JtJ(Jaw, Jbw),
                          JtJ(Jbw, Jaw)], dim=1).reshape(-1, 6, 6)
        H = torch.zeros((B * F * F, 6, 6), dtype=dt, device=dev)
        H.index_add_(0, blocks_idx, vals)
        g = torch.zeros((B * F, 6), dtype=dt, device=dev)
        g.index_add_(0, g_idx, torch.cat([Jtr(Jaw), Jtr(Jbw)], 1).reshape(-1, 6))
        Hf = H.reshape(B, F, F, 6, 6).permute(0, 1, 3, 2, 4).reshape(B, 6 * F, 6 * F)
        diag = torch.diagonal(Hf, dim1=-2, dim2=-1)
        Hf = Hf + torch.diag_embed(damp[:, None] * torch.clamp(diag.abs(), min=1e-8)
                                   + const6)
        gf = g.reshape(B, 6 * F) * mask6
        # Hf is symmetric positive definite (damped normal equations, unit
        # rows for gauge poses), so Cholesky and two triangular solves (no
        # error check, so no host read); the batched LU of the CPU build's
        # MKL hangs on some batches with more than one thread
        L = torch.linalg.cholesky_ex(Hf)[0]
        dx = -smallalg.cho_solve_spd(L, gf).reshape(B, F, 6)
        dx = dx * pose_w[..., None]
        T = lie.se3_boxplus_left(SE3(R, t), dx)
        return T.R, T.t, dx

    R, t = p.R, p.t
    cost0 = eval_cost(R, t)
    cost = cost0
    damp = torch.full((B,), lam0, dtype=dt, device=dev)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    for _ in range(max_iters):
        Rn, tn, dx = step(R, t, damp)
        cost_new = eval_cost(Rn, tn)
        better = (cost_new < cost) & ~done
        R = torch.where(better[:, None, None, None], Rn, R)
        t = torch.where(better[:, None, None], tn, t)
        damp = torch.where(done, damp, torch.clamp(
            torch.where(better, damp * 0.5, damp * 10.0), 1e-9, 1e6))
        cost = torch.where(better, cost_new, cost)
        done = done | (torch.sum(dx * dx, dim=(1, 2)) < 1e-14)
    out = PoseGraphResult(R, t, cost0, cost)
    return out if batched else PoseGraphResult(*(a[0] for a in out))


def relax_full_trajectory(poses_wc_raw: np.ndarray, kf_frame_idx: np.ndarray,
                          kf_T_wc: np.ndarray, device=None) -> np.ndarray:
    """Full-trajectory pose graph (Optimizer::fullPoseGraph,
    optimizer.cpp:2783-2865 + SlamManager::writeFullTrajectoryLC,
    ov2slam.cpp:624-701): every frame pose is a node, chain edges carry the
    tracking-time relative poses, keyframe poses stay at their
    loop-corrected values, and the non-KF poses relax onto that skeleton.
    With the KF nodes fixed the chain splits into independent segments
    between consecutive keyframes; they are padded to one power-of-two
    length and solved as one batch (15 LM iterations).

    poses_wc_raw (F, 4, 4) tracking-time T_wc, kf_frame_idx (K,) frame
    indices of live KFs, kf_T_wc (K, 4, 4) corrected KF poses. Returns
    (F, 4, 4) float64 relaxed T_wc; frames before the first / after the
    last keyframe get the rigid chain rebuild. ``device=None`` is the CPU
    (this runs once, after the run)."""
    F = len(poses_wc_raw)
    out = np.array(poses_wc_raw, np.float64, copy=True)
    if F == 0 or len(kf_frame_idx) == 0:
        return out
    # tracking-time relatives: rel[i] = T_wc_raw[i-1]^-1 @ T_wc_raw[i]
    inv_prev = np.linalg.inv(poses_wc_raw[:-1])
    rel = np.einsum("fij,fjk->fik", inv_prev, poses_wc_raw[1:])

    # rigid chain rebuild from the corrected KF anchors (the "wlc" pass)
    kf_set = {int(i): k for k, i in enumerate(kf_frame_idx)}
    first_kf = int(kf_frame_idx[0])
    T = kf_T_wc[0].copy()
    for i in range(first_kf, -1, -1):
        out[i] = T
        if i > 0:
            T = T @ np.linalg.inv(rel[i - 1])
    T = kf_T_wc[0].copy()
    for i in range(first_kf, F):
        if i in kf_set:
            T = kf_T_wc[kf_set[i]].copy()
        elif i > 0:
            T = out[i - 1] @ rel[i - 1]
        out[i] = T

    # batched segment relaxation between consecutive KFs
    segs = [(int(a), int(b)) for a, b in zip(kf_frame_idx[:-1], kf_frame_idx[1:])
            if b - a >= 2]
    if not segs:
        return out
    Lmax = 1 << max(2, int(max(b - a for a, b in segs)).bit_length())
    S, E = len(segs), Lmax - 1
    R = np.tile(np.eye(3, dtype=np.float32), (S, Lmax, 1, 1))
    t = np.zeros((S, Lmax, 3), np.float32)
    opt = np.zeros((S, Lmax), bool)
    ei = np.zeros((S, E), np.int64)
    ej = np.zeros((S, E), np.int64)
    mR = np.tile(np.eye(3, dtype=np.float32), (S, E, 1, 1))
    mt = np.zeros((S, E, 3), np.float32)
    w = np.zeros((S, E), np.float32)
    for s, (a, b) in enumerate(segs):
        n = b - a + 1
        T_cw = np.linalg.inv(out[a:b + 1])          # init from the rebuild
        R[s, :n] = T_cw[:, :3, :3]
        t[s, :n] = T_cw[:, :3, 3]
        opt[s, 1:n - 1] = True                       # endpoints fixed
        idx = np.arange(1, n)
        ei[s, :n - 1] = idx
        ej[s, :n - 1] = idx - 1
        # meas T_ij in world-to-cam: T_cw_i @ T_cw_j^-1 = T_wc_i^-1 T_wc_j
        m = np.linalg.inv(poses_wc_raw[a + 1:b + 1]) @ poses_wc_raw[a:b]
        mR[s, :n - 1] = m[:, :3, :3]
        mt[s, :n - 1] = m[:, :3, 3]
        w[s, :n - 1] = 1.0
    to = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    r = solve_pose_graph(PoseGraphProblem(
        to(R), to(t), to(opt), to(ei), to(ej), to(mR), to(mt), to(w)),
        max_iters=15)
    R_new = r.R.cpu().numpy().astype(np.float64)
    t_new = r.t.cpu().numpy().astype(np.float64)
    for s, (a, b) in enumerate(segs):
        for li in range(1, b - a):
            T_cw = np.eye(4)
            T_cw[:3, :3] = R_new[s, li]
            T_cw[:3, 3] = t_new[s, li]
            out[a + li] = np.linalg.inv(T_cw)
    return out


def propagate_correction(R_old, t_old, R_new, t_new, last_idx: int,
                         R_tail, t_tail) -> SE3:
    """Apply keyframe `last_idx`'s correction to newer poses that were not
    in the graph (optimizer.cpp:2527-2589): T'_cw = T_cw o T_old^-1 o T_new,
    world-to-cam, evaluated at last_idx."""
    T_old = SE3(R_old[last_idx], t_old[last_idx])
    T_new = SE3(R_new[last_idx], t_new[last_idx])
    corr = lie.se3_compose(lie.se3_inverse(T_old), T_new)
    return lie.se3_compose(SE3(R_tail, t_tail), corr)
