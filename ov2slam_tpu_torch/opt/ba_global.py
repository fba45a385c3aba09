"""Global bundle adjustment: matrix-free Schur-reduced PCG, one solve over
all keyframes of a span (port of ``ov2slam_tpu/opt/ba_global.py``).

Replaces the reference's Optimizer::fullBA and the loose BA over a loop span
(optimizer.cpp:1674-2333, :900-1673). Nothing bigger than the observation
arrays is materialized, unlike the dense local BA's (L, F, 6, nl) coupling
tensor:

* landmark blocks are eliminated exactly per landmark (Hll is block
  diagonal; its inverse is a batched nl x nl inverse);
* the reduced camera system S = Hpp - W Hll^-1 W^T is applied matrix-free:
  each S @ v is two passes over the observations (gather pose blocks,
  per-observation 2-vectors, sum back by ordered segment sums,
  ``ops/segment.py``: one order in every run, no atomics);
* the linear solve is preconditioned CG (block-Jacobi from the damped 6x6
  pose diagonal of Hpp, factored once per solve) with a fixed ``cg_iters``
  budget; an iterate whose residual vanished is frozen with ``torch.where``;
* the outer loop is LM accept/reject on the robust cost, with the Huber IRLS
  weighting, the chi2 sweep and the optional robust -> L2 re-solve of the
  local solver. It runs ``max_iters`` iterations and freezes once the step
  is tiny, as the JAX ``while_loop`` exits, so no iteration reads the
  device.
"""

from __future__ import annotations

import torch

from ov2slam_tpu_torch.core import lie, smallalg
from ov2slam_tpu_torch.core.lie import SE3
from ov2slam_tpu_torch.ops.segment import segment_index, segment_sum
from ov2slam_tpu_torch.opt import ba as ba_mod
from ov2slam_tpu_torch.opt.ba import BAProblem, BAResult


def solve_ba_global(p: BAProblem, invdepth: bool = True, max_iters: int = 12,
                    robust: bool = True, th2_mono: float = 5.9915,
                    th2_stereo: float = 7.8147, lam0: float = 1e-4,
                    cg_iters: int = 48, l2_refine: bool = True,
                    l2_iters: int = 6) -> BAResult:
    """One global Schur-PCG LM solve over the whole problem; with
    ``l2_refine`` the chi2 outliers are masked and the inliers re-solved
    with L2 loss (apply_l2_after_robust, optimizer.cpp:488-735)."""
    # the segment indices of the sums, one set for both solves
    F, L = p.R.shape[0], p.lam.shape[0]
    pose_idx = (torch.cat([p.obs_kf, p.anchor[p.obs_lm]]) if invdepth
                else p.obs_kf)
    segs = (segment_index(pose_idx, F), segment_index(p.obs_lm, L))
    out = _lm_pcg(p, p.R, p.t, p.Xw, p.lam, robust, invdepth, max_iters,
                  th2_mono, th2_stereo, lam0, cg_iters, segs)
    if l2_refine:
        p2 = p._replace(obs_valid=out.obs_inlier)
        out2 = _lm_pcg(p2, out.R, out.t, out.Xw, out.lam, False, invdepth,
                       l2_iters, th2_mono, th2_stereo, lam0, cg_iters, segs)
        out = BAResult(out2.R, out2.t, out2.Xw, out2.lam,
                       out2.obs_inlier & out.obs_inlier, out.cost0, out2.cost,
                       out.n_iters + out2.n_iters)
    return out


def _lm_pcg(p: BAProblem, R_init, t_init, Xw_init, lam_init, robust: bool,
            invdepth: bool, max_iters: int, th2_mono: float, th2_stereo: float,
            lam0: float, cg_iters: int, segs) -> BAResult:
    dt, dev = p.t.dtype, p.t.device
    F, L = p.R.shape[0], p.lam.shape[0]
    nl = 1 if invdepth else 3
    pose_w = p.pose_opt.to(dt)
    lm_w = p.lm_valid.to(dt)
    const = 1.0 - pose_w
    eyeL = torch.eye(nl, dtype=dt, device=dev)
    eye6 = torch.eye(6, dtype=dt, device=dev)
    th2 = ba_mod._th2(p, th2_mono, th2_stereo)
    anc = p.anchor[p.obs_lm] if invdepth else p.obs_kf
    seg_pose, seg_lm = segs

    def build(R, t, Xw, lam):
        """Weighted Jacobians (masks folded in), landmark blocks, pose
        diagonal blocks and right-hand sides; and the robust cost."""
        r, J_obs, J_anc, J_lm, _ = ba_mod._residuals_all(p, R, t, Xw, lam,
                                                         invdepth)
        w, chi2 = ba_mod._sqrtw(p, r, th2, robust)
        Jo = J_obs * (w * pose_w[p.obs_kf])[:, None, None]
        if invdepth:
            J_anc = ba_mod._anchor_jacobian_fix(p, R, t, J_anc)
            Ja = J_anc * (w * pose_w[anc])[:, None, None]
        else:
            Ja = torch.zeros_like(J_obs)
        Jl = J_lm * (w * lm_w[p.obs_lm])[:, None, None]
        rw = r * w[:, None]
        Hll = segment_sum(seg_lm, torch.einsum("oij,oik->ojk", Jl, Jl))
        bl = segment_sum(seg_lm, torch.einsum("oij,oi->oj", Jl, rw))
        if invdepth:
            Hpp_d = segment_sum(seg_pose, torch.einsum(
                "oij,oik->ojk", torch.cat([Jo, Ja]), torch.cat([Jo, Ja])))
            bp = segment_sum(seg_pose, torch.einsum(
                "oij,oi->oj", torch.cat([Jo, Ja]), torch.cat([rw, rw])))
        else:
            Hpp_d = segment_sum(seg_pose, torch.einsum("oij,oik->ojk", Jo, Jo))
            bp = segment_sum(seg_pose, torch.einsum("oij,oi->oj", Jo, rw))
        cost = ba_mod._robust_cost(p, chi2, th2, robust)
        return (Jo, Ja, Jl, Hll, bl, Hpp_d, bp), cost

    def eval_cost(R, t, Xw, lam):
        r, _, _, _, _ = ba_mod._residuals_all(p, R, t, Xw, lam, invdepth)
        return ba_mod._robust_cost(p, torch.sum(r * r, dim=-1), th2, robust)

    def solve_step(sys, damp):
        Jo, Ja, Jl, Hll, bl, Hpp_d, bp = sys
        # damped exact landmark-block inverse
        diagL = torch.diagonal(Hll, dim1=-2, dim2=-1)
        Hll_damp = Hll + damp * eyeL * torch.clamp(diagL.abs(), min=1e-6)[..., None]
        diag_ok = (diagL.sum(-1) > 1e-10).to(dt)[:, None, None]
        if nl == 1:
            Hll_inv = (1.0 / torch.clamp(Hll_damp, min=1e-12)) * diag_ok
        else:
            Hll_inv = smallalg.inv3(Hll_damp + (1.0 - diag_ok) * eyeL) * diag_ok

        def pose_gather(v):
            """per-observation J v restricted to the pose blocks (O, 2)"""
            u = torch.einsum("oij,oj->oi", Jo, v[p.obs_kf])
            if invdepth:
                u = u + torch.einsum("oij,oj->oi", Ja, v[anc])
            return u

        def pose_scatter(u):
            """J^T u accumulated into the pose slots (F, 6)"""
            if invdepth:
                return segment_sum(seg_pose, torch.einsum(
                    "oij,oi->oj", torch.cat([Jo, Ja]), torch.cat([u, u])))
            return segment_sum(seg_pose, torch.einsum("oij,oi->oj", Jo, u))

        def lm_scatter(u):
            return segment_sum(seg_lm, torch.einsum("oij,oi->oj", Jl, u))

        def lm_gather(y):
            return torch.einsum("oij,oj->oi", Jl, y[p.obs_lm])

        damp_diag = damp * torch.clamp(
            torch.diagonal(Hpp_d, dim1=-2, dim2=-1).abs(), min=1e-6)   # (F, 6)

        def S_mv(v):
            # v (F, 6) -> S v, S = Hpp - W Hll^-1 W^T + damping + gauge
            u = pose_gather(v)
            y = torch.einsum("lnm,lm->ln", Hll_inv, lm_scatter(u))
            hv = pose_scatter(u) - pose_scatter(lm_gather(y)) + damp_diag * v
            return hv * pose_w[:, None] + const[:, None] * v

        # reduced rhs b_red = bp - W Hll^-1 bl; solve S dx = -b_red
        y0 = torch.einsum("lnm,lm->ln", Hll_inv, bl)
        b_red = (bp - pose_scatter(lm_gather(y0))) * pose_w[:, None]
        # block-Jacobi preconditioner from the damped pose diagonal
        M = (Hpp_d + damp_diag[:, :, None] * eye6
             + (const[:, None, None] + 1e-8) * eye6)
        M_chol = smallalg.cholesky_spd(M)

        def precond(r_):
            return smallalg.cho_solve_spd(M_chol, r_) * pose_w[:, None]

        x = torch.zeros((F, 6), dtype=dt, device=dev)
        r_ = -b_red
        z = precond(r_)
        rho = torch.sum(r_ * z)
        d = z
        for _ in range(cg_iters):
            Sd = S_mv(d)
            alpha = rho / torch.clamp(torch.sum(d * Sd), min=1e-20)
            x2 = x + alpha * d
            r2 = r_ - alpha * Sd
            z2 = precond(r2)
            rho2 = torch.sum(r2 * z2)
            d2 = z2 + (rho2 / torch.clamp(rho, min=1e-20)) * d
            # frozen once converged
            live = rho > 1e-16
            x, r_, z, d = (torch.where(live, b, a) for a, b in
                           ((x, x2), (r_, r2), (z, z2), (d, d2)))
            rho = torch.where(live, rho2, rho)
        dxp = x * pose_w[:, None]
        # back-substitute landmarks: dl = Hll^-1 (-bl - W^T dxp)
        dl = torch.einsum("lnm,lm->ln", Hll_inv, -bl - lm_scatter(pose_gather(dxp)))
        return dxp, dl * lm_w[:, None]

    def apply_step(R, t, Xw, lam, dxp, dl):
        T_new = lie.se3_boxplus_left(SE3(R, t), dxp)
        if invdepth:
            return T_new.R, T_new.t, Xw, lam + dl[:, 0]
        return T_new.R, T_new.t, Xw + dl, lam

    # LM: one build per iteration; a rejected trial re-solves the stored
    # best system with more damping
    best = (R_init, t_init, Xw_init, lam_init)
    best_sys, best_cost = build(*best)
    cost0 = best_cost
    damp = torch.full((), lam0, dtype=dt, device=dev)
    trial = apply_step(*best, *solve_step(best_sys, damp))
    done = torch.zeros((), dtype=torch.bool, device=dev)
    it = torch.ones((), dtype=torch.int64, device=dev)
    for _ in range(max_iters - 1):
        live = ~done
        sys_t, cost_t = build(*trial)
        better = (cost_t < best_cost) & live
        best = tuple(torch.where(better, a, b) for a, b in zip(trial, best))
        best_sys = tuple(torch.where(better, a, b) for a, b in zip(sys_t, best_sys))
        best_cost = torch.where(better, cost_t, best_cost)
        damp = torch.where(live, torch.clamp(
            torch.where(better, damp * 0.5, damp * 10.0), 1e-8, 1e6), damp)
        dxp, dl = solve_step(best_sys, damp)
        trial = tuple(torch.where(live, a, b) for a, b in
                      zip(apply_step(*best, dxp, dl), trial))
        it = it + live.to(torch.int64)
        done = done | (torch.sum(dxp * dxp) + torch.sum(dl * dl) < 1e-14)

    # the final trial may beat the best-so-far; take the winner
    cost_trial, cost_best = eval_cost(*trial), eval_cost(*best)
    take = cost_trial < cost_best
    R_f, t_f, X_f, lam_f = (torch.where(take, a, b) for a, b in zip(trial, best))
    cost_f = torch.minimum(cost_trial, cost_best)

    r, _, _, _, pos = ba_mod._residuals_all(p, R_f, t_f, X_f, lam_f, invdepth)
    inl = p.obs_valid & (torch.sum(r * r, dim=-1) <= th2) & pos
    if invdepth:
        T_wa = lie.se3_inverse(SE3(R_f[p.anchor], t_f[p.anchor]))
        ilam = 1.0 / torch.where(lam_f.abs() < 1e-9,
                                 torch.full_like(lam_f, 1e-9), lam_f)
        Xw_out = lie.se3_apply(T_wa, p.bearing * ilam[:, None])
    else:
        Xw_out = X_f
    return BAResult(R_f, t_f, Xw_out, lam_f, inl, cost0, cost_f, it)
