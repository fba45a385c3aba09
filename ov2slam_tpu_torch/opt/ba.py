"""Bundle adjustment: Schur-complement Levenberg-Marquardt (port of the LM
path of ``ov2slam_tpu/opt/ba.py::solve_ba``; the dogleg method, pose-only
refinement and the structure-only solver are not ported yet).

Replaces Ceres SPARSE_SCHUR + LM for the reference's local BA
(optimizer.cpp:34-897). "Pad everything, mask everything": F pose slots, L
landmark slots and O observation slots with validity masks; the normal
equations are scatter-added into dense padded blocks — pose-pose (F, F, 6,
6), landmark diagonal (L, nl, nl), pose-landmark (L, F, 6, nl) — landmarks
are eliminated with one einsum and the (6F, 6F) reduced camera system is
solved densely. Padded observations carry zero weight and in-range indices,
so they add exact zeros. On the GPU the scatter-adds use atomics, so sums
land in a run-dependent order (float32 reassociation only).

Landmarks are XYZ (nl=3) or anchored inverse depth (nl=1, with Jacobians
into the anchor pose block as well — buse_inv_depth).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ov2slam_tpu_torch.core import lie, smallalg
from ov2slam_tpu_torch.core.lie import SE3
from ov2slam_tpu_torch.opt import residuals as res
from ov2slam_tpu_torch.opt.residuals import Calib


class BAProblem(NamedTuple):
    """Padded BA problem (poses world-to-cam). In inverse-depth mode,
    landmark j is ``X_w = T_wc[anchor[j]] (bearing[j] / lam[j])``."""

    R: torch.Tensor            # (F, 3, 3)
    t: torch.Tensor            # (F, 3)
    pose_opt: torch.Tensor     # (F,) bool — optimized (vs constant/gauge)
    Xw: torch.Tensor           # (L, 3)
    anchor: torch.Tensor       # (L,) int64 anchor pose slot
    bearing: torch.Tensor      # (L, 3) anchor-frame bearing, z=1
    lam: torch.Tensor          # (L,) inverse depth
    lm_valid: torch.Tensor     # (L,) bool
    obs_kf: torch.Tensor       # (O,) int64 observer pose slot
    obs_lm: torch.Tensor       # (O,) int64 landmark slot
    obs_px: torch.Tensor       # (O, 2) undistorted pixels
    obs_right: torch.Tensor    # (O,) bool — right-camera observation
    obs_valid: torch.Tensor    # (O,) bool
    calib_l: Calib
    calib_r: Calib
    T_rl: SE3                  # right-from-left extrinsic


class BAResult(NamedTuple):
    R: torch.Tensor
    t: torch.Tensor
    Xw: torch.Tensor
    lam: torch.Tensor
    obs_inlier: torch.Tensor   # (O,) bool — survived the chi2/depth sweep
    cost0: torch.Tensor
    cost: torch.Tensor
    n_iters: int


def _sel(m: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """where(m, a, b) with m (O,) broadcast over a's trailing dims."""
    return torch.where(m.reshape(m.shape + (1,) * (a.dim() - 1)), a, b)


def _residuals_all(p: BAProblem, R, t, Xw, lam, invdepth: bool):
    """Per-observation residuals + Jacobians: r (O,2), J_obs (O,2,6),
    J_anc (O,2,6), J_lm (O,2,nl), depth>0 (O,)."""
    Ro, to = R[p.obs_kf], t[p.obs_kf]
    T_obs = SE3(Ro, to)
    if invdepth:
        anc = p.anchor[p.obs_lm]
        T_wa = lie.se3_inverse(SE3(R[anc], t[anc]))
        b_a = p.bearing[p.obs_lm]
        lam_o = lam[p.obs_lm]
        rl, Jol, Jal, Jll, posl = res.reproj_anch_invdepth(
            p.calib_l, T_wa, T_obs, b_a, lam_o, p.obs_px)
        T_rl = SE3(p.T_rl.R.expand(Ro.shape), p.T_rl.t.expand(to.shape))
        rr, Jor, Jar, Jlr, posr = res.reproj_anch_invdepth(
            p.calib_r, T_wa, T_obs, b_a, lam_o, p.obs_px, T_rl)
        m = p.obs_right
        return (_sel(m, rr, rl), _sel(m, Jor, Jol), _sel(m, Jar, Jal),
                _sel(m, Jlr, Jll), torch.where(m, posr, posl))
    X = Xw[p.obs_lm]
    rl, Jpl, Jxl, posl = res.reproj_xyz(p.calib_l, T_obs, X, p.obs_px)
    rr, Jpr, Jxr, posr = res.reproj_xyz_right(p.calib_r, p.T_rl, T_obs, X,
                                              p.obs_px)
    m = p.obs_right
    J_obs = _sel(m, Jpr, Jpl)
    return (_sel(m, rr, rl), J_obs, torch.zeros_like(J_obs), _sel(m, Jxr, Jxl),
            torch.where(m, posr, posl))


def _anchor_jacobian_fix(p: BAProblem, R, t, J_anc_wa):
    """Convert the anchor Jacobian from an update of T_wa to a left-mult
    update of the anchor's world-to-cam pose: xi_wa = -Ad(T_wa) xi_aw."""
    anc = p.anchor[p.obs_lm]
    Ad = lie.se3_adjoint(lie.se3_inverse(SE3(R[anc], t[anc])))
    return -(J_anc_wa @ Ad)


def _robust_cost(p, chi2, th2, robust: bool):
    w_valid = p.obs_valid.to(chi2.dtype)
    if robust:
        th = torch.sqrt(th2)
        rho = torch.where(chi2 <= th2, chi2, 2.0 * th * torch.sqrt(chi2) - th2)
    else:
        rho = chi2
    return torch.sum(rho * w_valid)


def solve_ba(p: BAProblem, invdepth: bool = True, max_iters: int = 5,
             robust: bool = True, th2_mono: float = 5.9915,
             th2_stereo: float = 7.8147, lam0: float = 1e-4,
             l2_refine: bool = False, l2_iters: int = 5) -> BAResult:
    """Schur-complement LM. ``l2_refine`` mirrors apply_l2_after_robust
    (optimizer.cpp:488-735): after the robust solve and the chi2 sweep,
    outliers are masked and the inliers re-solved with plain L2 loss."""
    out = _lm_run(p, p.R, p.t, p.Xw, p.lam, robust, invdepth, max_iters,
                  th2_mono, th2_stereo, lam0)
    if l2_refine:
        p2 = p._replace(obs_valid=out.obs_inlier)
        out2 = _lm_run(p2, out.R, out.t, out.Xw, out.lam, False, invdepth,
                       l2_iters, th2_mono, th2_stereo, lam0)
        out = BAResult(out2.R, out2.t, out2.Xw, out2.lam,
                       out2.obs_inlier & out.obs_inlier, out.cost0, out2.cost,
                       out.n_iters + out2.n_iters)
    return out


def _lm_run(p: BAProblem, R_init, t_init, Xw_init, lam_init, robust: bool,
            invdepth: bool, max_iters: int, th2_mono: float,
            th2_stereo: float, lam0: float) -> BAResult:
    """One robust-or-L2 LM run.

    The JAX ``while_loop`` exits on ``it < max_iters & ~small`` where
    ``small`` is a tiny step; the state keeps changing after that (damping,
    trial), so the exit is kept exact here: one host read per iteration."""
    dt = p.t.dtype
    dev = p.t.device
    F = p.R.shape[0]
    L = p.lam.shape[0]
    nl = 1 if invdepth else 3
    pose_w = p.pose_opt.to(dt)
    lm_w = p.lm_valid.to(dt)
    th2 = torch.where(p.obs_right, torch.tensor(th2_stereo, dtype=dt, device=dev),
                      torch.tensor(th2_mono, dtype=dt, device=dev))
    anc_idx = p.anchor[p.obs_lm] if invdepth else p.obs_kf
    ff = p.obs_kf * F + p.obs_kf          # flat (F*F) block index
    eyeL = torch.eye(nl, dtype=dt, device=dev)

    def scatter(n, index, vals):
        """Sum the rows of vals into n slots (index_add_: atomics on GPU)."""
        out = torch.zeros((n,) + tuple(vals.shape[1:]), dtype=dt, device=dev)
        return out.index_add_(0, index, vals)

    def build(R, t, Xw, lam):
        r, J_obs, J_anc, J_lm, _ = _residuals_all(p, R, t, Xw, lam, invdepth)
        if invdepth:
            J_anc = _anchor_jacobian_fix(p, R, t, J_anc)
        chi2 = torch.sum(r * r, dim=-1)
        sw = res.huber_weight(chi2, th2) if robust else torch.ones_like(chi2)
        w = p.obs_valid.to(dt) * sw
        Jo = J_obs * (w * pose_w[p.obs_kf])[:, None, None]
        Ja = J_anc * (w * pose_w[anc_idx])[:, None, None]
        Jl = J_lm * (w * lm_w[p.obs_lm])[:, None, None]
        rw = r * w[:, None]
        cost = _robust_cost(p, chi2, th2, robust)

        JtJ = lambda A, B: torch.einsum("oij,oik->ojk", A, B)  # noqa: E731
        Jtr = lambda A: torch.einsum("oij,oi->oj", A, rw)      # noqa: E731
        hpp_idx = [ff]
        hpp_val = [JtJ(Jo, Jo)]
        bp_idx, bp_val = [p.obs_kf], [Jtr(Jo)]
        W_idx = [p.obs_lm * F + p.obs_kf]
        W_val = [JtJ(Jo, Jl)]
        if invdepth:
            hpp_idx += [anc_idx * F + anc_idx, p.obs_kf * F + anc_idx,
                        anc_idx * F + p.obs_kf]
            hpp_val += [JtJ(Ja, Ja), JtJ(Jo, Ja), JtJ(Ja, Jo)]
            bp_idx.append(anc_idx)
            bp_val.append(Jtr(Ja))
            W_idx.append(p.obs_lm * F + anc_idx)
            W_val.append(JtJ(Ja, Jl))
        Hpp = scatter(F * F, torch.cat(hpp_idx),
                      torch.cat(hpp_val)).reshape(F, F, 6, 6)
        bp = scatter(F, torch.cat(bp_idx), torch.cat(bp_val))
        Hll = scatter(L, p.obs_lm, JtJ(Jl, Jl))
        bl = scatter(L, p.obs_lm, Jtr(Jl))
        W = scatter(L * F, torch.cat(W_idx),
                    torch.cat(W_val)).reshape(L, F, 6, nl)
        return Hpp, bp, Hll, bl, W, cost

    def eval_cost(R, t, Xw, lam):
        r, _, _, _, _ = _residuals_all(p, R, t, Xw, lam, invdepth)
        return _robust_cost(p, torch.sum(r * r, dim=-1), th2, robust)

    def solve_step(Hpp, bp, Hll, bl, W, damp):
        diagL = torch.diagonal(Hll, dim1=-2, dim2=-1)
        Hll_d = Hll + damp * eyeL * torch.clamp(torch.abs(diagL), min=1e-6)[..., None]
        diag_ok = diagL.sum(-1) > 1e-10
        Hll_g = Hll_d + (~diag_ok).to(dt)[:, None, None] * eyeL
        if nl == 1:
            Hll_inv = 1.0 / torch.where(torch.abs(Hll_g) < 1e-12,
                                        torch.full_like(Hll_g, 1e-12), Hll_g)
        else:
            Hll_inv = smallalg.inv3(Hll_g)
        Hll_inv = Hll_inv * diag_ok.to(dt)[:, None, None]

        WHinv = torch.einsum("lfin,lnm->lfim", W, Hll_inv)
        S_red = torch.einsum("lfim,lgjm->fgij", WHinv, W)
        S = Hpp - S_red
        b_red = bp - torch.einsum("lfim,lm->fi", WHinv, bl)

        Sf = S.permute(0, 2, 1, 3).reshape(F * 6, F * 6)
        diag = torch.diagonal(Sf)
        Sf = Sf + torch.diag(damp * torch.clamp(torch.abs(diag), min=1e-6))
        Sf = Sf + torch.diag(torch.repeat_interleave(1.0 - pose_w, 6))
        bf = b_red.reshape(F * 6) * torch.repeat_interleave(pose_w, 6)
        dxp = -torch.linalg.solve(Sf, bf).reshape(F, 6)
        dxp = dxp * pose_w[:, None]
        Wt_dx = torch.einsum("lfim,fi->lm", W, dxp)
        dl = torch.einsum("lnm,lm->ln", Hll_inv, -bl - Wt_dx)
        return dxp, dl * lm_w[:, None]

    def apply_step(R, t, Xw, lam, dxp, dl):
        T_new = lie.se3_boxplus_left(SE3(R, t), dxp)
        if invdepth:
            return T_new.R, T_new.t, Xw, lam + dl[:, 0]
        return T_new.R, T_new.t, Xw + dl, lam

    # one normal-equation build per iteration: a rejected trial re-solves
    # the stored best system with more damping instead of rebuilding
    params0 = (R_init, t_init, Xw_init, lam_init)
    normals = build(*params0)
    cost0 = normals[-1]
    best, best_normals, best_cost = params0, normals[:5], cost0
    damp = torch.tensor(lam0, dtype=dt, device=dev)
    dxp, dl = solve_step(*best_normals, damp)
    trial = apply_step(*best, dxp, dl)
    it = 1
    while it < max_iters:
        Hpp_t, bp_t, Hll_t, bl_t, W_t, cost_t = build(*trial)
        better = cost_t < best_cost
        best = tuple(torch.where(better, a, b) for a, b in zip(trial, best))
        best_normals = tuple(
            torch.where(better, a, b) for a, b in
            zip((Hpp_t, bp_t, Hll_t, bl_t, W_t), best_normals))
        best_cost = torch.minimum(cost_t, best_cost)
        damp = torch.clamp(torch.where(better, damp * 0.5, damp * 10.0),
                           1e-8, 1e6)
        dxp, dl = solve_step(*best_normals, damp)
        trial = apply_step(*best, dxp, dl)
        it += 1
        if bool(torch.sum(dxp * dxp) + torch.sum(dl * dl) < 1e-14):
            break
    # the final trial may beat the best-so-far; take the winner
    cost_trial = eval_cost(*trial)
    cost_best = eval_cost(*best)
    take = cost_trial < cost_best
    R_f, t_f, X_f, lam_f = (torch.where(take, a, b) for a, b in zip(trial, best))
    cost_f = torch.minimum(cost_trial, cost_best)

    # final chi2 / depth-positivity sweep (optimizer.cpp:488-627)
    r, _, _, _, pos = _residuals_all(p, R_f, t_f, X_f, lam_f, invdepth)
    chi2 = torch.sum(r * r, dim=-1)
    inl = p.obs_valid & (chi2 <= th2) & pos
    if invdepth:
        T_wa = lie.se3_inverse(SE3(R_f[p.anchor], t_f[p.anchor]))
        ilam = 1.0 / torch.where(torch.abs(lam_f) < 1e-9,
                                 torch.full_like(lam_f, 1e-9), lam_f)
        Xw_out = lie.se3_apply(T_wa, p.bearing * ilam[:, None])
    else:
        Xw_out = X_f
    return BAResult(R_f, t_f, Xw_out, lam_f, inl, cost0, cost_f, it)
