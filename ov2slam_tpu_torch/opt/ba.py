"""Bundle adjustment: Schur-complement Levenberg-Marquardt or Powell dogleg,
and the structure-only solver (port of ``ov2slam_tpu/opt/ba.py``:
``solve_ba`` and ``solve_structure_only``; pose-only refinement is not
ported).

Replaces Ceres SPARSE_SCHUR + LM for the reference's local BA
(optimizer.cpp:34-897). "Pad everything, mask everything": F pose slots, L
landmark slots and O observation slots with validity masks; the normal
equations are scatter-added into dense padded blocks — pose-pose (F, F, 6,
6), landmark diagonal (L, nl, nl), pose-landmark (L, F, 6, nl) — landmarks
are eliminated with one einsum and the (6F, 6F) reduced camera system is
solved densely. Padded observations carry zero weight and in-range indices,
so they add exact zeros. The sums are ordered segment sums
(``ops/segment.py``, one index per solve): the same order in every run, on
the card and on the CPU.

Landmarks are XYZ (nl=3) or anchored inverse depth (nl=1, with Jacobians
into the anchor pose block as well — buse_inv_depth).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ov2slam_tpu_torch.core import lie, smallalg
from ov2slam_tpu_torch.core.lie import SE3
from ov2slam_tpu_torch.ops.segment import segment_index, segment_sum
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


def _th2(p: BAProblem, th2_mono: float, th2_stereo: float) -> torch.Tensor:
    """(O,) chi2 threshold of each observation (stereo for right-camera
    ones); made on the device, no host copy."""
    x = p.obs_px[:, 0]
    return torch.where(p.obs_right, torch.full_like(x, th2_stereo),
                       torch.full_like(x, th2_mono))


def _sqrtw(p: BAProblem, r: torch.Tensor, th2: torch.Tensor, robust: bool):
    """(sqrt-IRLS weight with the validity mask folded in, chi2) per
    observation (the JAX package's ``_sqrtw``)."""
    chi2 = torch.sum(r * r, dim=-1)
    sw = res.huber_weight(chi2, th2) if robust else torch.ones_like(chi2)
    return p.obs_valid.to(r.dtype) * sw, chi2


def _rho(chi2: torch.Tensor, th2: torch.Tensor, robust: bool) -> torch.Tensor:
    """Per-observation Huber (robust) or squared cost."""
    if not robust:
        return chi2
    th = torch.sqrt(th2)
    return torch.where(chi2 <= th2, chi2, 2.0 * th * torch.sqrt(chi2) - th2)


def _robust_cost(p, chi2, th2, robust: bool):
    """Total cost over the valid observations (the JAX package's ``_cost``)."""
    return torch.sum(_rho(chi2, th2, robust) * p.obs_valid.to(chi2.dtype))


def solve_ba(p: BAProblem, invdepth: bool = True, max_iters: int = 5,
             robust: bool = True, th2_mono: float = 5.9915,
             th2_stereo: float = 7.8147, lam0: float = 1e-4,
             l2_refine: bool = False, l2_iters: int = 5,
             method: str = "lm") -> BAResult:
    """Schur-complement LM, or with ``method="dogleg"`` the Powell dogleg
    trust region (the reference's use_dogleg Ceres option,
    optimizer.cpp:448-456): the same normal equations, the Gauss-Newton
    step clipped to the trust radius along the two-segment Cauchy-point ->
    GN path, the radius adapted by the gain ratio. ``l2_refine`` mirrors
    apply_l2_after_robust (optimizer.cpp:488-735): after the robust solve
    and the chi2 sweep, outliers are masked and the inliers re-solved with
    plain L2 loss."""
    if method not in ("lm", "dogleg"):
        raise ValueError(f"solve_ba: unknown method {method!r}")
    out = _lm_run(p, p.R, p.t, p.Xw, p.lam, robust, invdepth, max_iters,
                  th2_mono, th2_stereo, lam0, method)
    if l2_refine:
        p2 = p._replace(obs_valid=out.obs_inlier)
        out2 = _lm_run(p2, out.R, out.t, out.Xw, out.lam, False, invdepth,
                       l2_iters, th2_mono, th2_stereo, lam0, method)
        out = BAResult(out2.R, out2.t, out2.Xw, out2.lam,
                       out2.obs_inlier & out.obs_inlier, out.cost0, out2.cost,
                       out.n_iters + out2.n_iters)
    return out


def _lm_run(p: BAProblem, R_init, t_init, Xw_init, lam_init, robust: bool,
            invdepth: bool, max_iters: int, th2_mono: float,
            th2_stereo: float, lam0: float, method: str = "lm") -> BAResult:
    """One robust-or-L2 LM (or dogleg) run.

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
    th2 = _th2(p, th2_mono, th2_stereo)
    anc_idx = p.anchor[p.obs_lm] if invdepth else p.obs_kf
    ff = p.obs_kf * F + p.obs_kf          # flat (F*F) block index
    eyeL = torch.eye(nl, dtype=dt, device=dev)
    # the normal equations' segment indices, fixed over the solve
    hpp_idx, bp_idx = [ff], [p.obs_kf]
    W_idx = [p.obs_lm * F + p.obs_kf]
    if invdepth:
        hpp_idx += [anc_idx * F + anc_idx, p.obs_kf * F + anc_idx,
                    anc_idx * F + p.obs_kf]
        bp_idx.append(anc_idx)
        W_idx.append(p.obs_lm * F + anc_idx)
    seg_hpp = segment_index(torch.cat(hpp_idx), F * F)
    seg_bp = segment_index(torch.cat(bp_idx), F)
    seg_lm = segment_index(p.obs_lm, L)
    seg_W = segment_index(torch.cat(W_idx), L * F)

    def build(R, t, Xw, lam):
        r, J_obs, J_anc, J_lm, _ = _residuals_all(p, R, t, Xw, lam, invdepth)
        if invdepth:
            J_anc = _anchor_jacobian_fix(p, R, t, J_anc)
        w, chi2 = _sqrtw(p, r, th2, robust)
        Jo = J_obs * (w * pose_w[p.obs_kf])[:, None, None]
        Ja = J_anc * (w * pose_w[anc_idx])[:, None, None]
        Jl = J_lm * (w * lm_w[p.obs_lm])[:, None, None]
        rw = r * w[:, None]
        cost = _robust_cost(p, chi2, th2, robust)

        JtJ = lambda A, B: torch.einsum("oij,oik->ojk", A, B)  # noqa: E731
        Jtr = lambda A: torch.einsum("oij,oi->oj", A, rw)      # noqa: E731
        hpp_val = [JtJ(Jo, Jo)]
        bp_val = [Jtr(Jo)]
        W_val = [JtJ(Jo, Jl)]
        if invdepth:
            hpp_val += [JtJ(Ja, Ja), JtJ(Jo, Ja), JtJ(Ja, Jo)]
            bp_val.append(Jtr(Ja))
            W_val.append(JtJ(Ja, Jl))
        Hpp = segment_sum(seg_hpp, torch.cat(hpp_val)).reshape(F, F, 6, 6)
        bp = segment_sum(seg_bp, torch.cat(bp_val))
        Hll = segment_sum(seg_lm, JtJ(Jl, Jl))
        bl = segment_sum(seg_lm, Jtr(Jl))
        W = segment_sum(seg_W, torch.cat(W_val)).reshape(L, F, 6, nl)
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

    params0 = (R_init, t_init, Xw_init, lam_init)
    normals = build(*params0)
    cost0 = normals[-1]
    if method == "dogleg":
        R_f, t_f, X_f, lam_f, cost_f, it = _dogleg(
            params0, normals[:5], cost0, build, eval_cost, solve_step,
            apply_step, pose_w, lm_w, max_iters)
    else:
        # one normal-equation build per iteration: a rejected trial
        # re-solves the stored best system with more damping instead of
        # rebuilding
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
        R_f, t_f, X_f, lam_f = (torch.where(take, a, b)
                                for a, b in zip(trial, best))
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


def _dogleg(params0, normals0, cost0, build, eval_cost, solve_step,
            apply_step, pose_w, lm_w, max_iters: int):
    """Powell dogleg iterations from params0 (the JAX package's dl_body):
    per iteration one GN solve of the stored normal equations, the dogleg
    step inside the trust radius, one cost evaluation, and a rebuild of
    the normal equations where the trial was accepted. Exits after
    max_iters or once the step is shorter than 1e-7 (one host read per
    iteration)."""
    dt = cost0.dtype
    dev = cost0.device
    tiny = torch.tensor(1e-8, dtype=dt, device=dev)

    def step(Hpp, bp, Hll, bl, W, Delta):
        dxp_gn, dl_gn = solve_step(Hpp, bp, Hll, bl, W, tiny)
        gp = bp * pose_w[:, None]                       # J^T r (masked)
        gl = bl * lm_w[:, None]

        def H_times(vp, vl):
            return (torch.einsum("fgij,gj->fi", Hpp, vp)
                    + torch.einsum("lfim,lm->fi", W, vl),
                    torch.einsum("lnm,lm->ln", Hll, vl)
                    + torch.einsum("lfim,fi->lm", W, vp))

        gTg = torch.sum(gp * gp) + torch.sum(gl * gl)
        Hg_p, Hg_l = H_times(gp, gl)
        gTHg = torch.sum(gp * Hg_p) + torch.sum(gl * Hg_l)
        alpha = gTg / torch.clamp(gTHg, min=1e-12)
        sd_p, sd_l = -alpha * gp, -alpha * gl           # Cauchy step
        n_sd = alpha * torch.sqrt(gTg)
        n_gn = torch.sqrt(torch.sum(dxp_gn ** 2) + torch.sum(dl_gn ** 2))
        dp_p, dp_l = dxp_gn - sd_p, dl_gn - sd_l
        a2 = torch.sum(dp_p ** 2) + torch.sum(dp_l ** 2)
        ab = torch.sum(sd_p * dp_p) + torch.sum(sd_l * dp_l)
        c2 = n_sd * n_sd - Delta * Delta
        disc = torch.clamp(ab * ab - a2 * c2, min=0.0)
        beta = torch.clamp((-ab + torch.sqrt(disc)) / torch.clamp(a2, min=1e-12),
                           0.0, 1.0)
        case_gn = n_gn <= Delta
        case_sd = (~case_gn) & (n_sd >= Delta)
        s_sd = Delta / torch.clamp(n_sd, min=1e-12)
        h_p = torch.where(case_gn, dxp_gn,
                          torch.where(case_sd, s_sd * sd_p, sd_p + beta * dp_p))
        h_l = torch.where(case_gn, dl_gn,
                          torch.where(case_sd, s_sd * sd_l, sd_l + beta * dp_l))
        # predicted decrease of the (un-halved) cost: -2 (g.h + h.Hh / 2)
        Hh_p, Hh_l = H_times(h_p, h_l)
        gh = torch.sum(gp * h_p) + torch.sum(gl * h_l)
        hHh = torch.sum(h_p * Hh_p) + torch.sum(h_l * Hh_l)
        pred = -2.0 * (gh + 0.5 * hHh)
        n_h = torch.sqrt(torch.sum(h_p ** 2) + torch.sum(h_l ** 2))
        return h_p, h_l, pred, n_h

    params, normals, cost = params0, normals0, cost0
    Delta = torch.tensor(1.0, dtype=dt, device=dev)
    it = 0
    while it < max_iters:
        h_p, h_l, pred, n_h = step(*normals, Delta)
        trial = apply_step(*params, h_p, h_l)
        cost_t = eval_cost(*trial)
        rho = (cost - cost_t) / torch.clamp(pred, min=1e-12)
        accept = cost_t < cost
        Delta = torch.clamp(
            torch.where(rho > 0.75, torch.maximum(Delta, 3.0 * n_h),
                        torch.where(rho < 0.25, 0.5 * Delta, Delta)),
            1e-8, 1e8)
        params = tuple(torch.where(accept, a, b) for a, b in zip(trial, params))
        trial_normals = build(*params)
        normals = tuple(torch.where(accept, a, b)
                        for a, b in zip(trial_normals[:5], normals))
        cost = torch.minimum(cost_t, cost)
        it += 1
        if bool(n_h < 1e-7):
            break
    return params + (cost, it)


def solve_structure_only(p: BAProblem, max_iters: int = 3,
                         th2_mono: float = 5.9915, th2_stereo: float = 7.8147,
                         robust: bool = True) -> BAResult:
    """Refine landmark positions with every pose held fixed
    (Optimizer::structureOnlyBA, optimizer.cpp:2594-2782). With poses
    constant the normal equations are block-diagonal, one 3x3 block per
    landmark: batched damped Gauss-Newton with a per-landmark accept/reject
    (landmark costs are independent), no Schur complement. Landmarks are
    optimized in XYZ; inverse depths are recomputed from the fixed anchor
    poses afterwards. Landmarks with fewer than 2 valid observations stay
    as they are. A fixed number of iterations, no host read."""
    dt, dev = p.Xw.dtype, p.Xw.device
    L = p.Xw.shape[0]
    th2 = _th2(p, th2_mono, th2_stereo)
    seg = segment_index(p.obs_lm, L)
    n_obs = segment_sum(seg, p.obs_valid.to(torch.int64))
    sel = p.lm_valid & (n_obs >= 2)

    def scatter(vals):
        return segment_sum(seg, vals)

    def eqs(Xw):
        r, _, _, Jx, _ = _residuals_all(p, p.R, p.t, Xw, p.lam, False)
        w, chi2 = _sqrtw(p, r, th2, robust)
        Jw = Jx * w[:, None, None]
        rw = r * w[:, None]
        H = scatter(torch.einsum("oij,oik->ojk", Jw, Jw))
        g = scatter(torch.einsum("oij,oi->oj", Jw, rw))
        c = scatter(_rho(chi2, th2, robust) * p.obs_valid.to(dt))
        return H, g, c

    zero = torch.zeros((), dtype=dt, device=dev)
    H, g, cost_l = eqs(p.Xw)
    cost0 = torch.sum(torch.where(sel, cost_l, zero))
    damp = torch.full((L,), 1e-3, dtype=dt, device=dev)
    eye3 = torch.eye(3, dtype=dt, device=dev)
    X = p.Xw
    for _ in range(max_iters):
        dH = torch.clamp(torch.diagonal(H, dim1=-2, dim2=-1), min=1e-8)
        Hd = H + damp[:, None, None] * dH[:, :, None] * eye3 + 1e-10 * eye3
        dx = -torch.einsum("lij,lj->li", smallalg.inv3(Hd), g)
        Xn = torch.where(sel[:, None], X + dx, X)
        Hn, gn, cn = eqs(Xn)
        better = (cn < cost_l) & sel
        X = torch.where(better[:, None], Xn, X)
        H = torch.where(better[:, None, None], Hn, H)
        g = torch.where(better[:, None], gn, g)
        cost_l = torch.where(better, cn, cost_l)
        damp = torch.clamp(torch.where(better, damp * 0.5, damp * 4.0), 1e-8, 1e4)
    cost = torch.sum(torch.where(sel, cost_l, zero))

    # inverse depths in the (fixed) anchor frames
    z_anc = lie.se3_apply(SE3(p.R[p.anchor], p.t[p.anchor]), X)[..., 2]
    lam_out = torch.where(sel, 1.0 / torch.clamp(z_anc, min=1e-6), p.lam)

    # final chi2 / depth-positivity sweep (the gate of solve_ba)
    r, _, _, _, pos = _residuals_all(p, p.R, p.t, X, lam_out, False)
    inl = p.obs_valid & (torch.sum(r * r, dim=-1) <= th2) & pos
    return BAResult(p.R, p.t, X, lam_out, inl, cost0, cost, max_iters)
