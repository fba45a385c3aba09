"""Motion-only PnP: Levenberg-Marquardt over one SE(3) pose with Huber IRLS
(port of ``ov2slam_tpu/opt/pnp.py``).

The reference's ceresPnP (multi_view_geometry.cpp:481-586): robust solve,
L2 refinement, chi2 outlier report. The solver runs a batch of S starting
poses at once (the front end's multi-start solve, a ``vmap`` in the JAX
package) against one shared set of N observations. The iteration loop is
the JAX package's fixed-trip loop with a ``done`` mask — converged starts
become masked no-ops — so it needs no host sync.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ov2slam_tpu_torch.core import lie, smallalg
from ov2slam_tpu_torch.core.lie import SE3
from ov2slam_tpu_torch.opt import residuals as res
from ov2slam_tpu_torch.opt.residuals import Calib


class PnPResult(NamedTuple):
    T_cw: SE3
    chi2: torch.Tensor       # (..., N) final squared pixel error per obs
    inliers: torch.Tensor    # (..., N) bool — chi2 <= robust th^2 & depth > 0
    n_inliers: torch.Tensor  # (...,)
    cost: torch.Tensor       # (...,) final robust cost


def _normal_eqs(calib, T, Xw, obs_px, w_valid, th2, robust: bool):
    """T batched (S,); Xw/obs_px (N, .) shared; w_valid (S, N)."""
    Tb = SE3(T.R[:, None], T.t[:, None])
    r, J, pos = res.reproj_se3(calib, Tb, Xw, obs_px)      # (S, N, ...)
    chi2 = torch.sum(r * r, dim=-1)
    w = w_valid * res.huber_weight(chi2, th2) if robust else w_valid
    Jw = J * w[..., None, None]
    rw = r * w[..., None]
    H = torch.einsum("snij,snik->sjk", Jw, Jw)
    g = torch.einsum("snij,sni->sj", Jw, rw)
    if robust:
        th = th2 ** 0.5
        rho = torch.where(chi2 <= th2, chi2, 2.0 * th * torch.sqrt(chi2) - th2)
    else:
        rho = chi2
    cost = torch.sum(rho * w_valid, dim=-1)
    return H, g, cost, r, pos


def pnp_lm_batched(calib: Calib, T_init: SE3, Xw: torch.Tensor,
                   obs_px: torch.Tensor, valid: torch.Tensor,
                   robust_th2: float = 5.9915, max_iters: int = 10,
                   robust: bool = True) -> PnPResult:
    """LM with diagonal damping for S starts: T_init (S,), valid (S, N)."""
    dt = Xw.dtype
    w_valid = valid.to(dt)
    th2 = float(torch.tensor(robust_th2, dtype=dt))     # f32 threshold
    eye6 = torch.eye(6, dtype=dt, device=Xw.device)
    S = valid.shape[0]

    H, g, cost, _, _ = _normal_eqs(calib, T_init, Xw, obs_px, w_valid, th2,
                                   robust)
    lam = torch.full((S,), 1e-3, dtype=dt, device=Xw.device)
    T = T_init
    done = torch.zeros(S, dtype=torch.bool, device=Xw.device)
    for _ in range(max_iters):
        Hd = (H + lam[:, None, None] * torch.diag_embed(
            torch.diagonal(H, dim1=-2, dim2=-1)) + 1e-10 * eye6)
        dx = -smallalg.solve_spd(Hd, g)
        T_new = lie.se3_boxplus_left(T, dx)
        H_new, g_new, cost_new, _, _ = _normal_eqs(
            calib, T_new, Xw, obs_px, w_valid, th2, robust)
        better = (cost_new < cost) & ~done
        T = SE3(torch.where(better[:, None, None], T_new.R, T.R),
                torch.where(better[:, None], T_new.t, T.t))
        H = torch.where(better[:, None, None], H_new, H)
        g = torch.where(better[:, None], g_new, g)
        lam = torch.where(done, lam, torch.clamp(
            torch.where(better, lam * 0.5, lam * 4.0), 1e-8, 1e4))
        cost = torch.where(better, cost_new, cost)
        done = done | (torch.sum(dx * dx, dim=-1) < 1e-12)

    r, _, pos = res.reproj_se3(calib, SE3(T.R[:, None], T.t[:, None]), Xw,
                               obs_px)
    chi2 = torch.sum(r * r, dim=-1)
    inl = valid & (chi2 <= th2) & pos
    return PnPResult(T, chi2, inl, torch.sum(inl, dim=-1), cost)


def pnp_robust_then_l2_batched(calib, T_init: SE3, Xw, obs_px, valid,
                               robust_th2: float = 5.9915,
                               max_iters: int = 10) -> PnPResult:
    """Huber solve, drop outliers, L2 polish on the survivors
    (apply_l2_after_robust, multi_view_geometry.cpp:560-586), per start."""
    r1 = pnp_lm_batched(calib, T_init, Xw, obs_px, valid, robust_th2,
                        max_iters, robust=True)
    return pnp_lm_batched(calib, r1.T_cw, Xw, obs_px, r1.inliers, robust_th2,
                          max_iters, robust=False)


def _single(fn, calib, T_init, Xw, obs_px, valid, *args, **kw) -> PnPResult:
    out = fn(calib, SE3(T_init.R[None], T_init.t[None]), Xw, obs_px,
             valid[None], *args, **kw)
    return PnPResult(SE3(out.T_cw.R[0], out.T_cw.t[0]), out.chi2[0],
                     out.inliers[0], out.n_inliers[0], out.cost[0])


def pnp_lm(calib: Calib, T_init: SE3, Xw, obs_px, valid,
           robust_th2: float = 5.9915, max_iters: int = 10,
           robust: bool = True) -> PnPResult:
    """Single-start LM (T_init unbatched, valid (N,))."""
    return _single(pnp_lm_batched, calib, T_init, Xw, obs_px, valid,
                   robust_th2, max_iters, robust=robust)


def pnp_robust_then_l2(calib: Calib, T_init: SE3, Xw, obs_px, valid,
                       robust_th2: float = 5.9915, max_iters: int = 10
                       ) -> PnPResult:
    """Single-start robust-then-L2 PnP (the JAX package's public form)."""
    return _single(pnp_robust_then_l2_batched, calib, T_init, Xw, obs_px,
                   valid, robust_th2, max_iters)
