"""Reprojection and relative-pose residuals + analytic Jacobians (port of
``ov2slam_tpu/opt/residuals.py``).

The reference's hand-written Ceres cost functions
(ceres_parametrization.cpp:107-713): mono and right-cam reprojection with
XYZ or anchored inverse-depth landmarks and the motion-only variant, all
under the left-multiplicative SE(3) update ``T' = exp(xi) T``, batched over
observations, and the pose-graph's relative-pose factor. Poses are
world-to-camera; pixels are undistorted.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ov2slam_tpu_torch.core import lie
from ov2slam_tpu_torch.core.lie import SE3


class Calib(NamedTuple):
    fx: float
    fy: float
    cx: float
    cy: float


def _inv_z(z: torch.Tensor) -> torch.Tensor:
    return 1.0 / torch.where(torch.abs(z) < 1e-9, torch.full_like(z, 1e-9), z)


def project(calib: Calib, Xc: torch.Tensor) -> torch.Tensor:
    iz = _inv_z(Xc[..., 2])
    return torch.stack([calib.fx * Xc[..., 0] * iz + calib.cx,
                        calib.fy * Xc[..., 1] * iz + calib.cy], dim=-1)


def _dproj_dXc(calib: Calib, Xc: torch.Tensor) -> torch.Tensor:
    """(..., 2, 3) Jacobian of pixel projection wrt camera-frame point."""
    x, y = Xc[..., 0], Xc[..., 1]
    iz = _inv_z(Xc[..., 2])
    iz2 = iz * iz
    zero = torch.zeros_like(x)
    row_u = torch.stack([calib.fx * iz, zero, -calib.fx * x * iz2], dim=-1)
    row_v = torch.stack([zero, calib.fy * iz, -calib.fy * y * iz2], dim=-1)
    return torch.stack([row_u, row_v], dim=-2)


def _dXc_dxi(Xc: torch.Tensor) -> torch.Tensor:
    """(..., 3, 6) for the left-mult update: dXc = [I | -hat(Xc)] xi."""
    I = torch.eye(3, dtype=Xc.dtype, device=Xc.device).expand(
        Xc.shape[:-1] + (3, 3))
    return torch.cat([I, -lie.hat(Xc)], dim=-1)


def _bcast(R: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    return R.expand(X.shape[:-1] + (3, 3))


def reproj_se3(calib: Calib, T_cw: SE3, Xw: torch.Tensor, obs_px: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Motion-only factor: residual (N, 2), J_pose (N, 2, 6), depth>0 (N,)."""
    Xc = lie.se3_apply(T_cw, Xw)
    r = project(calib, Xc) - obs_px
    J = _dproj_dXc(calib, Xc) @ _dXc_dxi(Xc)
    return r, J, Xc[..., 2] > 0


def reproj_xyz(calib: Calib, T_cw: SE3, Xw: torch.Tensor, obs_px: torch.Tensor):
    """Pose + XYZ landmark: residual, J_pose (N,2,6), J_point (N,2,3), depth>0."""
    Xc = lie.se3_apply(T_cw, Xw)
    r = project(calib, Xc) - obs_px
    dpdX = _dproj_dXc(calib, Xc)
    return (r, dpdX @ _dXc_dxi(Xc), dpdX @ _bcast(T_cw.R, Xc), Xc[..., 2] > 0)


def reproj_xyz_right(calib: Calib, T_rl: SE3, T_cw: SE3, Xw: torch.Tensor,
                     obs_px: torch.Tensor):
    """Right camera + XYZ landmark (T_rl: right-from-left, fixed)."""
    Xl = lie.se3_apply(T_cw, Xw)
    Xr = lie.se3_apply(T_rl, Xl)
    r = project(calib, Xr) - obs_px
    dpdXr = _dproj_dXc(calib, Xr)
    Rrl = _bcast(T_rl.R, Xl)
    Jp = dpdXr @ (Rrl @ _dXc_dxi(Xl))
    Jx = dpdXr @ (Rrl @ _bcast(T_cw.R, Xl))
    return r, Jp, Jx, Xr[..., 2] > 0


def reproj_anch_invdepth(calib: Calib, T_wa: SE3, T_cw: SE3, b_a: torch.Tensor,
                         lam: torch.Tensor, obs_px: torch.Tensor,
                         T_rl: SE3 = None):
    """Anchored inverse depth: Xw = T_wa (b_a / lam), observed by T_cw
    (optionally through the right camera). Returns residual (N,2),
    J_obs_pose (N,2,6), J_anchor_pose (N,2,6) (left-mult on T_wa),
    J_lam (N,2,1), depth>0 (N,)."""
    ilam = _inv_z(lam)
    Xa = b_a * ilam[..., None]
    Xw = lie.se3_apply(T_wa, Xa)
    Xl = lie.se3_apply(T_cw, Xw)
    Xc = Xl if T_rl is None else lie.se3_apply(T_rl, Xl)
    r = project(calib, Xc) - obs_px
    dpdXc = _dproj_dXc(calib, Xc)
    dpdXl = dpdXc if T_rl is None else dpdXc @ _bcast(T_rl.R, Xl)
    J_obs = dpdXl @ _dXc_dxi(Xl)
    Rcw = _bcast(T_cw.R, Xl)
    J_anc = dpdXl @ (Rcw @ _dXc_dxi(Xw))
    dXw_dlam = torch.einsum("...ij,...j->...i", T_wa.R,
                            -b_a * (ilam * ilam)[..., None])
    J_lam = dpdXl @ (Rcw @ dXw_dlam[..., None])
    return r, J_obs, J_anc, J_lam, Xc[..., 2] > 0


def huber_weight(chi2: torch.Tensor, th2) -> torch.Tensor:
    """IRLS sqrt-weight of the Huber loss with threshold sqrt(th2) on the
    squared norm chi2 (reference: Huber(sqrt(5.9915)), optimizer.cpp:270)."""
    w2 = torch.where(chi2 <= th2, torch.ones_like(chi2),
                     torch.sqrt(th2 / torch.clamp(chi2, min=1e-12)))
    return torch.sqrt(w2)


# ---------------------------------------------------------------------------
# factor: relative SE(3) pose (LeftSE3RelativePoseError,
# se3left_parametrization.hpp:76-99): r = log(T_ab_meas^-1 T_a T_b^-1) for
# world-to-cam poses.
# ---------------------------------------------------------------------------

def relpose_residual(T_a: SE3, T_b: SE3, T_ab_meas: SE3) -> torch.Tensor:
    """(..., 6) residual: log(meas^-1 (T_a T_b^-1)) for world-to-cam poses,
    meas = T_a T_b^-1 at the measurement time."""
    T_ab = lie.se3_compose(T_a, lie.se3_inverse(T_b))
    return lie.se3_log(lie.se3_compose(lie.se3_inverse(T_ab_meas), T_ab))


def se3_ad(xi: torch.Tensor) -> torch.Tensor:
    """(..., 6, 6) adjoint of the Lie algebra: ad([v, w]) = [[w^, v^], [0, w^]]."""
    W = lie.hat(xi[..., 3:])
    V = lie.hat(xi[..., :3])
    top = torch.cat([W, V], dim=-1)
    bot = torch.cat([torch.zeros_like(W), W], dim=-1)
    return torch.cat([top, bot], dim=-2)


def se3_left_jac_inv(xi: torch.Tensor) -> torch.Tensor:
    """Inverse left Jacobian of SE(3), Bernoulli series truncated at ad^2:
    J_l^-1(xi) ~ I - ad(xi)/2 + ad(xi)^2/12 (the residual itself stays
    exact)."""
    A = se3_ad(xi)
    I = torch.eye(6, dtype=xi.dtype, device=xi.device).expand(A.shape)
    return I - 0.5 * A + (1.0 / 12.0) * (A @ A)


def relpose_jacobians(T_a: SE3, T_b: SE3, T_ab_meas: SE3):
    """Closed-form 6x6 Jacobians wrt left-mult updates of T_a and T_b. With
    M = meas^-1 T_a T_b^-1 and r = log(M): Ja = Jl^-1(r) Ad(meas^-1),
    Jb = -Jl^-1(-r). Closed form on purpose: the arccos-based log has no
    usable derivative at zero residual."""
    r = relpose_residual(T_a, T_b, T_ab_meas)
    Ad_minv = lie.se3_adjoint(lie.se3_inverse(T_ab_meas))
    return r, se3_left_jac_inv(r) @ Ad_minv, -se3_left_jac_inv(-r)
