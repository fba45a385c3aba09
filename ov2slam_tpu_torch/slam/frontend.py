"""Visual front end: frame-rate camera tracking (port of the slice path of
``ov2slam_tpu/slam/frontend.py``).

Replaces the reference's VisualFrontEnd (visual_front_end.cpp): pyramid
preprocessing, the constant-velocity motion model, prior-seeded
forward-backward KLT over all keypoints, multi-start robust PnP, the
rotation-compensated parallax and the keyframe-need heuristics. Ported for
``do_epipolar=False``, ``dop3p=False`` and frame-to-frame templates; the
other settings are refused by ``SlamSystem``.

State (``FEState``) is a NamedTuple of tensors on the system's device. The
per-frame step returns a new state and a (12,) stats vector, the only thing
the host reads at frame rate.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ov2slam_tpu_torch.core import camera as cam_mod
from ov2slam_tpu_torch.core import lie
from ov2slam_tpu_torch.core.camera import Camera
from ov2slam_tpu_torch.core.lie import SE3
from ov2slam_tpu_torch.ops import image as im
from ov2slam_tpu_torch.ops import klt as klt_mod
from ov2slam_tpu_torch.opt import pnp as pnp_mod
from ov2slam_tpu_torch.opt.residuals import Calib
from ov2slam_tpu_torch.slam import frame as frame_mod
from ov2slam_tpu_torch.slam.frame import FrameKps


class TrackResult(NamedTuple):
    kps: FrameKps
    T_cw_R: torch.Tensor
    T_cw_t: torch.Tensor
    pose_ok: torch.Tensor       # bool — enough PnP inliers
    n_tracked: torch.Tensor
    n_3d: torch.Tensor
    n_inliers: torch.Tensor
    parallax_med: torch.Tensor  # median rotation-compensated parallax (px)


def calib_of(cam: Camera) -> Calib:
    return Calib(cam.fx, cam.fy, cam.cx, cam.cy)


def nanmedian(x: torch.Tensor) -> torch.Tensor:
    """Median ignoring NaNs, averaging the two middle values for an even
    count (``jnp.nanmedian``; ``torch.nanmedian`` would return the lower)."""
    return torch.nanquantile(x, 0.5)


def track_frame(
    prev_pyr: Tuple[torch.Tensor, ...],
    cur_pyr: Tuple[torch.Tensor, ...],
    kps: FrameKps,
    lm_pos: torch.Tensor,       # (L, 3) landmark arena
    lm_is3d: torch.Tensor,      # (L,)
    cam: Camera,
    R_prior: torch.Tensor,      # (3, 3) motion-model world-to-cam
    t_prior: torch.Tensor,
    R_prev: torch.Tensor,
    t_prev: torch.Tensor,
    R_kf: Optional[torch.Tensor] = None,
    nklt_pyr_lvl: int = 3,
    nklt_win: int = 9,
    nmax_iter: int = 30,
    fmax_px_precision: float = 0.01,
    fmax_fbklt_dist: float = 0.5,
    klt_err: float = 30.0,
    robust_th2: float = 5.9915,
    min_pnp_inliers: int = 5,
    prev_gpyr=None,
    cur_gpyr=None,
) -> TrackResult:
    """One tracking step (the device side of visualTracking,
    visual_front_end.cpp:40-128): fused KLT, then PnP from two starts."""
    if R_kf is None:
        R_kf = R_prev
    T_prior = SE3(R_prior, t_prior)
    slot = torch.clamp(kps.lmid, 0, lm_pos.shape[0] - 1)
    Xw = lm_pos[slot]
    kp_is3d = kps.valid & kps.is3d & lm_is3d[slot] & (kps.lmid >= 0)

    # one full-pyramid KLT pass: 3D keypoints seed at their projection,
    # the rest at their previous position
    proj = cam_mod.project_cam_to_image_dist(cam, lie.se3_apply(T_prior, Xw))
    prior_ok = kp_is3d & cam_mod.in_image(cam, proj, border=nklt_win)
    prior = torch.where(prior_ok[:, None], proj, kps.px)
    st = klt_mod.fb_klt_tracking(
        prev_pyr, cur_pyr, kps.px, prior, kps.valid, nlevels=nklt_pyr_lvl,
        win=nklt_win, max_iters=nmax_iter, eps=fmax_px_precision,
        max_fb_dist=fmax_fbklt_dist, max_err=klt_err,
        prev_grad_pyr=prev_gpyr, next_grad_pyr=cur_gpyr)
    kps2 = frame_mod.update_positions(kps, cam, st.points, kps.valid & st.status)
    n_tracked = torch.sum(kps2.valid)

    # motion-only PnP on the 3D keypoints from the velocity prior and from
    # the previous pose, one batched solve; keep the most inliers, then the
    # lowest cost
    kp3d = kps2.valid & kp_is3d
    n_3d = torch.sum(kp3d)
    starts = SE3(torch.stack([R_prior, R_prev]), torch.stack([t_prior, t_prev]))
    res_all = pnp_mod.pnp_robust_then_l2_batched(
        calib_of(cam), starts, Xw, kps2.unpx, torch.stack([kp3d, kp3d]),
        robust_th2=robust_th2)
    inl = res_all.n_inliers
    is_best = inl == torch.max(inl)
    best = torch.argmin(torch.where(is_best, res_all.cost,
                                    torch.full_like(res_all.cost, float("inf"))))
    R_pnp, t_pnp = res_all.T_cw.R[best], res_all.T_cw.t[best]
    n_inl = inl[best]
    pose_ok = n_inl >= min_pnp_inliers
    R_out = torch.where(pose_ok, R_pnp, R_prior)
    t_out = torch.where(pose_ok, t_pnp, t_prior)

    # drop PnP outliers among the 3D keypoints, only when the solve succeeded
    kps2 = kps2._replace(valid=kps2.valid & torch.where(
        pose_ok & kp3d, res_all.inliers[best], torch.ones_like(kp3d)))

    # rotation-compensated median parallax vs the last keyframe
    # (visual_front_end.cpp:1064-1141)
    R_rel = R_out @ R_kf.T
    bv_rot = torch.einsum("ij,nj->ni", R_rel, kps2.kf_bv)
    rot_px = cam_mod.project_cam_to_image(cam, bv_rot)
    par = torch.linalg.norm(kps2.unpx - rot_px, dim=-1)
    par = torch.where(kps2.valid, par, torch.full_like(par, float("nan")))
    return TrackResult(
        kps=kps2, T_cw_R=R_out, T_cw_t=t_out, pose_ok=pose_ok,
        n_tracked=n_tracked, n_3d=n_3d, n_inliers=n_inl,
        parallax_med=nanmedian(par))


def preprocess(img: torch.Tensor, levels: int) -> Tuple[torch.Tensor, ...]:
    """Image -> float32 optical-flow pyramid (visual_front_end.cpp:
    1143-1177; CLAHE is not ported). The pyramid is stored in float32 — the
    JAX package stores float16 (its ``PYR_DT``)."""
    return tuple(im.build_pyramid(img.to(torch.float32), levels))


def check_new_kf(params, n_tracked: int, n_3d: int, parallax_med: float,
                 frames_since_kf: int, n3d_at_kf: int, pose_ok: bool,
                 time_since_kf: float = 0.0) -> bool:
    """Keyframe-need heuristics — the reference's rule set (checkNewKfReq,
    visual_front_end.cpp:986-1061) with local BA never running concurrently."""
    nbmax = params.nbmaxkps
    med = 0.0 if np.isnan(parallax_med) else float(parallax_med)
    nbimfromkf = frames_since_kf
    if not pose_ok:
        return n_tracked > 10 and nbimfromkf >= 2
    if n_tracked < 0.33 * nbmax and nbimfromkf >= 5:
        return True
    if n_3d < 20 and nbimfromkf >= 2:
        return True
    if n_3d > 0.5 * nbmax and nbimfromkf < 2:
        return False
    if params.stereo and time_since_kf > 1.0:
        return True
    cx = (med >= params.finit_parallax / 2.0
          or (params.stereo and nbimfromkf > 2))
    c0 = med >= params.finit_parallax
    c1 = n_3d < 0.75 * max(n3d_at_kf, 1)
    c2 = n_tracked < 0.5 * nbmax and n_3d < 0.85 * max(n3d_at_kf, 1)
    return (c0 or c1 or c2) and cx


class FEState(NamedTuple):
    pyr: Tuple[torch.Tensor, ...]       # previous frame pyramid (f32)
    gx: Tuple[torch.Tensor, ...]        # Scharr gradient pyramids of prev
    gy: Tuple[torch.Tensor, ...]
    kps: FrameKps
    R_cw: torch.Tensor                  # (3, 3) current pose
    t_cw: torch.Tensor                  # (3,)
    R_vel: torch.Tensor                 # constant-velocity relative step
    t_vel: torch.Tensor
    has_vel: torch.Tensor               # bool
    R_kf: torch.Tensor                  # rotation of the last keyframe
    # seeded generator for the RANSACs that land with doepipolar/dop3p; the
    # slice path never draws from it
    gen: torch.Generator


def _grad_pyrs(pyr):
    grads = [im.scharr_gradients(lvl) for lvl in pyr]
    return tuple(g[0] for g in grads), tuple(g[1] for g in grads)


def init_fe_state(img: torch.Tensor, kp_cap: int, levels: int,
                  seed: int = 0) -> FEState:
    """Front-end state from the first image (on img's device)."""
    dev = img.device
    pyr = preprocess(img, levels)
    gx, gy = _grad_pyrs(pyr)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    eye = torch.eye(3, dtype=torch.float32, device=dev)
    zero = torch.zeros(3, dtype=torch.float32, device=dev)
    return FEState(
        pyr=pyr, gx=gx, gy=gy, kps=FrameKps.empty(kp_cap, device=dev),
        R_cw=eye, t_cw=zero, R_vel=eye.clone(), t_vel=zero.clone(),
        has_vel=torch.tensor(False, device=dev), R_kf=eye.clone(), gen=gen)


def frame_step(state: FEState, img: torch.Tensor, lm_pos: torch.Tensor,
               lm_is3d: torch.Tensor, cam: Camera, levels: int = 3,
               nklt_win: int = 9, nmax_iter: int = 30,
               fmax_px_precision: float = 0.01, fmax_fbklt_dist: float = 0.5,
               klt_err: float = 30.0, robust_th2: float = 5.9915):
    """One frame: preprocess + motion model + track + pose + stats.

    Returns (new_state, stats) with stats a (12,) f32 tensor
    [pose_ok, n_tracked, n_3d, n_inliers, parallax_med, tx, ty, tz,
    qx, qy, qz, qw]. The input state is not modified."""
    cur_pyr = preprocess(img, levels)
    cur_gx, cur_gy = _grad_pyrs(cur_pyr)

    # motion model: T_prior = vel o T_prev (constant velocity)
    T_prev = SE3(state.R_cw, state.t_cw)
    T_pred = lie.se3_compose(SE3(state.R_vel, state.t_vel), T_prev)
    R_prior = torch.where(state.has_vel, T_pred.R, T_prev.R)
    t_prior = torch.where(state.has_vel, T_pred.t, T_prev.t)

    res = track_frame(
        state.pyr, cur_pyr, state.kps, lm_pos, lm_is3d, cam,
        R_prior, t_prior, state.R_cw, state.t_cw, R_kf=state.R_kf,
        nklt_pyr_lvl=levels, nklt_win=nklt_win, nmax_iter=nmax_iter,
        fmax_px_precision=fmax_px_precision, fmax_fbklt_dist=fmax_fbklt_dist,
        klt_err=klt_err, robust_th2=robust_th2,
        prev_gpyr=tuple(zip(state.gx, state.gy)),
        cur_gpyr=tuple(zip(cur_gx, cur_gy)))

    # velocity update: vel = T_new o T_prev^-1
    T_new = SE3(res.T_cw_R, res.T_cw_t)
    vel = lie.se3_compose(T_new, lie.se3_inverse(T_prev))
    new_state = FEState(
        pyr=cur_pyr, gx=cur_gx, gy=cur_gy, kps=res.kps,
        R_cw=res.T_cw_R, t_cw=res.T_cw_t, R_vel=vel.R, t_vel=vel.t,
        has_vel=torch.ones_like(state.has_vel), R_kf=state.R_kf, gen=state.gen)
    f32 = torch.float32
    stats = torch.cat([
        torch.stack([res.pose_ok.to(f32), res.n_tracked.to(f32),
                     res.n_3d.to(f32), res.n_inliers.to(f32),
                     res.parallax_med.to(f32)]),
        res.T_cw_t, lie.quat_from_mat(res.T_cw_R)])
    return new_state, stats
