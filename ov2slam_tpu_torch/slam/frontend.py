"""Visual front end: frame-rate camera tracking (port of the slice path of
``ov2slam_tpu/slam/frontend.py``).

Replaces the reference's VisualFrontEnd (visual_front_end.cpp): pyramid
preprocessing, the constant-velocity motion model, prior-seeded
forward-backward KLT over all keypoints, multi-start robust PnP, the
rotation-compensated parallax and the keyframe-need heuristics, with the
optional CLAHE (``use_clahe``), the parallax-gated essential-matrix RANSAC
filter (``do_epipolar``) and the P3P-RANSAC PnP start (``dop3p``). KLT
templates are the previous frame's, or with ``track_from_kf``
(``btrack_keyframetoframe``) the last keyframe's pyramid at the keypoints'
keyframe positions.

State (``FEState``) is a NamedTuple of tensors on the system's device. The
per-frame step returns a new state and a (12,) stats vector, the only thing
the host reads at frame rate. With ``do_epipolar`` the host also reads the
parallax gate once per frame (the JAX package's ``lax.cond``): the RANSAC
behind it costs far more than the sync. The step runs in three parts split
at that read (``step_front``, ``step_filter``, ``step_back``), so that
``frame_chunk_step`` can replay each part as a CUDA graph on the card
(``slam/graphs.py``), the counterpart of the JAX package's ``lax.scan``.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ov2slam_tpu_torch.core import camera as cam_mod
from ov2slam_tpu_torch.core import lie
from ov2slam_tpu_torch.core.camera import Camera
from ov2slam_tpu_torch.core.lie import SE3
from ov2slam_tpu_torch.device import select
from ov2slam_tpu_torch.ops import image as im
from ov2slam_tpu_torch.ops import klt as klt_mod
from ov2slam_tpu_torch.ops import mvg
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


def ransac_hyps_of(params) -> int:
    """The reference's nransac_iter (sequential adaptive iterations) as a
    batched hypothesis count: 2x, rounded up to a power of two, floor 128
    (nransac_iter=100, every reference preset, gives 256)."""
    return max(128, 1 << (2 * max(int(params.nransac_iter), 1) - 1).bit_length())


# draw(valid (N,), n_hyps, size) -> (n_hyps, size) sample indices
Draw = Callable[[torch.Tensor, int, int], torch.Tensor]


def nanmedian(x: torch.Tensor) -> torch.Tensor:
    """Median ignoring NaNs, averaging the two middle values for an even
    count (``jnp.nanmedian``; ``torch.nanmedian`` would return the lower)."""
    return torch.nanquantile(x, 0.5)


class Tracked(NamedTuple):
    """The first part of a tracking step, up to the parallax gate."""
    kps: FrameKps               # after the KLT (the filter narrows valid)
    Xw: torch.Tensor            # (K, 3) the keypoints' landmark positions
    kp_is3d: torch.Tensor       # (K,) keypoints with a 3D landmark
    n_tracked: torch.Tensor
    prev_bv: torch.Tensor       # (K, 3) the KLT templates' bearings
    gate: Optional[torch.Tensor]  # bool: run the epipolar filter (None
                                  # without do_epipolar)


def track_klt(
    prev_pyr, cur_pyr, kps: FrameKps, lm_pos: torch.Tensor,
    lm_is3d: torch.Tensor, cam: Camera, R_prior: torch.Tensor,
    t_prior: torch.Tensor, R_prev: torch.Tensor, R_kf: torch.Tensor,
    nklt_pyr_lvl: int = 3, nklt_win: int = 9, nmax_iter: int = 30,
    fmax_px_precision: float = 0.01, fmax_fbklt_dist: float = 0.5,
    klt_err: float = 30.0, do_epipolar: bool = False,
    fransac_err: float = 3.0, prev_gpyr=None, cur_gpyr=None,
    track_from_kf: bool = False) -> Tracked:
    """The fused KLT from the motion prior and, with do_epipolar, the
    rotation-compensated parallax gate of the epipolar filter, on the
    device (see ``track_frame``)."""
    T_prior = SE3(R_prior, t_prior)
    slot = torch.clamp(kps.lmid, 0, lm_pos.shape[0] - 1)
    Xw = lm_pos[slot]
    kp_is3d = kps.valid & kps.is3d & lm_is3d[slot] & (kps.lmid >= 0)

    # one full-pyramid KLT pass: 3D keypoints seed at their projection,
    # the rest at their previous position
    proj = cam_mod.project_cam_to_image_dist(cam, lie.se3_apply(T_prior, Xw))
    prior_ok = kp_is3d & cam_mod.in_image(cam, proj, border=nklt_win)
    prior = torch.where(prior_ok[:, None], proj, kps.px)
    tmpl_px = kps.kf_px if track_from_kf else kps.px
    prev_bv = kps.kf_bv if track_from_kf else kps.bv
    st = klt_mod.fb_klt_tracking(
        prev_pyr, cur_pyr, tmpl_px, prior, kps.valid, nlevels=nklt_pyr_lvl,
        win=nklt_win, max_iters=nmax_iter, eps=fmax_px_precision,
        max_fb_dist=fmax_fbklt_dist, max_err=klt_err,
        prev_grad_pyr=prev_gpyr, next_grad_pyr=cur_gpyr)
    kps2 = frame_mod.update_positions(kps, cam, st.points, kps.valid & st.status)
    n_tracked = torch.sum(kps2.valid)

    # the epipolar 2d-2d filter (visual_front_end.cpp:446-656) runs only
    # past the rotation-compensated parallax gate: with little parallax the
    # essential matrix is degenerate and its inlier split destructive (the
    # reference skips below 2 * fransac_err px, visual_front_end.cpp:530-537)
    gate = None
    if do_epipolar:
        R_ref = R_kf if track_from_kf else R_prev
        bv_rot_p = torch.einsum("ij,nj->ni", R_prior @ R_ref.T, prev_bv)
        rot_px_p = cam_mod.project_cam_to_image(cam, bv_rot_p)
        par_p = torch.linalg.norm(kps2.unpx - rot_px_p, dim=-1)
        avg_par = torch.sum(torch.where(kps2.valid, par_p, torch.zeros_like(par_p))
                            ) / torch.clamp(n_tracked, min=1)
        gate = (n_tracked >= 16) & (avg_par > 2.0 * fransac_err)
    return Tracked(kps2, Xw, kp_is3d, n_tracked, prev_bv, gate)


def gate_open(gate: torch.Tensor) -> bool:
    """The host's read of the parallax gate: the one host sync of a
    tracking step (the JAX package's ``lax.cond`` decides on the device)."""
    return bool(gate)


def epipolar_filter(tr: Tracked, cam: Camera, idx: torch.Tensor,
                    fransac_err: float = 3.0) -> torch.Tensor:
    """The keypoints' valid mask after the essential-matrix RANSAC over the
    tracked bearings, with sample indices idx (n_hyps, 5): its inliers,
    where it succeeded and kept more than half the tracked points."""
    focal = 0.5 * (cam.fx + cam.fy)
    valid = tr.kps.valid
    eres = mvg.essential_ransac(tr.prev_bv, tr.kps.bv, valid,
                                err_th=fransac_err / focal, idx=idx)
    keep_ratio = torch.sum(eres.inliers) / torch.clamp(tr.n_tracked, min=1)
    apply = eres.success & (keep_ratio > 0.5)
    return valid & torch.where(apply, eres.inliers, valid)


def track_pose(tr: Tracked, cam: Camera, R_prior: torch.Tensor,
               t_prior: torch.Tensor, R_prev: torch.Tensor,
               t_prev: torch.Tensor, R_kf: torch.Tensor,
               fransac_err: float = 3.0, robust_th2: float = 5.9915,
               min_pnp_inliers: int = 5, n_ransac_hyps: int = 256,
               dop3p: bool = False, draw: Optional[Draw] = None
               ) -> TrackResult:
    """Motion-only PnP after the KLT (and the filter), the PnP outlier
    drop and the median parallax (see ``track_frame``)."""
    kps2, Xw, kp_is3d = tr.kps, tr.Xw, tr.kp_is3d
    focal = 0.5 * (cam.fx + cam.fy)
    # motion-only PnP on the 3D keypoints from the velocity prior, from the
    # previous pose and, with dop3p, from the P3P-RANSAC winner
    # (visual_front_end.cpp:688-740), one batched solve; keep the most
    # inliers, then the lowest cost
    kp3d = kps2.valid & kp_is3d
    n_3d = torch.sum(kp3d)
    starts_R, starts_t, masks = [R_prior, R_prev], [t_prior, t_prev], [kp3d, kp3d]
    if dop3p:
        T_p3p, p3p_inl, _, p3p_ok = mvg.p3p_ransac(
            Xw, kps2.bv, kp3d, err_th_norm=fransac_err / focal,
            idx=draw(kp3d, n_ransac_hyps, 3))
        starts_R.append(T_p3p.R)
        starts_t.append(T_p3p.t)
        masks.append(kp3d & p3p_inl)
    starts = SE3(torch.stack(starts_R), torch.stack(starts_t))
    res_all = pnp_mod.pnp_robust_then_l2_batched(
        calib_of(cam), starts, Xw, kps2.unpx, torch.stack(masks),
        robust_th2=robust_th2)
    inl = res_all.n_inliers
    if dop3p:
        inl = torch.where(torch.stack([torch.ones_like(p3p_ok),
                                       torch.ones_like(p3p_ok), p3p_ok]),
                          inl, torch.full_like(inl, -1))
    is_best = inl == torch.max(inl)
    best = torch.argmin(torch.where(is_best, res_all.cost,
                                    torch.full_like(res_all.cost, float("inf"))))
    R_pnp, t_pnp = select(res_all.T_cw.R, best), select(res_all.T_cw.t, best)
    n_inl = select(res_all.n_inliers, best)
    pose_ok = n_inl >= min_pnp_inliers
    R_out = torch.where(pose_ok, R_pnp, R_prior)
    t_out = torch.where(pose_ok, t_pnp, t_prior)

    # drop PnP outliers among the 3D keypoints, only when the solve succeeded
    kps2 = kps2._replace(valid=kps2.valid & torch.where(
        pose_ok & kp3d, select(res_all.inliers, best), torch.ones_like(kp3d)))

    # rotation-compensated median parallax vs the last keyframe
    # (visual_front_end.cpp:1064-1141)
    R_rel = R_out @ R_kf.T
    bv_rot = torch.einsum("ij,nj->ni", R_rel, kps2.kf_bv)
    rot_px = cam_mod.project_cam_to_image(cam, bv_rot)
    par = torch.linalg.norm(kps2.unpx - rot_px, dim=-1)
    par = torch.where(kps2.valid, par, torch.full_like(par, float("nan")))
    return TrackResult(
        kps=kps2, T_cw_R=R_out, T_cw_t=t_out, pose_ok=pose_ok,
        n_tracked=tr.n_tracked, n_3d=n_3d, n_inliers=n_inl,
        parallax_med=nanmedian(par))


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
    do_epipolar: bool = False,
    fransac_err: float = 3.0,
    robust_th2: float = 5.9915,
    min_pnp_inliers: int = 5,
    n_ransac_hyps: int = 256,
    dop3p: bool = False,
    draw: Optional[Draw] = None,
    prev_gpyr=None,
    cur_gpyr=None,
    track_from_kf: bool = False,
) -> TrackResult:
    """One tracking step (the device side of visualTracking/trackMono,
    visual_front_end.cpp:40-128): fused KLT, the epipolar filter, then PnP
    from two starts (three with dop3p). `draw` gives the RANSACs' sample
    indices (the epipolar filter's of size 5, the P3P start's of size 3);
    it is needed when do_epipolar or dop3p is set. The filter's samples are
    drawn only when the gate is open.

    With track_from_kf (btrack_keyframetoframe,
    visual_front_end.cpp:278-442) prev_pyr / prev_gpyr are the last
    keyframe's pyramids and the KLT templates sit at the keypoints'
    keyframe positions (kps.kf_px); the epipolar filter then relates the
    keyframe's bearings to the current ones."""
    if R_kf is None:
        R_kf = R_prev
    tr = track_klt(
        prev_pyr, cur_pyr, kps, lm_pos, lm_is3d, cam, R_prior, t_prior,
        R_prev, R_kf, nklt_pyr_lvl, nklt_win, nmax_iter, fmax_px_precision,
        fmax_fbklt_dist, klt_err, do_epipolar, fransac_err, prev_gpyr,
        cur_gpyr, track_from_kf)
    if tr.gate is not None and gate_open(tr.gate):
        valid = epipolar_filter(tr, cam, draw(tr.kps.valid, n_ransac_hyps, 5),
                                fransac_err)
        tr = tr._replace(kps=tr.kps._replace(valid=valid))
    return track_pose(tr, cam, R_prior, t_prior, R_prev, t_prev, R_kf,
                      fransac_err, robust_th2, min_pnp_inliers, n_ransac_hyps,
                      dop3p, draw)


def preprocess(img: torch.Tensor, levels: int, use_clahe: bool = False,
               clahe_clip: float = 3.0) -> Tuple[torch.Tensor, ...]:
    """Image -> (CLAHE ->) float32 optical-flow pyramid
    (visual_front_end.cpp:1143-1177). The pyramid is stored in float32; the
    JAX package stores float16 (its ``PYR_DT``)."""
    img = img.to(torch.float32)
    if use_clahe:
        img = im.clahe(img, clip_limit=clahe_clip)
    return tuple(im.build_pyramid(img, levels))


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
    # seeded generator of the epipolar filter's and the P3P start's samples
    gen: torch.Generator
    # the last keyframe's pyramids: the KLT templates of KF-to-frame
    # tracking (btrack_keyframetoframe, visual_front_end.cpp:278-442)
    kf_pyr: Optional[Tuple[torch.Tensor, ...]] = None
    kf_gx: Optional[Tuple[torch.Tensor, ...]] = None
    kf_gy: Optional[Tuple[torch.Tensor, ...]] = None


def _grad_pyrs(pyr):
    grads = [im.scharr_gradients(lvl) for lvl in pyr]
    return tuple(g[0] for g in grads), tuple(g[1] for g in grads)


def init_fe_state(img: torch.Tensor, kp_cap: int, levels: int,
                  use_clahe: bool = False, clahe_clip: float = 3.0,
                  seed: int = 0) -> FEState:
    """Front-end state from the first image (on img's device)."""
    dev = img.device
    pyr = preprocess(img, levels, use_clahe, clahe_clip)
    gx, gy = _grad_pyrs(pyr)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    eye = torch.eye(3, dtype=torch.float32, device=dev)
    zero = torch.zeros(3, dtype=torch.float32, device=dev)
    # the first frame is the first keyframe template (no step changes a
    # pyramid in place, so the state may share them)
    return FEState(
        pyr=pyr, gx=gx, gy=gy, kps=FrameKps.empty(kp_cap, device=dev),
        R_cw=eye, t_cw=zero, R_vel=eye.clone(), t_vel=zero.clone(),
        has_vel=torch.tensor(False, device=dev), R_kf=eye.clone(), gen=gen,
        kf_pyr=pyr, kf_gx=gx, kf_gy=gy)


class StepFront(NamedTuple):
    """A frame step up to the parallax gate (``step_front``)."""
    pyr: Tuple[torch.Tensor, ...]       # the frame's pyramid
    gx: Tuple[torch.Tensor, ...]
    gy: Tuple[torch.Tensor, ...]
    R_prior: torch.Tensor
    t_prior: torch.Tensor
    tracked: Tracked


def step_front(state: FEState, img: torch.Tensor, lm_pos: torch.Tensor,
               lm_is3d: torch.Tensor, cam: Camera, levels: int = 3,
               use_clahe: bool = False, clahe_clip: float = 3.0,
               nklt_win: int = 9, nmax_iter: int = 30,
               fmax_px_precision: float = 0.01, fmax_fbklt_dist: float = 0.5,
               klt_err: float = 30.0, do_epipolar: bool = False,
               fransac_err: float = 3.0, track_from_kf: bool = False,
               **_) -> StepFront:
    """Preprocess, the motion model and the KLT, up to the parallax gate
    (the first part of ``frame_step``)."""
    cur_pyr = preprocess(img, levels, use_clahe, clahe_clip)
    cur_gx, cur_gy = _grad_pyrs(cur_pyr)

    # motion model: T_prior = vel o T_prev (constant velocity)
    T_prev = SE3(state.R_cw, state.t_cw)
    T_pred = lie.se3_compose(SE3(state.R_vel, state.t_vel), T_prev)
    R_prior = torch.where(state.has_vel, T_pred.R, T_prev.R)
    t_prior = torch.where(state.has_vel, T_pred.t, T_prev.t)

    use_kf = track_from_kf and state.kf_pyr is not None
    tmpl_pyr, tmpl_gx, tmpl_gy = ((state.kf_pyr, state.kf_gx, state.kf_gy)
                                  if use_kf else (state.pyr, state.gx, state.gy))
    tr = track_klt(
        tmpl_pyr, cur_pyr, state.kps, lm_pos, lm_is3d, cam, R_prior, t_prior,
        state.R_cw, state.R_kf, nklt_pyr_lvl=levels, nklt_win=nklt_win,
        nmax_iter=nmax_iter, fmax_px_precision=fmax_px_precision,
        fmax_fbklt_dist=fmax_fbklt_dist, klt_err=klt_err,
        do_epipolar=do_epipolar, fransac_err=fransac_err,
        prev_gpyr=tuple(zip(tmpl_gx, tmpl_gy)),
        cur_gpyr=tuple(zip(cur_gx, cur_gy)), track_from_kf=use_kf)
    return StepFront(cur_pyr, cur_gx, cur_gy, R_prior, t_prior, tr)


def step_filter(front: StepFront, gen: torch.Generator, cam: Camera,
                fransac_err: float = 3.0, n_ransac_hyps: int = 256,
                **_) -> torch.Tensor:
    """The epipolar filter of an open gate: the keypoints' new valid mask,
    its samples drawn from gen."""
    valid = front.tracked.kps.valid
    return epipolar_filter(
        front.tracked, cam,
        mvg.draw_samples(valid, n_ransac_hyps, 5, gen), fransac_err)


def step_back(state: FEState, front: StepFront, cam: Camera,
              fransac_err: float = 3.0, robust_th2: float = 5.9915,
              n_ransac_hyps: int = 256, dop3p: bool = False, **_):
    """PnP, the velocity update and the stats (the last part of
    ``frame_step``): (new_state, stats)."""
    res = track_pose(
        front.tracked, cam, front.R_prior, front.t_prior, state.R_cw,
        state.t_cw, state.R_kf, fransac_err=fransac_err,
        robust_th2=robust_th2, n_ransac_hyps=n_ransac_hyps, dop3p=dop3p,
        draw=lambda v, k, s: mvg.draw_samples(v, k, s, state.gen))

    # velocity update: vel = T_new o T_prev^-1
    T_new = SE3(res.T_cw_R, res.T_cw_t)
    vel = lie.se3_compose(T_new, lie.se3_inverse(SE3(state.R_cw, state.t_cw)))
    new_state = FEState(
        pyr=front.pyr, gx=front.gx, gy=front.gy, kps=res.kps,
        R_cw=res.T_cw_R, t_cw=res.T_cw_t, R_vel=vel.R, t_vel=vel.t,
        has_vel=torch.ones_like(state.has_vel), R_kf=state.R_kf, gen=state.gen,
        kf_pyr=state.kf_pyr, kf_gx=state.kf_gx, kf_gy=state.kf_gy)
    f32 = torch.float32
    stats = torch.cat([
        torch.stack([res.pose_ok.to(f32), res.n_tracked.to(f32),
                     res.n_3d.to(f32), res.n_inliers.to(f32),
                     res.parallax_med.to(f32)]),
        res.T_cw_t, lie.quat_from_mat(res.T_cw_R)])
    return new_state, stats


def frame_step(state: FEState, img: torch.Tensor, lm_pos: torch.Tensor,
               lm_is3d: torch.Tensor, cam: Camera, levels: int = 3,
               use_clahe: bool = False, clahe_clip: float = 3.0,
               nklt_win: int = 9, nmax_iter: int = 30,
               fmax_px_precision: float = 0.01, fmax_fbklt_dist: float = 0.5,
               klt_err: float = 30.0, do_epipolar: bool = False,
               fransac_err: float = 3.0, robust_th2: float = 5.9915,
               n_ransac_hyps: int = 256, dop3p: bool = False,
               track_from_kf: bool = False):
    """One frame: preprocess + motion model + track + pose + stats. With
    track_from_kf the KLT templates are the state's keyframe pyramids.

    Returns (new_state, stats) with stats a (12,) f32 tensor
    [pose_ok, n_tracked, n_3d, n_inliers, parallax_med, tx, ty, tz,
    qx, qy, qz, qw]. The input state is not modified. The step runs in
    three parts (``step_front``, the gate's read and ``step_filter`` behind
    it, ``step_back``), which ``slam/graphs.py`` replays as CUDA graphs."""
    kw = dict(levels=levels, use_clahe=use_clahe, clahe_clip=clahe_clip,
              nklt_win=nklt_win, nmax_iter=nmax_iter,
              fmax_px_precision=fmax_px_precision,
              fmax_fbklt_dist=fmax_fbklt_dist, klt_err=klt_err,
              do_epipolar=do_epipolar, fransac_err=fransac_err,
              robust_th2=robust_th2, n_ransac_hyps=n_ransac_hyps, dop3p=dop3p,
              track_from_kf=track_from_kf)
    front = step_front(state, img, lm_pos, lm_is3d, cam, **kw)
    tr = front.tracked
    if tr.gate is not None and gate_open(tr.gate):
        valid = step_filter(front, state.gen, cam, **kw)
        front = front._replace(tracked=tr._replace(
            kps=tr.kps._replace(valid=valid)))
    return step_back(state, front, cam, **kw)


def frame_chunk_step(state: FEState, imgs_u8: torch.Tensor,
                     lm_pos: torch.Tensor, lm_is3d: torch.Tensor, cam: Camera,
                     graphs=None, **kw):
    """N consecutive frames (imgs_u8 (N, H, W) uint8) from one state, the
    counterpart of the JAX package's ``lax.scan`` over the frame step:
    returns (new_state, stats (N, 12)), each frame as ``frame_step`` tracks
    it (keyword arguments as ``frame_step``'s). On the CPU it is N calls of
    ``frame_step``; on the card the step's CUDA graphs replay once per frame
    (``slam/graphs.py``; `graphs` is the caller's ``StepGraphs`` cache, so
    that a capture serves every later chunk), and only the parallax gate is
    read back between frames."""
    if imgs_u8.device.type == "cpu":
        stats = []
        for img in imgs_u8:
            state, s = frame_step(state, img, lm_pos, lm_is3d, cam, **kw)
            stats.append(s)
        return state, torch.stack(stats)
    from ov2slam_tpu_torch.slam import graphs as graphs_mod
    if graphs is None:
        graphs = graphs_mod.StepGraphs()
    return graphs.run(state, imgs_u8, lm_pos, lm_is3d, cam, kw)
