"""Keyframe-rate mapping: detection, description, stereo matching,
triangulation (port of the slice path of ``ov2slam_tpu/slam/mapper.py``).

Replaces the reference's Mapper + the detection/stereo side of MapManager
(mapper.cpp, map_manager.cpp:286-611): on each keyframe, detect new
keypoints in free grid cells (single-scale min-eig detector), BRIEF-describe
everything, KLT-match left->right with depth / SAD-row priors and an
epipolar gate, triangulate stereo matches, and temporally triangulate
leftover 2D keypoints against their first observing keyframe. The host
assembles anchor data and commits the results into the map store.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ov2slam_tpu_torch.core import camera as cam_mod
from ov2slam_tpu_torch.core import lie
from ov2slam_tpu_torch.core.camera import Camera
from ov2slam_tpu_torch.core.lie import SE3
from ov2slam_tpu_torch.ops import describe as desc_mod
from ov2slam_tpu_torch.ops import detect as det_mod
from ov2slam_tpu_torch.ops import klt as klt_mod
from ov2slam_tpu_torch.ops import mvg
from ov2slam_tpu_torch.slam import frame as frame_mod
from ov2slam_tpu_torch.slam.frame import FrameKps
from ov2slam_tpu_torch.slam.frontend import nanmedian


class StereoMatchResult(NamedTuple):
    rpx: torch.Tensor        # (K, 2) right-image positions
    ok: torch.Tensor         # (K,) bool — tracked + epipolar-consistent
    disp: torch.Tensor       # (K,) disparity proxy (left.x - right.x)


def sad_line_prior(left_img: torch.Tensor, right_img: torch.Tensor,
                   px: torch.Tensor, win: int = 9, max_disp: int = 128):
    """Best-SAD disparity along the rectified row, batched
    (FeatureTracker::getLineMinSAD, feature_tracker.cpp:140-206).

    Returns (x_prior (N,), sad_min (N,)): the right-image x of the best
    window and its mean L1 error. Shifts that would put the window right of
    the keypoint (negative disparity) are excluded."""
    H, W = left_img.shape
    dev = left_img.device
    half = win // 2
    ix = torch.clamp(torch.round(px[:, 0]).to(torch.int64), half, W - 1 - half)
    iy = torch.clamp(torch.round(px[:, 1]).to(torch.int64), half, H - 1 - half)
    aw = torch.arange(win, device=dev)
    rows = (iy[:, None] - half + aw[None, :])[:, :, None]      # (N, win, 1)
    tmpl = left_img[rows, (ix[:, None] - half + aw[None, :])[:, None, :]]
    SW = win + max_disp
    sx = torch.clamp(ix - max_disp - half, 0, W - SW)
    strip = right_img[rows, (sx[:, None] + torch.arange(SW, device=dev))[:, None, :]]
    # (N, win, max_disp+1, win) sliding windows of the strip
    wins = strip.float().unfold(2, win, 1)
    sads = torch.mean(torch.abs(wins - tmpl.float()[:, :, None, :]), dim=(1, 3))
    centers = sx[:, None] + torch.arange(max_disp + 1, device=dev)[None, :] + half
    sads = torch.where(centers <= ix[:, None], sads,
                       torch.full_like(sads, float("inf")))
    best = torch.argmin(sads, dim=1)
    return (sx + best + half).to(torch.float32), torch.amin(sads, dim=1)


def stereo_match(left_pyr, right_pyr, kps: FrameKps, lm_pos, lm_is3d,
                 cam_l: Camera, cam_r: Camera, R_cw, t_cw, R_rl, t_rl,
                 depth_prior, nlevels: int = 3, win: int = 9,
                 max_iters: int = 30, fb_dist: float = 0.5,
                 klt_err: float = 30.0, epi_th_px: float = 2.0,
                 use_sad_prior: bool = False) -> StereoMatchResult:
    """Left->right KLT with depth-based priors + epipolar gate
    (MapManager::stereoMatching, map_manager.cpp:367-611)."""
    T_rl = SE3(R_rl, t_rl)
    T_cw = SE3(R_cw, t_cw)
    slot = torch.clamp(kps.lmid, 0, lm_pos.shape[0] - 1)
    kp3d = kps.valid & kps.is3d & lm_is3d[slot]
    Xl_3d = lie.se3_apply(T_cw, lm_pos[slot])
    Xl_guess = kps.bv * (depth_prior / torch.clamp(kps.bv[:, 2], min=1e-6))[:, None]
    Xl = torch.where(kp3d[:, None], Xl_3d, Xl_guess)
    prior = cam_mod.project_cam_to_image_dist(cam_r, lie.se3_apply(T_rl, Xl))
    prior_ok = cam_mod.in_image(cam_r, prior, border=win)
    prior = torch.where(prior_ok[:, None], prior, kps.px)
    if use_sad_prior:
        x_sad, _ = sad_line_prior(left_pyr[0], right_pyr[0], kps.px, win=win)
        sad_prior = torch.stack([x_sad, kps.px[:, 1]], dim=-1)
        prior = torch.where(kp3d[:, None], prior, sad_prior)

    res = klt_mod.fb_klt_tracking(
        left_pyr, right_pyr, kps.px, prior, kps.valid, nlevels=nlevels,
        win=win, max_iters=max_iters, eps=0.01, max_fb_dist=fb_dist,
        max_err=klt_err)

    bv_r = cam_mod.bearing_from_undist_px(cam_r, cam_mod.undistort_px(cam_r, res.points))
    E_lr = mvg.essential_from_pose(lie.se3_inverse(T_rl))   # b_l^T E b_r = 0
    focal = 0.5 * (cam_l.fx + cam_l.fy)
    epi = mvg.epipolar_line_dist(E_lr, kps.bv, bv_r) * focal
    ok = res.status & (epi < epi_th_px) & cam_mod.in_image(cam_r, res.points)
    return StereoMatchResult(rpx=res.points, ok=ok,
                             disp=kps.px[:, 0] - res.points[:, 0])


class StereoTriResult(NamedTuple):
    Xw: torch.Tensor         # (K, 3) world positions
    depth: torch.Tensor      # (K,) left-cam depth
    ok: torch.Tensor         # (K,)


def triangulate_stereo(kps: FrameKps, rpx, match_ok, cam_r: Camera, R_cw, t_cw,
                       R_rl, t_rl, max_depth: float = 200.0,
                       min_depth: float = 0.05) -> StereoTriResult:
    """Midpoint stereo triangulation with chirality + range gates
    (Mapper::triangulateStereo, mapper.cpp:346-461), output in world frame."""
    T_rl = SE3(R_rl, t_rl)
    T_lr = lie.se3_inverse(T_rl)
    T_wc = lie.se3_inverse(SE3(R_cw, t_cw))
    bv_r = cam_mod.bearing_from_undist_px(cam_r, cam_mod.undistort_px(cam_r, rpx))
    Xl = mvg.triangulate_midpoint(T_lr, kps.bv, bv_r)
    depth = Xl[:, 2]
    Xr = lie.se3_apply(T_rl, Xl)
    ok = match_ok & (depth > min_depth) & (depth < max_depth) & (Xr[:, 2] > 0)
    return StereoTriResult(Xw=lie.se3_apply(T_wc, Xl), depth=depth, ok=ok)


class TemporalTriResult(NamedTuple):
    Xw: torch.Tensor
    depth_anchor: torch.Tensor
    ok: torch.Tensor


def triangulate_temporal(kps: FrameKps, R_cw, t_cw, anc_R_cw, anc_t_cw, anc_bv,
                         anc_ok, cam: Camera, min_trans: float = 0.0,
                         max_reproj_px: float = 3.0, max_depth: float = 200.0
                         ) -> TemporalTriResult:
    """Two-view triangulation against each keypoint's first observing
    keyframe (Mapper::triangulateTemporal, mapper.cpp:191-344): chirality in
    both views and reprojection error below max_reproj_px in both views;
    stereo skips candidates with under min_trans of baseline."""
    T_cur = SE3(R_cw, t_cw)
    T_anc = SE3(anc_R_cw, anc_t_cw)
    T_ca = lie.se3_compose(T_cur, lie.se3_inverse(T_anc))   # per keypoint
    T_ac = lie.se3_inverse(T_ca)
    Xa = mvg.triangulate_midpoint(T_ac, anc_bv, kps.bv)      # anchor frame
    depth_a = Xa[:, 2]
    Xc = lie.se3_apply(T_ca, Xa)
    depth_c = Xc[:, 2]
    err_c = torch.linalg.norm(cam_mod.project_cam_to_image(cam, Xc) - kps.unpx,
                              dim=-1)
    anc_unpx = cam_mod.project_cam_to_image(cam, anc_bv)
    err_a = torch.linalg.norm(cam_mod.project_cam_to_image(cam, Xa) - anc_unpx,
                              dim=-1)
    ok = (anc_ok & kps.valid
          & (torch.linalg.norm(T_ca.t, dim=-1) >= min_trans)
          & (depth_a > 0.1) & (depth_c > 0.1) & (depth_a < max_depth)
          & (err_c < max_reproj_px) & (err_a < max_reproj_px))
    Xw = lie.se3_apply(lie.se3_inverse(T_anc), Xa)
    return TemporalTriResult(Xw=Xw, depth_anchor=depth_a, ok=ok)


class LocalMapMatchResult(NamedTuple):
    kp_slot: torch.Tensor    # (M,) int64 matched keypoint slot (-1 = none)
    ok: torch.Tensor         # (M,) bool


def match_to_local_map(kps: FrameKps, kp_desc, kp_desc_ok, kp_matchable,
                       cand_pos, cand_desc, cand_valid, cam: Camera, R_cw, t_cw,
                       max_px_dist: float = 2.0, max_desc_dist: float = 0.2,
                       ratio: float = 0.9) -> LocalMapMatchResult:
    """Match unobserved local-map landmarks to this keyframe's keypoints
    (Mapper::matchToMap, mapper.cpp:576-774): project each candidate, gate
    by pixel distance, then descriptor distance + a two-best ratio test."""
    Xc = lie.se3_apply(SE3(R_cw, t_cw), cand_pos)
    proj = cam_mod.project_cam_to_image_dist(cam, Xc)
    vis = cand_valid & (Xc[:, 2] > 0.1) & cam_mod.in_image(cam, proj)
    d_px = torch.linalg.norm(proj[:, None, :] - kps.px[None, :, :], dim=-1)
    kp_ok = kps.valid & kp_desc_ok & kp_matchable
    gate = (d_px <= max_px_dist) & kp_ok[None, :] & vis[:, None]
    d_h = desc_mod.hamming_matrix(cand_desc, kp_desc).to(torch.float32)
    BIG = 1e9
    d = torch.where(gate, d_h, torch.full_like(d_h, BIG))
    best = torch.argmin(d, dim=1)
    bestd = torch.gather(d, 1, best[:, None])[:, 0]
    d2 = d.clone()
    d2[torch.arange(d.shape[0], device=d.device), best] = BIG
    secondd = torch.amin(d2, dim=1)
    th = max_desc_dist * 256.0
    ok = vis & (bestd <= th) & (bestd <= ratio * secondd)
    return LocalMapMatchResult(
        kp_slot=torch.where(ok, best, torch.full_like(best, -1)), ok=ok)


class KFStepResult(NamedTuple):
    """Everything the host needs from one keyframe's device work."""
    kps: FrameKps            # updated keypoint table (new detections, stereo)
    desc: torch.Tensor       # (K, 8) int64 words
    desc_ok: torch.Tensor    # (K,)
    tri_ok: torch.Tensor     # (K,) stereo-triangulation success
    tri_Xw: torch.Tensor     # (K, 3)
    tri_depth: torch.Tensor  # (K,)
    med_depth: torch.Tensor  # scalar — median stereo depth (prior update)
    extra_desc: torch.Tensor  # (C, 8) place-recognition corners
    extra_ok: torch.Tensor   # (C,)
    tt_ok: torch.Tensor      # (K,) temporal triangulation
    tt_Xw: torch.Tensor      # (K, 3)
    tt_depth_anchor: torch.Tensor  # (K,)


def kf_step(left_pyr, right_pyr, kps: FrameKps, lm_pos, lm_is3d,
            cam_l: Camera, cam_r: Camera, R_cw, t_cw, R_rl, t_rl,
            quality_th: float, cand_lmids: torch.Tensor, depth_prior,
            anc_R, anc_t, anc_bv, anc_lmid, anc_ok, cellsize: int,
            nlevels: int = 3, win: int = 9, max_iters: int = 30,
            fb_dist: float = 0.5, klt_err: float = 30.0,
            epi_th_px: float = 2.0, use_sad_prior: bool = False
            ) -> KFStepResult:
    """The device side of stereo keyframe creation: grid detection ->
    keypoint insertion -> BRIEF -> stereo matching -> stereo and temporal
    triangulation. Anchor data (anc_*) is host-assembled from the previous
    keyframe record and applies only while a slot still holds anc_lmid."""
    img = left_pyr[0].to(torch.float32)
    resp = det_mod.min_eig_response(img)
    # confine detection to the camera's valid ROI (no-op for a full ROI)
    ys = torch.arange(img.shape[0], dtype=img.dtype, device=img.device)[:, None]
    xs = torch.arange(img.shape[1], dtype=img.dtype, device=img.device)[None, :]
    roi = ((xs >= cam_l.roi_x0) & (xs < cam_l.roi_x1)
           & (ys >= cam_l.roi_y0) & (ys < cam_l.roi_y1))
    resp = torch.where(roi, resp, torch.zeros_like(resp))
    det = det_mod.grid_select(resp, kps.px, kps.valid, cellsize, quality_th)
    kps2 = frame_mod.insert_keypoints(kps, cam_l, det.points, det.valid,
                                      cand_lmids)

    desc, desc_ok = desc_mod.describe_brief(img, kps2.px, kps2.valid)
    extra_desc, extra_ok = desc_mod.describe_brief(img, det.points2, det.valid2)

    sm = stereo_match(left_pyr, right_pyr, kps2, lm_pos, lm_is3d, cam_l, cam_r,
                      R_cw, t_cw, R_rl, t_rl, depth_prior, nlevels=nlevels,
                      win=win, max_iters=max_iters, fb_dist=fb_dist,
                      klt_err=klt_err, epi_th_px=epi_th_px,
                      use_sad_prior=use_sad_prior)
    tri = triangulate_stereo(kps2, sm.rpx, sm.ok, cam_r, R_cw, t_cw, R_rl, t_rl)

    good = tri.ok & kps2.valid
    med = nanmedian(torch.where(good, tri.depth,
                                torch.full_like(tri.depth, float("nan"))))
    depth_prior = torch.as_tensor(depth_prior, dtype=med.dtype, device=med.device)
    med = torch.where(torch.isfinite(med) & (torch.sum(good) > 5), med,
                      depth_prior)

    slot = torch.clamp(kps2.lmid, 0, lm_pos.shape[0] - 1)
    newly = (tri.ok & kps2.valid & (kps2.lmid >= 0)
             & ~(kps2.is3d & lm_is3d[slot]))
    unrpx = cam_mod.undistort_px(cam_r, sm.rpx)
    has_right = sm.ok & kps2.valid
    kps3 = kps2._replace(
        is3d=kps2.valid & (kps2.is3d | newly),
        rpx=torch.where(has_right[:, None], unrpx, torch.zeros_like(unrpx)),
        has_right=has_right)

    guard = (anc_ok & (kps3.lmid == anc_lmid) & kps3.valid & ~kps3.is3d
             & (kps3.lmid >= 0))
    tt = triangulate_temporal(kps3._replace(valid=guard), R_cw, t_cw, anc_R,
                              anc_t, anc_bv, guard, cam_l, min_trans=0.01)
    kps4 = kps3._replace(is3d=kps3.is3d | (tt.ok & kps3.valid))
    return KFStepResult(
        kps=kps4, desc=desc, desc_ok=desc_ok, tri_ok=tri.ok, tri_Xw=tri.Xw,
        tri_depth=tri.depth, med_depth=med, extra_desc=extra_desc,
        extra_ok=extra_ok, tt_ok=tt.ok, tt_Xw=tt.Xw,
        tt_depth_anchor=tt.depth_anchor)
