"""SlamSystem: the orchestrator wiring front end, mapper, estimator and
loop closer (port of ``ov2slam_tpu/slam/manager.py``).

Replaces the reference's SlamManager (ov2slam.cpp:33-237): calibration
setup with optional stereo rectification or undistortion, the per-frame
loop (tracking -> KF decision -> keyframe processing -> local BA -> loop
closing), the monocular bootstrap, P3P pose recovery, relocalization after
total tracking loss, and results writing with the final passes (full BA
with ``do_full_ba``; the loop-corrected full trajectory, rigid and relaxed).

Two modes, as in the JAX package. Synchronous: every frame runs to
completion before the next (one device step, one (12,) stats read,
keyframe processing inline). Pipelined (``force_realtime``, every shipped
preset): each frame's stats read is started at dispatch and finalized
``pipeline_depth`` frames later; a keyframe decided on an older frame lands
on the newest in-flight one; the keyframe commit, the local-map merge and
the local BA writeback are staged over the following frames at fixed lags
(``KF_COMMIT_LAG``, ``LMM_LAG``, ``BA_LAG`` frames, never wall-clock
adaptive, so the trajectory is deterministic); BA corrections that land
while frames are in flight are folded into their poses at finalize
(``_late_corrected``).

A loop closure drops the pending local BA (its solve predates the
correction) and folds the query keyframe's correction into the live pose
and the frames in flight; relocalization starts a new tracking chain
(``_chain_gen``), so in-flight frames of the lost chain skip their pose
write. Settings outside the ported paths (``n_devices > 1``) raise
``NotImplementedError``.
"""

from __future__ import annotations

import collections
import os
import warnings
from typing import Optional

import numpy as np
import torch

from ov2slam_tpu_torch import device as device_mod
from ov2slam_tpu_torch.config import SlamParams
from ov2slam_tpu_torch.core import camera as cam_mod
from ov2slam_tpu_torch.core.camera import Camera
from ov2slam_tpu_torch.core.lie import SE3
from ov2slam_tpu_torch.device import Fetch
from ov2slam_tpu_torch.io.profiler import Profiler
from ov2slam_tpu_torch.io.trajectories import TrajectoryLogger
from ov2slam_tpu_torch.ops import describe as desc_mod
from ov2slam_tpu_torch.ops import detect as det_mod
from ov2slam_tpu_torch.ops import image as im_mod
from ov2slam_tpu_torch.ops import mvg
from ov2slam_tpu_torch.opt import pnp as pnp_mod
from ov2slam_tpu_torch.opt import posegraph as pg_mod
from ov2slam_tpu_torch.slam import frontend as fe_mod
from ov2slam_tpu_torch.slam import graphs as graphs_mod
from ov2slam_tpu_torch.slam import mapper as mapper_mod
from ov2slam_tpu_torch.slam.estimator import Estimator
from ov2slam_tpu_torch.slam.frame import FrameKps
from ov2slam_tpu_torch.slam.loopcloser import LoopCloser
from ov2slam_tpu_torch.slam.map import KeyframeRecord, MapStore


def _mat_from_quat_np(q: np.ndarray) -> np.ndarray:
    x, y, z, w = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ], np.float32)


def unsupported_settings(p: SlamParams):
    """(setting, ROADMAP item) pairs of `p` outside the ported paths."""
    checks = [
        (p.n_devices and p.n_devices > 1, "n_devices > 1",
         "not ported: one GPU"),
    ]
    return [(name, item) for cond, name, item in checks if cond]


class SlamSystem:
    """Stereo or mono SLAM pipeline on one torch device."""

    KF_COMMIT_LAG = 4     # frames between kf_step dispatch and registry commit
    LMM_LAG = 2           # frames between local-map-match dispatch and merge
    BA_LAG = 4            # frames between BA dispatch and writeback

    def __init__(self, params: SlamParams, device=None):
        bad = unsupported_settings(params)
        if bad:
            raise NotImplementedError(
                "ov2slam_tpu_torch: not ported: "
                + "; ".join(f"{n} (ROADMAP queue {i})" for n, i in bad))
        device_mod.set_precision_policy()
        self.params = p = params
        self.device = device_mod.resolve_device(device)
        self.cam_l = Camera.make(
            p.cam_left_model, p.fxl, p.fyl, p.cxl, p.cyl,
            [p.k1l, p.k2l, p.p1l, p.p2l], p.img_left_w, p.img_left_h)
        self.cam_r = Camera.make(
            p.cam_right_model, p.fxr, p.fyr, p.cxr, p.cyr,
            [p.k1r, p.k2r, p.p1r, p.p2r], p.img_right_w, p.img_right_h)
        # T_left_right maps right-cam coords into left-cam coords; we keep
        # T_rl = right-from-left
        if p.T_left_right is not None:
            T_lr = np.asarray(p.T_left_right, np.float32)
            R_rl = T_lr[:3, :3].T
            t_rl = -(R_rl @ T_lr[:3, 3])
        else:
            R_rl, t_rl = np.eye(3, dtype=np.float32), np.zeros(3, np.float32)
        self._setup_remaps(R_rl, t_rl)

        if p.use_subspace_dogleg and not p.use_dogleg:
            warnings.warn("use_subspace_dogleg runs the plain Powell dogleg "
                          "(the two-segment path, not Ceres's 2D subspace "
                          "minimization)", stacklevel=2)
        if not p.do_klt or not p.klt_use_prior:
            warnings.warn("do_klt=0 / klt_use_prior=0 are not supported: "
                          "tracking always runs prior-seeded forward-backward "
                          "KLT; the flags are ignored", stacklevel=2)
        if p.use_nonmonotic_step:
            warnings.warn("use_nonmonotic_step is not implemented (monotone "
                          "LM only); the flag is ignored", stacklevel=2)
        if not p.use_brief:
            warnings.warn("use_brief=0 is not supported: only BRIEF-256 is "
                          "built; the flag is ignored", stacklevel=2)
        self.kp_cap = p.kp_cap
        # process-wide, as the reference's (not reset here: the timers of
        # every system in the process add up until the caller resets them)
        self.prof = Profiler.instance()
        self.prof.enabled = p.log_timings
        self.logger = TrajectoryLogger()
        # pipelined-mode stages that landed, over the system's life:
        # "kf_commit_lag" / "lmm_commit_lag" (a staged commit reached its
        # lag) and "ba_writeback" (a deferred local BA was written back)
        self.pipeline_counts = collections.Counter()
        self.reset()

    def _setup_remaps(self, R_rl: np.ndarray, t_rl: np.ndarray):
        """Rectification (``bdo_stereo_rect``) or undistortion
        (``bdo_undist``) of the incoming images, on the JAX package's exact
        conditions: the remap grids are made once on the device, the
        cameras become distortion-free with their valid ROI, and after
        rectification the extrinsic is a pure x-baseline
        (camera_calibration.cpp setUndistStereoMap / setUndistMap;
        ov2slam.cpp:66-71, :241-259). Then ``_rows_aligned``: rectified, or
        born rectified (zero distortion and a pure x-baseline), which gates
        the SAD row-search stereo prior (map_manager.cpp:439-470)."""
        p = self.params
        dev = self.device
        self.rect_maps = None
        rot = (p.T_left_right is not None and np.abs(
            np.asarray(p.T_left_right)[:3, :3] - np.eye(3)).max() > 1e-6)
        if p.bdo_stereo_rect and p.stereo and (
                np.abs([p.k1l, p.k2l, p.k1r, p.k2r]).max() > 1e-9 or rot):
            R1, R2, K_new, _ = cam_mod.stereo_rectify(
                self.cam_l, self.cam_r, R_rl, t_rl)
            g_l = cam_mod.compute_undist_rect_map(self.cam_l, R_rect=R1,
                                                  K_new=K_new, device=dev)
            g_r = cam_mod.compute_undist_rect_map(self.cam_r, R_rect=R2,
                                                  K_new=K_new, device=dev)
            self.rect_maps = (g_l, g_r)
            self.cam_l = cam_mod.with_rect_roi(cam_mod.camera_with_intrinsics(
                self.cam_l, K_new, zero_dist=True), g_l)
            self.cam_r = cam_mod.with_rect_roi(cam_mod.camera_with_intrinsics(
                self.cam_r, K_new, zero_dist=True), g_r)
            baseline = float(np.linalg.norm(t_rl))
            R_rl = np.eye(3, dtype=np.float32)
            t_rl = np.asarray([-baseline, 0.0, 0.0], np.float32)
        self._undistorted = False
        if (self.rect_maps is None and p.bdo_undist
                and np.abs([p.k1l, p.k2l, p.p1l, p.p2l,
                            p.k1r, p.k2r, p.p1r, p.p2r]).max() > 1e-12):
            cams = [self.cam_l, self.cam_r] if p.stereo else [self.cam_l]
            grids = [cam_mod.compute_undist_rect_map(c, device=dev)
                     for c in cams]
            self.rect_maps = tuple(grids)
            cams = [cam_mod.with_rect_roi(cam_mod.camera_with_intrinsics(
                c, [[c.fx, 0, c.cx], [0, c.fy, c.cy], [0, 0, 1]],
                zero_dist=True), g) for c, g in zip(cams, grids)]
            self.cam_l = cams[0]
            if p.stereo:
                self.cam_r = cams[1]
            self._undistorted = True
        self.T_rl = SE3(self._dev(R_rl), self._dev(t_rl))
        pure_baseline = (np.abs(R_rl - np.eye(3)).max() < 1e-6
                         and np.abs(np.asarray(t_rl)[1:]).max() < 1e-6)
        zero_dist = (self._undistorted
                     or np.abs([p.k1l, p.k2l, p.k1r, p.k2r]).max() < 1e-9)
        rectified = self.rect_maps is not None and not self._undistorted
        self._rows_aligned = bool(p.stereo and (
            rectified or (pure_baseline and zero_dist)))

    def _gen(self, i: int) -> torch.Generator:
        """RANSAC generator of the mono bootstrap and the P3P recovery.
        bdo_random=0 pins every draw to one seed (the reference passes
        bdo_random to OpenGV's RANSAC, multi_view_geometry.cpp:207)."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(int(i) if self.params.bdo_random else 0)
        return gen

    def _dev(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.float32), device=self.device)

    # ------------------------------------------------------------------
    def reset(self):
        """Full pipeline reset (SlamManager::reset, ov2slam.cpp:427-454)."""
        p = self.params
        self.map = MapStore(p.lm_capacity, kf_capacity=p.kf_capacity,
                            device=self.device)
        self.estimator = Estimator(p, fe_mod.calib_of(self.cam_l),
                                   fe_mod.calib_of(self.cam_r), self.T_rl,
                                   device=self.device)
        self.loopcloser = (LoopCloser(p, self.cam_l, self.estimator,
                                      device=self.device)
                           if p.buse_loop_closer else None)
        self.last_loop_event = None
        # cumulative across resets
        self.loop_events = getattr(self, "loop_events", [])
        self.fe_state: Optional[fe_mod.FEState] = None
        # the frame step's CUDA graphs (process_stereo_chunk on the card)
        self._step_graphs = graphs_mod.StepGraphs()
        self.T_cw = np.eye(4, dtype=np.float32)
        self.initialized = False
        self.frame_id = -1
        self.frames_since_kf = 0
        self.n_kps_at_kf = 0
        self.n3d_at_kf = 0
        self.kf_time = 0.0
        self.cur_kfid = -1
        self.detector_quality = p.dmaxquality
        self.median_depth = 5.0
        # pipelined mode: the in-flight frames, oldest first, each
        # (stats fetch, right image, time, _corr_cw at dispatch, chain gen)
        self._inflight = collections.deque()
        # cumulative world-frame pose correction (right factor on T_cw) of
        # every BA writeback so far; a frame finalized after a correction
        # that landed while it was in flight gets corr_at_dispatch^-1 @
        # corr_now folded into its pose (exact: world-side right factors
        # commute with the camera-side tracking increments)
        self._corr_cw = np.eye(4, dtype=np.float64)
        self._pending_ba = None
        # staged keyframe commit: registry KF_COMMIT_LAG frames after the
        # dispatch, the local-map merge LMM_LAG frames later, the BA
        # writeback BA_LAG frames after its dispatch
        self._pending_kf = None
        self._pending_lmm = None
        self._ba_age = 0
        self._lost_frames = 0
        # tracking-chain generation: bumped by relocalization, whose pose
        # jump is no right factor of the lost chain (so it cannot be folded
        # into _corr_cw); frames dispatched under an older one skip their
        # pose write at finalize
        self._chain_gen = 0
        # the newest right image, for the keyframe a relocalization forces
        self._last_imr = None

    @property
    def kps(self) -> FrameKps:
        return self.fe_state.kps

    def _set_kps(self, kps: FrameKps):
        self.fe_state = self.fe_state._replace(kps=kps)

    def _sync_pose_to_device(self):
        self.fe_state = self.fe_state._replace(
            R_cw=self._dev(self.T_cw[:3, :3]), t_cw=self._dev(self.T_cw[:3, 3]))

    def _late_corrected(self, T_cw: np.ndarray, corr) -> np.ndarray:
        """Fold the corrections that landed after this frame's dispatch into
        its stats pose: T' = T @ (corr_at_dispatch^-1 @ corr_now)."""
        if corr is None or corr is self._corr_cw:
            return T_cw
        delta = np.linalg.inv(corr) @ self._corr_cw
        if np.abs(delta - np.eye(4)).max() < 1e-12:
            return T_cw
        return (T_cw.astype(np.float64) @ delta).astype(np.float32)

    def _apply_pose_correction(self, T_old: np.ndarray, T_new: np.ndarray):
        """Apply a keyframe pose correction (BA) to the live pose as a
        relative update T_cw' = T_cw @ T_old^-1 @ T_new, on host and device
        (the live frame may have tracked past the corrected keyframe), and
        compose it into _corr_cw for the frames in flight."""
        dT = np.linalg.inv(T_old.astype(np.float64)) @ T_new.astype(np.float64)
        if np.abs(dT - np.eye(4)).max() < 1e-9:
            return
        self._corr_cw = self._corr_cw @ dT
        self.T_cw = (self.T_cw.astype(np.float64) @ dT).astype(np.float32)
        if self.fe_state is not None:
            dR = self._dev(dT[:3, :3])
            dt = self._dev(dT[:3, 3])
            st = self.fe_state
            self.fe_state = st._replace(R_cw=st.R_cw @ dR,
                                        t_cw=st.R_cw @ dt + st.t_cw)

    def T_wc(self) -> np.ndarray:
        return np.linalg.inv(self.T_cw.astype(np.float64)).astype(np.float32)

    def _upload(self, a: np.ndarray) -> torch.Tensor:
        """Host array -> this system's device; on the card staged through
        pinned memory, so the copy is asynchronous."""
        t = torch.from_numpy(np.ascontiguousarray(a))
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t

    def _to_device_u8(self, img) -> torch.Tensor:
        """Image (host float/uint8, or a rectified frame already on the
        device) -> device uint8. Device floats saturate to [0, 255] as the
        JAX package's conversion does."""
        if isinstance(img, torch.Tensor):
            if img.dtype == torch.uint8:
                return img.to(self.device)
            return torch.clamp(img.to(self.device), 0.0, 255.0).to(torch.uint8)
        return self._upload(np.asarray(img).astype(np.uint8))

    def _rectify(self, img, cam_idx: int) -> torch.Tensor:
        """Remap one incoming image with its precomputed grid, bicubic (the
        JAX package's deliberate upgrade over the reference's INTER_LINEAR
        remap, camera_calibration.cpp:238), and keep it on the device."""
        src = (img.to(self.device, torch.float32) if isinstance(img, torch.Tensor)
               else self._upload(np.asarray(img, np.float32)))
        return im_mod.remap_bicubic(src, self.rect_maps[cam_idx])

    # ------------------------------------------------------------------
    def process_stereo(self, iml: np.ndarray, imr: np.ndarray, time: float
                       ) -> np.ndarray:
        """One stereo frame in, camera-to-world pose out (the per-frame body
        of SlamManager::run, ov2slam.cpp:116-237). In the pipelined mode the
        pose returned is the newest finalized one."""
        p = self.params
        self.frame_id += 1
        if self.rect_maps is not None:
            iml = self._rectify(iml, 0)
            imr = self._rectify(imr, 1)
        self._last_imr = imr
        img = self._to_device_u8(iml)
        with self.prof.scope("0.Full-Front_End"):
            if self.fe_state is None:
                self.fe_state = self._init_fe_state(img)
                self._initialize_stereo(imr, time)
                self._log_pose(time, True)
                return self.T_wc()
            stats = self._frame_step(img)
        if p.force_realtime and self.initialized:
            self._enqueue(stats, imr, time, self._finalize_frame)
            return self.T_wc()
        self._finalize_frame(stats.cpu().numpy(), imr, time)
        return self.T_wc()

    def _enqueue(self, stats: torch.Tensor, imr, time, finalize):
        """Pipelined mode: start the frame's stats fetch, finalize the
        frames older than pipeline_depth, advance the staged KF commit by
        at most one stage."""
        self._inflight.append((Fetch(stats), imr, time, self._corr_cw,
                               self._chain_gen))
        while len(self._inflight) > max(1, self.params.pipeline_depth):
            finalize(*self._inflight.popleft())
        self._advance_kf_pipeline()

    def _init_fe_state(self, img: torch.Tensor) -> fe_mod.FEState:
        p = self.params
        return fe_mod.init_fe_state(img, self.kp_cap, p.nklt_pyr_lvl,
                                    p.use_clahe, p.fclahe_val)

    def _step_kwargs(self) -> dict:
        """The frame step's settings (``frontend.frame_step`` keywords)."""
        p = self.params
        return dict(
            levels=p.nklt_pyr_lvl, use_clahe=bool(p.use_clahe),
            clahe_clip=p.fclahe_val, nklt_win=p.nklt_win_size,
            nmax_iter=p.nmax_iter, fmax_px_precision=p.fmax_px_precision,
            fmax_fbklt_dist=p.fmax_fbklt_dist, klt_err=p.nklt_err,
            do_epipolar=bool(p.doepipolar), fransac_err=p.fransac_err,
            robust_th2=p.robust_mono_th,
            n_ransac_hyps=fe_mod.ransac_hyps_of(p), dop3p=bool(p.dop3p),
            track_from_kf=bool(p.btrack_keyframetoframe))

    def _frame_step(self, img: torch.Tensor) -> torch.Tensor:
        """The front end's per-frame device step; returns its (12,) stats
        vector, still on the device."""
        lm_pos, lm_is3d = self.map.device_landmarks()
        self.fe_state, stats = fe_mod.frame_step(
            self.fe_state, img, lm_pos, lm_is3d, self.cam_l,
            **self._step_kwargs())
        return stats

    def process_stereo_chunk(self, frames) -> np.ndarray:
        """Throughput mode: track a list of (iml, imr, time) stereo frames
        in one front-end call (``frontend.frame_chunk_step``: on the card
        CUDA-graph replays of the frame step, with only the parallax gate
        read between frames) and read the chunk's stats once. Keyframe
        decisions quantize to the chunk's end: a keyframe only on its last
        frame, committed at once. The JAX package's semantics
        (``manager.py:517-584``): no late corrections, P3P recovery or
        relocalization inside a chunk. Until the map is initialized, and
        for fewer than 2 frames, the frames go through ``process_stereo``.
        Returns the camera-to-world pose of the last frame."""
        p = self.params
        if not self.initialized or len(frames) < 2:
            T = None
            for iml, imr, t in frames:
                T = self.process_stereo(iml, imr, t)
            return T
        # finalize anything pending from single-frame mode
        self.flush()
        self.frame_id += len(frames)
        if self.rect_maps is not None:
            imgs = [self._to_device_u8(self._rectify(f[0], 0)) for f in frames]
            # the right image is read only at a keyframe, on the last frame:
            # rectify that one, so stereo matching sees the per-frame path's
            # geometry
            imr_last = self._rectify(frames[-1][1], 1)
        else:
            imgs = [self._to_device_u8(f[0]) for f in frames]
            imr_last = frames[-1][1]
        self._last_imr = imr_last
        lm_pos, lm_is3d = self.map.device_landmarks()
        with self.prof.scope("0.Full-Front_End"):
            self.fe_state, stats = fe_mod.frame_chunk_step(
                self.fe_state, torch.stack(imgs), lm_pos, lm_is3d, self.cam_l,
                graphs=self._step_graphs, **self._step_kwargs())
            stats_np = stats.cpu().numpy()             # (N, 12)

        need_kf = False
        for j, (_, _, t) in enumerate(frames):
            row = stats_np[j]
            pose_ok = row[0] > 0.5
            if pose_ok:
                self.T_cw = self._pose_from_stats(row)
            # the keyframe heuristics on the pre-increment counter, as the
            # per-frame path decides before it counts the frame
            need_kf = need_kf or fe_mod.check_new_kf(
                p, int(row[1]), int(row[2]), float(row[4]),
                self.frames_since_kf, self.n3d_at_kf, pose_ok,
                time_since_kf=t - self.kf_time)
            is_kf = j == len(frames) - 1 and need_kf
            if is_kf:
                with self.prof.scope("1.KF_Processing"):
                    self._create_keyframe(imr_last, t, defer=False)
            else:
                self.frames_since_kf += 1
            self._log_pose(t, is_kf)
        return self.T_wc()

    @staticmethod
    def _stats_np(stats) -> np.ndarray:
        return stats.result()[0] if isinstance(stats, Fetch) else stats

    def _pose_from_stats(self, stats_np: np.ndarray) -> np.ndarray:
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = _mat_from_quat_np(stats_np[8:12])
        T[:3, 3] = stats_np[5:8]
        return T

    def _log_pose(self, time, is_kf: bool):
        T_wkf = None
        if self.cur_kfid in self.map.keyframes:
            T_wkf = np.linalg.inv(self.map.keyframes[self.cur_kfid].T_cw)
        elif (self._pending_kf is not None
              and self._pending_kf["kfid"] == self.cur_kfid):
            # a frame finalized inside the commit lag logs its pose relative
            # to the pending keyframe's snapshot pose
            T_wkf = np.linalg.inv(self._pending_kf["T_cw"].astype(np.float64))
        self.logger.add(time, self.T_wc(), is_kf, self.cur_kfid, T_wkf)

    def _finalize_frame(self, stats, imr, time, corr=None, gen=None,
                        allow_kf: bool = True, force_kf: bool = False):
        """Read the stats vector (fetched now or at dispatch), update the
        pose (with the corrections since dispatch folded in) and the log,
        decide and run keyframe processing. A keyframe decided while newer
        frames are in flight lands on the newest of them (the reference
        under realtime load tracks only the newest frame,
        ov2slam.cpp:291-298)."""
        p = self.params
        stats_np = self._stats_np(stats)
        if gen is not None and gen != self._chain_gen:
            self._log_pose(time, False)
            self.frames_since_kf += 1
            return
        pose_ok = stats_np[0] > 0.5
        n_tracked = int(stats_np[1])
        n_3d = int(stats_np[2])
        parallax = float(stats_np[4])
        if pose_ok:
            self.T_cw = self._late_corrected(self._pose_from_stats(stats_np),
                                             corr)
        elif n_3d >= 10 and self.initialized:
            # P3P-RANSAC recovery when the prior-seeded PnP failed
            # (p3pRansac path, visual_front_end.cpp:659-851)
            pose_ok = self._try_p3p_recovery()
        pose_ok = self._track_loss(pose_ok, self.initialized, time)
        need_kf = allow_kf and fe_mod.check_new_kf(
            p, n_tracked, n_3d, parallax, self.frames_since_kf,
            self.n3d_at_kf, pose_ok, time_since_kf=time - self.kf_time)
        if need_kf and self._inflight:
            self.frames_since_kf += 1
            self._log_pose(time, False)
            while len(self._inflight) > 1:
                self._finalize_frame(*self._inflight.popleft(), allow_kf=False)
            self._finalize_frame(*self._inflight.popleft(), allow_kf=False,
                                 force_kf=True)
            return
        if need_kf or force_kf:
            with self.prof.scope("1.KF_Processing"):
                self._create_keyframe(imr, time)
        else:
            self.frames_since_kf += 1
        self._log_pose(time, need_kf or force_kf)

    def _initialize_stereo(self, imr, time):
        """First keyframe: detect + stereo triangulate."""
        self._create_keyframe(imr, time, run_ba=False)
        if self.map.n_3d() > 20:
            self.initialized = True

    def flush(self):
        """Finalize every in-flight frame, staged KF commit and pending BA
        (pipelined mode)."""
        fin = self._finalize_mono if self.params.mono else self._finalize_frame
        while self._inflight:
            fin(*self._inflight.popleft())
        self._drain_kf_pipeline()
        self._finalize_pending_ba()

    def _finalize_pending_ba(self):
        if self._pending_ba is None:
            return
        pend, self._pending_ba = self._pending_ba, None
        # the BA correction of its newest KF moves the live pose as a
        # relative update (the live frame has tracked on since the solve)
        kf_list = pend[0]
        rec = self.map.keyframes.get(kf_list[0]) if kf_list else None
        T_old = rec.T_cw.copy() if rec is not None else None
        self.estimator.finalize_local_ba(self.map, pend)
        self.pipeline_counts["ba_writeback"] += 1
        if rec is not None:
            self._apply_pose_correction(T_old, rec.T_cw)
        self._refresh_kp_3d_flags()

    def _track_loss(self, pose_ok: bool, initialized: bool, time) -> bool:
        """Count the lost frames in a row; from the third, with a loop
        closer and an initialized map, try to relocalize. Returns whether
        the frame has a pose."""
        if pose_ok:
            self._lost_frames = 0
            return True
        self._lost_frames += 1
        if (self._lost_frames >= 3 and initialized
                and self.loopcloser is not None and self._try_relocalize(time)):
            self._lost_frames = 0
            return True
        return False

    def _try_relocalize(self, time: float) -> bool:
        """Query the place index with the lost frame (fresh corners and
        descriptors of its level-0 image), verify with P3P + PnP, reset the
        pose and the velocity, start a new tracking chain, and rebuild the
        keypoint table from a forced keyframe (with the frame's timestamp);
        local-map matching then re-associates landmarks."""
        p = self.params
        d = self.device
        img = self.fe_state.pyr[0]
        det = det_mod.grid_select(
            det_mod.min_eig_response(img), torch.zeros((8, 2), device=d),
            torch.zeros(8, dtype=torch.bool, device=d), p.nmaxdist,
            float(np.float32(1e-4)))
        desc, ok = desc_mod.describe_brief(img, det.points, det.valid)
        unpx = cam_mod.undistort_px(self.cam_l, det.points)
        bv = cam_mod.bearing_from_undist_px(self.cam_l, unpx)
        desc_np, ok_np, unpx_np, bv_np = Fetch(desc, ok, unpx, bv).result()
        res = self.loopcloser.relocalize(
            self.map, desc_np.astype(np.uint32), ok_np, bv_np, unpx_np)
        if res is None:
            return False
        self.T_cw = res[0]
        # frames in flight from the lost chain bear no relation to the
        # relocalized pose
        self._chain_gen += 1
        self._sync_pose_to_device()
        self.fe_state = self.fe_state._replace(
            R_vel=torch.eye(3, device=d), t_vel=torch.zeros(3, device=d))
        self._set_kps(FrameKps.empty(self.kp_cap, device=d))
        self._create_keyframe(
            self._last_imr, time, run_ba=False,
            stereo=bool(p.stereo) and self._last_imr is not None, defer=False)
        return True

    # ------------------------------------------------------------------
    def _try_p3p_recovery(self) -> bool:
        """Pose recovery via P3P-RANSAC + robust PnP against the current 3D
        keypoints when the prior-seeded PnP failed."""
        lm_pos, lm_is3d = self.map.device_landmarks()
        kps = self.kps
        slot = torch.clamp(kps.lmid, 0, self.map.cap - 1)
        mask = kps.valid & kps.is3d & lm_is3d[slot] & (kps.lmid >= 0)
        Xw = lm_pos[slot]
        focal = 0.5 * (self.cam_l.fx + self.cam_l.fy)
        T_est, inl, _, okflag = mvg.p3p_ransac(
            Xw, kps.bv, mask, err_th_norm=self.params.fransac_err / focal,
            idx=mvg.draw_samples(mask, 512, 3, self._gen(self.frame_id)))
        pnp = pnp_mod.pnp_robust_then_l2(
            fe_mod.calib_of(self.cam_l), T_est, Xw, kps.unpx, inl,
            robust_th2=self.params.robust_mono_th)
        ok, R_np, t_np, n_inl = (a.cpu().numpy() for a in (
            okflag, pnp.T_cw.R, pnp.T_cw.t, pnp.n_inliers))
        if not bool(ok) or int(n_inl) < 5:
            return False
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = R_np
        T[:3, 3] = t_np
        self.T_cw = T
        self._sync_pose_to_device()
        return True

    # ------------------------------------------------------------------
    def process_mono(self, im: np.ndarray, time: float) -> np.ndarray:
        """One monocular frame in, camera-to-world pose out (trackMono +
        mono init, visual_front_end.cpp:65-128, :855-984): 2D KLT tracking
        until the parallax since the first keyframe exceeds finit_parallax,
        then the essential-matrix bootstrap at the arbitrary scale 0.25,
        temporal triangulation, and PnP tracking thereafter. Pipelined
        (force_realtime) once initialized, like process_stereo."""
        p = self.params
        self.frame_id += 1
        if self.rect_maps is not None:        # bdo_undist
            im = self._rectify(im, 0)
        img = self._to_device_u8(im)
        with self.prof.scope("0.Full-Front_End"):
            if self.fe_state is None:
                self.fe_state = self._init_fe_state(img)
                self._create_keyframe(None, time, run_ba=False, stereo=False)
                self.logger.add(time, self.T_wc(), True, self.cur_kfid, None)
                return self.T_wc()
            stats = self._frame_step(img)

        if p.force_realtime and self.initialized:
            self._enqueue(stats, None, time, self._finalize_mono)
            return self.T_wc()
        stats_np = stats.cpu().numpy()
        if self.initialized:
            self._finalize_mono(stats_np, None, time)
            return self.T_wc()
        if stats_np[0] > 0.5:
            self.T_cw = self._pose_from_stats(stats_np)
        # tracking loss before init resets (the reference's absolute
        # threshold, nb2dkps_ < 50, visual_front_end.cpp:99-101)
        if int(stats_np[1]) < 50:
            self.reset()
            self.logger.add(time, np.eye(4, dtype=np.float32), False, -1, None)
            return np.eye(4, dtype=np.float32)
        if float(stats_np[4]) > p.finit_parallax:
            self._try_mono_init(time)
        # as the JAX package: counted and logged as a non-keyframe even when
        # the bootstrap created a keyframe or reset
        self.frames_since_kf += 1
        self._log_pose(time, False)
        return self.T_wc()

    def _finalize_mono(self, stats, _imr, time, corr=None, gen=None,
                       allow_kf: bool = True, force_kf: bool = False):
        """Initialized mono frame: pose (or P3P recovery), keyframe decision
        and processing (mirrors _finalize_frame; in the pipelined mode the
        keyframe lands on the newest in-flight frame, and mono keyframes
        commit inline, as in the JAX package)."""
        stats_np = self._stats_np(stats)
        if gen is not None and gen != self._chain_gen:
            self._log_pose(time, False)
            self.frames_since_kf += 1
            return
        pose_ok = stats_np[0] > 0.5
        n_tracked, n_3d = int(stats_np[1]), int(stats_np[2])
        if pose_ok:
            self.T_cw = self._late_corrected(self._pose_from_stats(stats_np),
                                             corr)
        elif n_3d >= 10:
            # trackMono shares computePose's P3P recovery
            # (visual_front_end.cpp:659-851)
            pose_ok = self._try_p3p_recovery()
        pose_ok = self._track_loss(pose_ok, True, time)
        need_kf = allow_kf and fe_mod.check_new_kf(
            self.params, n_tracked, n_3d, float(stats_np[4]),
            self.frames_since_kf, self.n3d_at_kf, pose_ok,
            time_since_kf=time - self.kf_time)
        if need_kf and self._inflight:
            self.frames_since_kf += 1
            self._log_pose(time, False)
            while len(self._inflight) > 1:
                self._finalize_mono(*self._inflight.popleft(), allow_kf=False)
            self._finalize_mono(*self._inflight.popleft(), allow_kf=False,
                                force_kf=True)
            return
        if need_kf or force_kf:
            with self.prof.scope("1.KF_Processing"):
                self._create_keyframe(None, time, stereo=False, defer=False)
        else:
            self.frames_since_kf += 1
        self._log_pose(time, need_kf or force_kf)

    def _try_mono_init(self, time) -> bool:
        """Essential-matrix bootstrap against the first keyframe at the
        arbitrary scale 0.25 (visual_front_end.cpp:855-984)."""
        m = self.map
        kf0 = m.keyframes.get(self.cur_kfid)
        if kf0 is None:
            return False
        kp_lmid, kp_valid, kp_bv = (a.cpu().numpy() for a in (
            self.kps.lmid, self.kps.valid, self.kps.bv))
        K = self.kp_cap
        bv0 = np.zeros((K, 3), np.float32)
        bv0[:, 2] = 1.0
        ok = np.zeros(K, bool)
        for s in np.nonzero(kp_valid & (kp_lmid >= 0))[0]:
            slot0 = kf0.kp_slot_of(int(kp_lmid[s]))
            if slot0 >= 0:
                bv0[s] = kf0.bv[slot0]
                ok[s] = True
        if ok.sum() < 30:
            return False
        bv0_d, bv_d = self._dev(bv0), self._dev(kp_bv)
        ok_d = torch.from_numpy(ok).to(self.device)
        focal = 0.5 * (self.cam_l.fx + self.cam_l.fy)
        res = mvg.essential_ransac(
            bv0_d, bv_d, ok_d, err_th=self.params.fransac_err / focal,
            idx=mvg.draw_samples(ok_d, 512, 5, self._gen(self.frame_id)))
        T_rel = mvg.decompose_essential(res.model, bv0_d, bv_d, res.inliers)
        success, n_in, R_wc, t_wc = (a.cpu().numpy() for a in (
            res.success, res.n_inliers, T_rel.R, T_rel.t))
        if not bool(success) or int(n_in) < 0.5 * ok.sum():
            return False
        # T_rel: current camera in KF0's frame with |t| = 1; scale 0.25,
        # then chain through KF0's own world pose
        T_wc = np.eye(4, dtype=np.float32)
        T_wc[:3, :3] = R_wc
        T_wc[:3, 3] = t_wc * 0.25
        self.T_cw = (np.linalg.inv(T_wc.astype(np.float64))
                     @ kf0.T_cw.astype(np.float64)).astype(np.float32)
        self._sync_pose_to_device()
        # KF + temporal triangulation against KF0 gives the initial map
        self._create_keyframe(None, time, run_ba=False, stereo=False)
        if m.n_3d() > 30:
            self.initialized = True
            return True
        # bad init -> full reset (mapper.cpp:129-144)
        self.reset()
        return False

    # ------------------------------------------------------------------
    # Keyframe creation: the device step now; the host commit inline, or in
    # the pipelined mode staged over the following frames (the reference's
    # Mapper / Estimator threads run beside tracking, mapper.cpp:44-170,
    # estimator.cpp:32-98).
    # ------------------------------------------------------------------
    def _create_keyframe(self, imr, time, run_ba: bool = True,
                         stereo: bool = True, defer: Optional[bool] = None):
        """The device step (detect -> insert -> describe -> stereo match ->
        triangulate; mono: temporal triangulation only), the tracking state
        re-anchored to the keyframe, and the host commit (deferred when
        `defer`, by default in the pipelined mode once initialized)."""
        p = self.params
        if defer is None:
            defer = bool(p.force_realtime and self.initialized)
        # the previous keyframe must be committed before this one allocates
        # candidates and assembles anchors
        self._drain_kf_pipeline()
        kfid = self.map.next_kf_id
        prev_kfid = self.cur_kfid
        self.cur_kfid = kfid
        with self.prof.scope("2.KF_DeviceStep"):
            n_cells = ((self.cam_l.height // p.nmaxdist)
                       * (self.cam_l.width // p.nmaxdist))
            cand_ids = self.map.alloc_landmarks(n_cells)
            anc = self._assemble_anchor_data(prev_kfid)
            # detector choice of map_manager.cpp:300-322
            detector = ("gftt" if p.use_shi_tomasi
                        else "fast" if p.use_fast else "singlescale")
            right_pyr = (fe_mod.preprocess(self._to_device_u8(imr),
                                           p.nklt_pyr_lvl, p.use_clahe,
                                           p.fclahe_val)
                         if stereo else self.fe_state.pyr)
            lm_pos, lm_is3d = self.map.device_landmarks()
            d = self.device
            quality = (float(p.nfast_th) if detector == "fast"
                       else self.detector_quality)
            res = mapper_mod.kf_step(
                self.fe_state.pyr, right_pyr, self.kps, lm_pos, lm_is3d,
                self.cam_l, self.cam_r, self._dev(self.T_cw[:3, :3]),
                self._dev(self.T_cw[:3, 3]), self.T_rl.R, self.T_rl.t,
                float(np.float32(quality)),
                torch.from_numpy(cand_ids.astype(np.int64)).to(d),
                float(np.float32(self.median_depth)),
                self._dev(anc[0]), self._dev(anc[1]), self._dev(anc[2]),
                torch.from_numpy(anc[3].astype(np.int64)).to(d),
                torch.from_numpy(anc[4]).to(d), cellsize=p.nmaxdist,
                detector=detector, fast_th=p.nfast_th,
                nlevels=p.nklt_pyr_lvl, win=p.nklt_win_size,
                max_iters=p.nmax_iter, fb_dist=p.fmax_fbklt_dist,
                klt_err=p.nklt_err, epi_th_px=p.fepi_th,
                use_sad_prior=self._rows_aligned, stereo=stereo)
            self._set_kps(res.kps)
            kp = res.kps
            fetch = Fetch(
                kp.px, kp.unpx, kp.bv, kp.lmid, kp.valid, kp.is3d, kp.rpx,
                kp.has_right, res.desc, res.desc_ok, res.tri_ok, res.tri_Xw,
                res.tri_depth, res.med_depth, res.extra_desc, res.extra_ok,
                res.tt_ok, res.tt_Xw, res.tt_depth_anchor)

        # what tracking needs at once: the parallax reference and (with
        # btrack_keyframetoframe) the KLT templates re-anchor to this
        # keyframe, the pose syncs
        self._set_kps(self.kps._replace(kf_bv=self.kps.bv.clone(),
                                        kf_px=self.kps.px.clone()))
        upd = dict(R_kf=self._dev(self.T_cw[:3, :3]))
        if p.btrack_keyframetoframe:
            # the keyframe's pyramids become the templates (no step changes
            # a pyramid in place, so they are shared, not copied)
            st = self.fe_state
            upd.update(kf_pyr=st.pyr, kf_gx=st.gx, kf_gy=st.gy)
        self.fe_state = self.fe_state._replace(**upd)
        self._sync_pose_to_device()
        self.frames_since_kf = 0
        self.kf_time = time
        pending = dict(kfid=kfid, time=time, T_cw=self.T_cw.copy(),
                       fetch=fetch, cand_ids=cand_ids, anc=anc,
                       n_cells=n_cells, desc_dev=res.desc,
                       desc_ok_dev=res.desc_ok, stereo=stereo, run_ba=run_ba,
                       defer=defer, age=0)
        if defer:
            self._pending_kf = pending
        else:
            self._commit_kf(pending)
            self._drain_kf_pipeline()

    def _advance_kf_pipeline(self):
        """Advance at most one staged step per frame. Lags are fixed frame
        counts, never wall-clock adaptive, so the trajectory does not depend
        on transfer timing."""
        if self._pending_kf is not None:
            self._pending_kf["age"] += 1
            if self._pending_kf["age"] >= self.KF_COMMIT_LAG:
                pend, self._pending_kf = self._pending_kf, None
                self.pipeline_counts["kf_commit_lag"] += 1
                with self.prof.scope("2.KF_Registry"):
                    self._commit_kf(pend)
            return
        if self._pending_lmm is not None:
            self._pending_lmm["age"] += 1
            if self._pending_lmm["age"] >= self.LMM_LAG:
                pend, self._pending_lmm = self._pending_lmm, None
                self.pipeline_counts["lmm_commit_lag"] += 1
                with self.prof.scope("2.KF_MatchLocalMap"):
                    self._commit_lmm(pend)
            return
        if self._pending_ba is not None:
            self._ba_age += 1
            if self._ba_age >= self.BA_LAG:
                with self.prof.scope("1.BA_localBA"):
                    self._finalize_pending_ba()

    def _drain_kf_pipeline(self):
        if self._pending_kf is not None:
            pend, self._pending_kf = self._pending_kf, None
            self._commit_kf(pend)
        if self._pending_lmm is not None:
            pend, self._pending_lmm = self._pending_lmm, None
            self._commit_lmm(pend)

    # ------------------------------------------------------------------
    def _commit_kf(self, pending):
        """Host-side keyframe commit: registry updates from the fetched
        bundle, the keyframe record, and the local-map match dispatch."""
        p = self.params
        kfid = pending["kfid"]
        cand_ids = pending["cand_ids"]
        anc = pending["anc"]
        with self.prof.scope("2.KF_Registry_fetch"):
            (k_px, k_unpx, k_bv, k_lmid, k_valid, k_is3d, k_rpx, k_hr,
             desc_np, desc_ok_np, tri_ok, Xw_np, depth_np, med_depth,
             xdesc_np, xok_np, tt_ok, tt_Xw, tt_da) = pending["fetch"].result()
        k_lmid = k_lmid.astype(np.int32)
        desc_np = desc_np.astype(np.uint32)
        xdesc_np = xdesc_np.astype(np.uint32)

        # candidate ids that actually landed in the table
        used = np.isin(cand_ids, k_lmid[k_valid])
        self.map.free_landmarks(cand_ids[~used])
        n_new = int(used.sum())
        if not p.use_fast:
            occupied = int(k_valid.sum()) - n_new
            self.detector_quality = det_mod.adaptive_quality_update(
                self.detector_quality, n_new,
                max(pending["n_cells"] - occupied, 1))

        stereo = pending["stereo"]
        if stereo:
            # newly triangulated = stereo success on a not-yet-3d landmark
            sl = np.clip(k_lmid, 0, self.map.cap - 1)
            was3d = self.map.lm_is3d[sl] & (k_lmid >= 0)
            newly = tri_ok & k_valid & (k_lmid >= 0) & ~was3d
            if newly.any():
                bearings = k_bv[newly] / np.maximum(k_bv[newly][:, 2:], 1e-9)
                self.map.set_positions(
                    k_lmid[newly], Xw_np[newly], anchor_kf=kfid,
                    bearings=bearings,
                    lams=1.0 / np.maximum(depth_np[newly], 1e-6))
            self.median_depth = float(med_depth)

        # temporal-triangulation commits, per anchor keyframe (in
        # stereo only for landmarks the stereo step left 2D)
        anc_bv, anc_first = anc[2], anc[5]
        sl = np.clip(k_lmid, 0, self.map.cap - 1)
        tnew = tt_ok & k_valid & (k_lmid >= 0) & (anc_first >= 0)
        if stereo:
            tnew &= ~self.map.lm_is3d[sl]
        if tnew.any():
            slots = np.nonzero(tnew)[0]
            ids = k_lmid[slots]
            keep = np.zeros(len(slots), bool)
            anchor_marks = []
            for akf in np.unique(anc_first[slots]):
                arec = self.map.keyframes.get(int(akf))
                if arec is None:
                    continue
                asel = anc_first[slots] == akf
                aslots = arec.kp_slots_of(ids[asel])
                ok2 = aslots >= 0
                keep[np.nonzero(asel)[0][ok2]] = True
                anchor_marks.append((arec, aslots[ok2]))
            if keep.any():
                ks = slots[keep]
                self.map.set_positions(
                    k_lmid[ks], tt_Xw[ks], anchor_kf=anc_first[ks],
                    bearings=anc_bv[ks],
                    lams=1.0 / np.maximum(tt_da[ks], 1e-6))
                for arec, aslots in anchor_marks:
                    arec.is3d[aslots] = True

        sl = np.clip(k_lmid, 0, self.map.cap - 1)
        k_is3d = k_valid & (k_lmid >= 0) & self.map.lm_is3d[sl]
        rec = KeyframeRecord(
            kfid=kfid, time=pending["time"], T_cw=pending["T_cw"].copy(),
            px=k_px, unpx=k_unpx, bv=k_bv, lmid=k_lmid, valid=k_valid,
            is3d=k_is3d, rpx=k_rpx, has_right=k_hr, desc=desc_np,
            desc_ok=desc_ok_np, extra_desc=xdesc_np[xok_np][:300])
        self.map.add_keyframe(rec)
        dsl = np.nonzero(rec.valid & desc_ok_np & (rec.lmid >= 0))[0]
        if len(dsl):
            self.map.add_descriptors(rec.lmid[dsl], desc_np[dsl])
        self.n_kps_at_kf = int(k_valid.sum())
        self.n3d_at_kf = int((k_valid & k_is3d).sum())

        lmm = None
        if p.bdo_track_localmap and len(self.map.keyframes) >= 3:
            with self.prof.scope("2.KF_LMM_dispatch"):
                lmm = self._dispatch_local_map_match(
                    kfid, rec, pending["desc_dev"], pending["desc_ok_dev"],
                    pending["T_cw"])
        self._pending_lmm = dict(kfid=kfid, rec=rec, lmm=lmm,
                                 run_ba=pending["run_ba"],
                                 defer=pending["defer"], age=0)
        if not pending["defer"]:
            pend, self._pending_lmm = self._pending_lmm, None
            self._commit_lmm(pend)

    # ------------------------------------------------------------------
    def _dispatch_local_map_match(self, kfid: int, rec, desc_dev, desc_ok_dev,
                                  T_cw, max_cands: int = 2048):
        """Local-map descriptor matching (Mapper::matchingToLocalMap,
        mapper.cpp:576-774) on the device, against the keyframe's snapshot
        positions; returns (fetch of its results, candidate ids) or None.
        ``_commit_lmm`` merges the matches."""
        m = self.map
        cur = rec.lmid[rec.valid & (rec.lmid >= 0)]
        groups = []
        for ckf in m.covisible_kfs(kfid)[:10]:
            crec = m.keyframes.get(ckf)
            if crec is not None:
                groups.append(crec.lmid[crec.valid & crec.is3d & (crec.lmid >= 0)])
        if not groups:
            return None
        ids = np.unique(np.concatenate(groups))
        good = (m.lm_valid[ids] & m.lm_is3d[ids] & m.lm_desc_ok[ids]
                & ~np.isin(ids, cur))
        ids = ids[good][:max_cands]
        if len(ids) < 1:
            return None
        M = max_cands
        idsp = np.full(M, -1, np.int64)
        idsp[:len(ids)] = ids
        pos = np.zeros((M, 3), np.float32)
        cdesc = np.zeros((M, 8), np.int64)
        cvalid = np.zeros(M, bool)
        pos[:len(ids)] = m.lm_pos[ids]
        cdesc[:len(ids)] = m.lm_desc[ids]
        cvalid[:len(ids)] = True
        # merge targets: keypoints whose landmark is only observed here
        obs_n = np.asarray([len(m.lm_obs.get(int(l), ()))
                            for l in rec.lmid.tolist()])
        matchable = rec.valid & (rec.lmid >= 0) & (obs_n <= 1)
        to = lambda a: torch.from_numpy(a).to(self.device)  # noqa: E731
        snap = self.kps._replace(px=to(rec.px), valid=to(rec.valid))
        res = mapper_mod.match_to_local_map(
            snap, desc_dev, desc_ok_dev, to(matchable), to(pos), to(cdesc),
            to(cvalid), self.cam_l, self._dev(T_cw[:3, :3]),
            self._dev(T_cw[:3, 3]), max_px_dist=self.params.fmax_proj_pxdist,
            max_desc_dist=self.params.fmax_desc_dist)
        return Fetch(res.ok, res.kp_slot), idsp

    def _commit_lmm(self, pending):
        """Local-map merge bookkeeping, then local BA (dispatched for a
        deferred writeback in the pipelined mode with async_ba) and map
        filtering for the keyframe."""
        p = self.params
        kfid = pending["kfid"]
        rec = pending["rec"]
        m = self.map
        if pending["lmm"] is not None:
            fetch, ids = pending["lmm"]
            with self.prof.scope("2.KF_LMM_fetch"):
                ok_np, slot_np = fetch.result()
            taken = set()
            mdst, msrc = [], []
            for ci in np.nonzero(ok_np)[0]:
                s_ = int(slot_np[ci])
                if s_ < 0 or s_ in taken:
                    continue
                dst, src = int(ids[ci]), int(rec.lmid[s_])
                if dst < 0 or src < 0 or dst == src:
                    continue
                taken.add(s_)
                mdst.append(dst)
                msrc.append(src)
            with self.prof.scope("2.KF_LMM_merge"):
                n_merged = m.merge_landmarks_batch(mdst, msrc)
            if n_merged:
                # sync the live keypoint table with the re-pointed slots
                m.update_covisibility(kfid)
                sl = np.clip(rec.lmid, 0, m.cap - 1)
                to = lambda a: torch.from_numpy(a).to(self.device)  # noqa: E731
                self._set_kps(self.kps._replace(
                    lmid=to(rec.lmid.astype(np.int64)),
                    valid=self.kps.valid & to(rec.valid),
                    is3d=to(rec.valid & m.lm_is3d[sl] & (rec.lmid >= 0))))

        if pending["run_ba"] and p.slam_mode and len(m.keyframes) >= 2:
            with self.prof.scope("1.BA_localBA"):
                if p.async_ba and pending["defer"]:
                    # write back the previous keyframe's solve, dispatch
                    # this one's, write it back BA_LAG frames later
                    with self.prof.scope("1.BA_finalize_prev"):
                        self._finalize_pending_ba()
                    with self.prof.scope("1.BA_begin"):
                        self._pending_ba = self.estimator.begin_local_ba(m, kfid)
                    self._ba_age = 0
                else:
                    T_old = rec.T_cw.copy()
                    self.estimator.local_ba(m, kfid)
                    self._apply_pose_correction(T_old, rec.T_cw)
                    self._refresh_kp_3d_flags()
            with self.prof.scope("1.BA_MapFiltering"):
                self.estimator.map_filtering(m, kfid)

        # loop closing (the LoopCloser thread, loop_closer.cpp); every
        # keyframe feeds the place index, the first included
        if self.loopcloser is not None:
            T_old = rec.T_cw.copy()
            with self.prof.scope("2.LC_Process"):
                ev = self.loopcloser.process_kf(m, kfid)
            if ev is not None:
                self.last_loop_event = ev
                self.loop_events.append(ev)
                # the in-flight local BA predates the correction: writing it
                # back would undo it (the reference aborts it,
                # bstop_localba_, optimizer.cpp:2334-2344)
                self._pending_ba = None
                self._apply_pose_correction(T_old, rec.T_cw)
                self._refresh_kp_3d_flags()

        sl = np.clip(rec.lmid, 0, m.cap - 1)
        is3d = rec.valid & (rec.lmid >= 0) & m.lm_is3d[sl]
        self.n_kps_at_kf = int(rec.valid.sum())
        self.n3d_at_kf = int(is3d.sum())

    # ------------------------------------------------------------------
    def _assemble_anchor_data(self, prev_kfid: int):
        """Anchor poses/bearings for temporal triangulation, from the
        previous keyframe's record. Returns (R, t, bv, lmid, ok, first_kf)."""
        K = self.kp_cap
        anc_R = np.tile(np.eye(3, dtype=np.float32), (K, 1, 1))
        anc_t = np.zeros((K, 3), np.float32)
        anc_bv = np.zeros((K, 3), np.float32)
        anc_bv[:, 2] = 1.0
        anc_lmid = np.full(K, -1, np.int32)
        anc_ok = np.zeros(K, bool)
        anc_first = np.full(K, -1, np.int32)
        prev = self.map.keyframes.get(prev_kfid)
        if prev is not None:
            slots = np.nonzero(prev.valid & ~prev.is3d & (prev.lmid >= 0))[0]
            if len(slots):
                lmids = prev.lmid[slots]
                first = self.map.first_obs_of(lmids)
                for akf in np.unique(first[first >= 0]):
                    arec = self.map.keyframes.get(int(akf))
                    if arec is None:
                        continue
                    sel = first == akf
                    aslots = arec.kp_slots_of(lmids[sel])
                    ok2 = aslots >= 0
                    s_i = slots[sel][ok2]
                    if len(s_i) == 0:
                        continue
                    b = arec.bv[aslots[ok2]]
                    anc_R[s_i] = arec.T_cw[:3, :3]
                    anc_t[s_i] = arec.T_cw[:3, 3]
                    anc_bv[s_i] = b / np.maximum(b[:, 2:3], 1e-9)
                    anc_lmid[s_i] = lmids[sel][ok2]
                    anc_ok[s_i] = True
                    anc_first[s_i] = akf
        return anc_R, anc_t, anc_bv, anc_lmid, anc_ok, anc_first

    def _refresh_kp_3d_flags(self):
        """After BA outlier removal some landmarks may be gone; sync the
        live frame's flags against the landmark mirrors."""
        _, lm_is3d = self.map.device_landmarks()
        lm_valid = self.map.device_lm_valid()
        kps = self.kps
        slot = torch.clamp(kps.lmid, 0, lm_valid.shape[0] - 1)
        alive = lm_valid[slot] & (kps.lmid >= 0)
        self._set_kps(kps._replace(valid=kps.valid & alive,
                                   is3d=kps.valid & alive & lm_is3d[slot]))

    # ------------------------------------------------------------------
    def write_results(self, out_dir: str = "."):
        """Trajectory outputs with the reference's names and the final
        passes (SlamManager::writeResults, ov2slam.cpp:574-621), after a
        flush: with ``do_full_ba`` one full BA and the refined keyframe
        trajectory; with the loop closer or full BA the loop-corrected full
        trajectory, rebuilt rigidly from the corrected keyframes
        (``ov2slam_full_traj_wlc.txt``, ov2slam.cpp:624-701) and relaxed by
        the full pose graph (``ov2slam_full_traj_wlc_opt.txt``,
        optimizer.cpp:2783-2865)."""
        self.flush()
        lg, m = self.logger, self.map
        lg.write_tum(os.path.join(out_dir, "ov2slam_traj.txt"))
        lg.write_kitti(os.path.join(out_dir, "ov2slam_traj_kitti.txt"))
        lg.write_tum(os.path.join(out_dir, "ov2slam_kfs_traj.txt"), kf_only=True)

        def kf_poses_wc():
            return {k: np.linalg.inv(rec.T_cw.astype(np.float64))
                    for k, rec in m.keyframes.items()}

        if self.params.do_full_ba:
            if len(m.keyframes) >= 3:
                with self.prof.scope("1.BA_fullBA"):
                    self.estimator.full_ba(m)
            lg.write_kf_poses_tum(
                os.path.join(out_dir, "ov2slam_fullba_kfs_traj.txt"),
                kf_poses_wc())
        if not (self.params.buse_loop_closer or self.params.do_full_ba):
            return
        kf_idx = [i for i in range(len(lg.times))
                  if lg.is_kf[i] and lg.kf_ids[i] in m.keyframes]
        if not kf_idx:
            return
        kf_Twc = [np.linalg.inv(m.keyframes[lg.kf_ids[i]].T_cw.astype(np.float64))
                  for i in kf_idx]
        with self.prof.scope("1.BA_fullPoseGraph"):
            relaxed = pg_mod.relax_full_trajectory(
                np.stack(lg.poses_wc), np.asarray(kf_idx), np.stack(kf_Twc),
                device=self.device)
        lg.write_full_with_kf_poses(
            os.path.join(out_dir, "ov2slam_full_traj_wlc.txt"), kf_poses_wc())
        lg.write_poses_tum(
            os.path.join(out_dir, "ov2slam_full_traj_wlc_opt.txt"), relaxed)
