"""SlamSystem: the orchestrator wiring front end, mapper and estimator
(port of the synchronous stereo path of ``ov2slam_tpu/slam/manager.py``).

Replaces the reference's SlamManager (ov2slam.cpp:33-237): calibration
setup, the per-frame loop (tracking -> KF decision -> keyframe processing ->
local BA), and results writing. Every frame runs to completion before the
next: one device step per frame, one (12,) stats read on the host, and
keyframe processing inline.

Only the slice configuration is ported. Every other setting raises
``NotImplementedError`` naming the ROADMAP item that will bring it.
"""

from __future__ import annotations

import os
import warnings
from typing import Optional

import numpy as np
import torch
from torch.profiler import record_function

from ov2slam_tpu_torch import device as device_mod
from ov2slam_tpu_torch.config import SlamParams
from ov2slam_tpu_torch.core.camera import Camera
from ov2slam_tpu_torch.core.lie import SE3
from ov2slam_tpu_torch.io.trajectories import TrajectoryLogger
from ov2slam_tpu_torch.ops import detect as det_mod
from ov2slam_tpu_torch.slam import frontend as fe_mod
from ov2slam_tpu_torch.slam import mapper as mapper_mod
from ov2slam_tpu_torch.slam.estimator import Estimator
from ov2slam_tpu_torch.slam.frame import FrameKps
from ov2slam_tpu_torch.slam.map import KeyframeRecord, MapStore


def _mat_from_quat_np(q: np.ndarray) -> np.ndarray:
    x, y, z, w = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ], np.float32)


def unsupported_settings(p: SlamParams):
    """(setting, ROADMAP item) pairs of `p` outside the ported slice."""
    dist = np.abs([p.k1l, p.k2l, p.p1l, p.p2l, p.k1r, p.k2r, p.p1r, p.p2r])
    rot = (p.T_left_right is not None and np.abs(
        np.asarray(p.T_left_right)[:3, :3] - np.eye(3)).max() > 1e-6)
    checks = [
        (p.mono or not p.stereo, "mono", "A3 P3P recovery and mono"),
        (p.use_clahe, "use_clahe", "A2 CLAHE"),
        (p.doepipolar, "doepipolar", "A1 essential-matrix RANSAC"),
        (p.dop3p, "dop3p", "A3 P3P recovery and mono"),
        (p.btrack_keyframetoframe, "btrack_keyframetoframe",
         "A4 rectification and KF-to-frame tracking"),
        (p.force_realtime or p.async_ba, "force_realtime/async_ba",
         "A6 realtime pipelining"),
        (p.buse_loop_closer, "buse_loop_closer", "A5 loop closing"),
        (p.bdo_stereo_rect and (dist.max() > 1e-9 or rot), "bdo_stereo_rect",
         "A4 rectification and KF-to-frame tracking"),
        (p.bdo_undist and dist.max() > 1e-12, "bdo_undist",
         "A4 rectification and KF-to-frame tracking"),
        (p.use_fast or p.use_shi_tomasi, "use_fast/use_shi_tomasi",
         "A5 loop closing (FAST, cornerSubPix)"),
        (p.use_dogleg or p.use_subspace_dogleg, "use_dogleg",
         "A6 realtime pipelining (dogleg BA)"),
        (p.n_devices and p.n_devices > 1, "n_devices > 1",
         "not ported: one GPU"),
        (p.do_full_ba, "do_full_ba", "A5 loop closing (span/full BA)"),
    ]
    return [(name, item) for cond, name, item in checks if cond]


class SlamSystem:
    """Stereo SLAM pipeline on one torch device."""

    def __init__(self, params: SlamParams, device=None):
        bad = unsupported_settings(params)
        if bad:
            raise NotImplementedError(
                "ov2slam_tpu_torch runs the stereo slice only; not ported: "
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
        self.T_rl = SE3(self._dev(R_rl), self._dev(t_rl))
        # born-rectified input (zero distortion + pure x-baseline) gates the
        # SAD row-search stereo prior (map_manager.cpp:439-470)
        pure_baseline = (np.abs(R_rl - np.eye(3)).max() < 1e-6
                         and np.abs(t_rl[1:]).max() < 1e-6)
        zero_dist = np.abs([p.k1l, p.k2l, p.k1r, p.k2r]).max() < 1e-9
        self._rows_aligned = bool(p.stereo and pure_baseline and zero_dist)

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
        self.logger = TrajectoryLogger()
        self.reset()

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
        self.fe_state: Optional[fe_mod.FEState] = None
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

    @property
    def kps(self) -> FrameKps:
        return self.fe_state.kps

    def _set_kps(self, kps: FrameKps):
        self.fe_state = self.fe_state._replace(kps=kps)

    def _sync_pose_to_device(self):
        self.fe_state = self.fe_state._replace(
            R_cw=self._dev(self.T_cw[:3, :3]), t_cw=self._dev(self.T_cw[:3, 3]))

    def _apply_pose_correction(self, T_old: np.ndarray, T_new: np.ndarray):
        """Apply a keyframe pose correction (BA) to the live pose as a
        relative update T_cw' = T_cw @ T_old^-1 @ T_new, on host and device."""
        dT = np.linalg.inv(T_old.astype(np.float64)) @ T_new.astype(np.float64)
        if np.abs(dT - np.eye(4)).max() < 1e-9:
            return
        self.T_cw = (self.T_cw.astype(np.float64) @ dT).astype(np.float32)
        if self.fe_state is not None:
            dR = self._dev(dT[:3, :3])
            dt = self._dev(dT[:3, 3])
            st = self.fe_state
            self.fe_state = st._replace(R_cw=st.R_cw @ dR,
                                        t_cw=st.R_cw @ dt + st.t_cw)

    def T_wc(self) -> np.ndarray:
        return np.linalg.inv(self.T_cw.astype(np.float64)).astype(np.float32)

    def _to_device_u8(self, img) -> torch.Tensor:
        if isinstance(img, torch.Tensor):
            return img.to(self.device, torch.uint8)
        return torch.from_numpy(
            np.ascontiguousarray(img).astype(np.uint8)).to(self.device)

    # ------------------------------------------------------------------
    def process_stereo(self, iml: np.ndarray, imr: np.ndarray, time: float
                       ) -> np.ndarray:
        """One stereo frame in, camera-to-world pose out (the per-frame body
        of SlamManager::run, ov2slam.cpp:116-237)."""
        p = self.params
        self.frame_id += 1
        img = self._to_device_u8(iml)
        with record_function("0.Full-Front_End"):
            if self.fe_state is None:
                self.fe_state = fe_mod.init_fe_state(img, self.kp_cap,
                                                     p.nklt_pyr_lvl)
                self._initialize_stereo(imr, time)
                self._log_pose(time, True)
                return self.T_wc()
            lm_pos, lm_is3d = self.map.device_landmarks()
            self.fe_state, stats = fe_mod.frame_step(
                self.fe_state, img, lm_pos, lm_is3d, self.cam_l,
                levels=p.nklt_pyr_lvl, nklt_win=p.nklt_win_size,
                nmax_iter=p.nmax_iter, fmax_px_precision=p.fmax_px_precision,
                fmax_fbklt_dist=p.fmax_fbklt_dist, klt_err=p.nklt_err,
                robust_th2=p.robust_mono_th)
        self._finalize_frame(stats.cpu().numpy(), imr, time)
        return self.T_wc()

    def _log_pose(self, time, is_kf: bool):
        T_wkf = None
        if self.cur_kfid in self.map.keyframes:
            T_wkf = np.linalg.inv(self.map.keyframes[self.cur_kfid].T_cw)
        self.logger.add(time, self.T_wc(), is_kf, self.cur_kfid, T_wkf)

    def _finalize_frame(self, stats_np: np.ndarray, imr, time):
        """Read the stats vector, update the pose and log, decide and run
        keyframe processing."""
        p = self.params
        pose_ok = stats_np[0] > 0.5
        n_tracked = int(stats_np[1])
        n_3d = int(stats_np[2])
        parallax = float(stats_np[4])
        if pose_ok:
            T = np.eye(4, dtype=np.float32)
            T[:3, :3] = _mat_from_quat_np(stats_np[8:12])
            T[:3, 3] = stats_np[5:8]
            self.T_cw = T
        elif n_3d >= 10 and self.initialized:
            raise NotImplementedError(
                f"frame {self.frame_id}: prior-seeded PnP failed with {n_3d} "
                "3D keypoints; the P3P-RANSAC recovery is not ported "
                "(ROADMAP queue A3 P3P recovery and mono)")
        need_kf = fe_mod.check_new_kf(
            p, n_tracked, n_3d, parallax, self.frames_since_kf,
            self.n3d_at_kf, pose_ok, time_since_kf=time - self.kf_time)
        if need_kf:
            with record_function("1.KF_Processing"):
                self._create_keyframe(imr, time)
        else:
            self.frames_since_kf += 1
        self._log_pose(time, need_kf)

    def _initialize_stereo(self, imr, time):
        """First keyframe: detect + stereo triangulate."""
        self._create_keyframe(imr, time, run_ba=False)
        if self.map.n_3d() > 20:
            self.initialized = True

    # ------------------------------------------------------------------
    def _create_keyframe(self, imr, time, run_ba: bool = True):
        """Keyframe creation: the device step (detect -> insert -> describe
        -> stereo match -> triangulate), then the host commit."""
        p = self.params
        kfid = self.map.next_kf_id
        prev_kfid = self.cur_kfid
        self.cur_kfid = kfid
        with record_function("2.KF_DeviceStep"):
            n_cells = ((self.cam_l.height // p.nmaxdist)
                       * (self.cam_l.width // p.nmaxdist))
            cand_ids = self.map.alloc_landmarks(n_cells)
            anc = self._assemble_anchor_data(prev_kfid)
            right_pyr = fe_mod.preprocess(self._to_device_u8(imr),
                                          p.nklt_pyr_lvl)
            lm_pos, lm_is3d = self.map.device_landmarks()
            d = self.device
            res = mapper_mod.kf_step(
                self.fe_state.pyr, right_pyr, self.kps, lm_pos, lm_is3d,
                self.cam_l, self.cam_r, self._dev(self.T_cw[:3, :3]),
                self._dev(self.T_cw[:3, 3]), self.T_rl.R, self.T_rl.t,
                float(np.float32(self.detector_quality)),
                torch.from_numpy(cand_ids.astype(np.int64)).to(d),
                float(np.float32(self.median_depth)),
                self._dev(anc[0]), self._dev(anc[1]), self._dev(anc[2]),
                torch.from_numpy(anc[3].astype(np.int64)).to(d),
                torch.from_numpy(anc[4]).to(d), cellsize=p.nmaxdist,
                nlevels=p.nklt_pyr_lvl, win=p.nklt_win_size,
                max_iters=p.nmax_iter, fb_dist=p.fmax_fbklt_dist,
                klt_err=p.nklt_err, epi_th_px=p.fepi_th,
                use_sad_prior=self._rows_aligned)
            self._set_kps(res.kps)
            kp = res.kps
            fetch = tuple(a.cpu().numpy() for a in (
                kp.px, kp.unpx, kp.bv, kp.lmid, kp.valid, kp.is3d, kp.rpx,
                kp.has_right, res.desc, res.desc_ok, res.tri_ok, res.tri_Xw,
                res.tri_depth, res.med_depth, res.extra_desc, res.extra_ok,
                res.tt_ok, res.tt_Xw, res.tt_depth_anchor))

        # tracking re-anchors its parallax reference to this keyframe
        self._set_kps(self.kps._replace(kf_bv=self.kps.bv.clone(),
                                        kf_px=self.kps.px.clone()))
        self.fe_state = self.fe_state._replace(R_kf=self._dev(self.T_cw[:3, :3]))
        self._sync_pose_to_device()
        self.frames_since_kf = 0
        self.kf_time = time
        self._commit_kf(dict(kfid=kfid, time=time, T_cw=self.T_cw.copy(),
                             fetch=fetch, cand_ids=cand_ids, anc=anc,
                             n_cells=n_cells, desc_dev=res.desc,
                             desc_ok_dev=res.desc_ok, run_ba=run_ba))

    # ------------------------------------------------------------------
    def _commit_kf(self, pending):
        """Host-side keyframe commit: registry updates from the fetched
        bundle, the keyframe record, then local-map matching, local BA and
        map filtering (the JAX package's ``_commit_kf`` followed by its
        ``_commit_lmm``; nothing is deferred here)."""
        p = self.params
        kfid = pending["kfid"]
        cand_ids = pending["cand_ids"]
        anc = pending["anc"]
        with record_function("2.KF_Registry"):
            (k_px, k_unpx, k_bv, k_lmid, k_valid, k_is3d, k_rpx, k_hr,
             desc_np, desc_ok_np, tri_ok, Xw_np, depth_np, med_depth,
             xdesc_np, xok_np, tt_ok, tt_Xw, tt_da) = pending["fetch"]
            k_lmid = k_lmid.astype(np.int32)
            desc_np = desc_np.astype(np.uint32)
            xdesc_np = xdesc_np.astype(np.uint32)

            # candidate ids that actually landed in the table
            used = np.isin(cand_ids, k_lmid[k_valid])
            self.map.free_landmarks(cand_ids[~used])
            n_new = int(used.sum())
            occupied = int(k_valid.sum()) - n_new
            self.detector_quality = det_mod.adaptive_quality_update(
                self.detector_quality, n_new,
                max(pending["n_cells"] - occupied, 1))

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

            # temporal-triangulation commits, per anchor keyframe
            anc_bv, anc_first = anc[2], anc[5]
            sl = np.clip(k_lmid, 0, self.map.cap - 1)
            tnew = (tt_ok & k_valid & (k_lmid >= 0) & (anc_first >= 0)
                    & ~self.map.lm_is3d[sl])
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

        if p.bdo_track_localmap and len(self.map.keyframes) >= 3:
            with record_function("2.KF_MatchLocalMap"):
                self._match_local_map(kfid, rec, pending["desc_dev"],
                                      pending["desc_ok_dev"], pending["T_cw"])

        if pending["run_ba"] and p.slam_mode and len(self.map.keyframes) >= 2:
            with record_function("1.BA_localBA"):
                T_old = rec.T_cw.copy()
                self.estimator.local_ba(self.map, kfid)
                self._apply_pose_correction(T_old, rec.T_cw)
                self._refresh_kp_3d_flags()
            with record_function("1.BA_MapFiltering"):
                self.estimator.map_filtering(self.map, kfid)

        sl = np.clip(rec.lmid, 0, self.map.cap - 1)
        is3d = rec.valid & (rec.lmid >= 0) & self.map.lm_is3d[sl]
        self.n_kps_at_kf = int(rec.valid.sum())
        self.n3d_at_kf = int(is3d.sum())

    # ------------------------------------------------------------------
    def _match_local_map(self, kfid: int, rec, desc_dev, desc_ok_dev, T_cw,
                         max_cands: int = 2048):
        """Local-map descriptor matching (Mapper::matchingToLocalMap,
        mapper.cpp:576-774) and the merge bookkeeping of its matches — the
        JAX package's ``_dispatch_local_map_match`` and the merge half of
        ``_commit_lmm``, run back to back."""
        m = self.map
        cur = rec.lmid[rec.valid & (rec.lmid >= 0)]
        groups = []
        for ckf in m.covisible_kfs(kfid)[:10]:
            crec = m.keyframes.get(ckf)
            if crec is not None:
                groups.append(crec.lmid[crec.valid & crec.is3d & (crec.lmid >= 0)])
        if not groups:
            return
        ids = np.unique(np.concatenate(groups))
        good = (m.lm_valid[ids] & m.lm_is3d[ids] & m.lm_desc_ok[ids]
                & ~np.isin(ids, cur))
        ids = ids[good][:max_cands]
        if len(ids) < 1:
            return
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
        ok_np, slot_np = res.ok.cpu().numpy(), res.kp_slot.cpu().numpy()

        taken = set()
        mdst, msrc = [], []
        for ci in np.nonzero(ok_np)[0]:
            s = int(slot_np[ci])
            if s < 0 or s in taken:
                continue
            dst, src = int(idsp[ci]), int(rec.lmid[s])
            if dst < 0 or src < 0 or dst == src:
                continue
            taken.add(s)
            mdst.append(dst)
            msrc.append(src)
        if m.merge_landmarks_batch(mdst, msrc):
            # sync the live keypoint table with the re-pointed slots
            m.update_covisibility(kfid)
            sl = np.clip(rec.lmid, 0, m.cap - 1)
            self._set_kps(self.kps._replace(
                lmid=to(rec.lmid.astype(np.int64)),
                valid=self.kps.valid & to(rec.valid),
                is3d=to(rec.valid & m.lm_is3d[sl] & (rec.lmid >= 0))))

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
        """Trajectory outputs with the reference's names
        (SlamManager::writeResults, ov2slam.cpp:574-621)."""
        self.logger.write_tum(os.path.join(out_dir, "ov2slam_traj.txt"))
        self.logger.write_kitti(os.path.join(out_dir, "ov2slam_traj_kitti.txt"))
        self.logger.write_tum(os.path.join(out_dir, "ov2slam_kfs_traj.txt"),
                              kf_only=True)
