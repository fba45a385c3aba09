"""Back-end estimator: local bundle adjustment driver + keyframe culling
(port of the local-BA path of ``ov2slam_tpu/slam/estimator.py``).

Replaces the reference's Estimator thread (estimator.cpp) and the
problem-construction half of Optimizer::localBA (optimizer.cpp:34-897):
select the covisibility window around the newest keyframe, assemble a
padded ``BAProblem`` from the host map store, run the Schur-LM solver on the
device, write results back, sweep outlier observations, and cull redundant
keyframes. The local BA always has one fixed shape (F, L, O) = (24, 2048,
12288); windows beyond it are truncated by covisibility score and counted
in ``n_truncations``. Span, full and windowed BA are not ported yet.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ov2slam_tpu_torch.core.lie import SE3
from ov2slam_tpu_torch.opt import ba as ba_mod
from ov2slam_tpu_torch.opt.residuals import Calib
from ov2slam_tpu_torch.slam.map import MapStore

_log = logging.getLogger("ov2slam_tpu_torch.estimator")

BA_MAX_KFS = 24
BA_MAX_LMS = 2048
BA_MAX_OBS = 12288


@dataclass
class BAOutcome:
    ran: bool = False
    n_kfs: int = 0
    n_lms: int = 0
    n_obs: int = 0
    n_outliers: int = 0
    cost0: float = 0.0
    cost: float = 0.0


class Estimator:
    def __init__(self, params, calib_l: Calib, calib_r: Calib, T_rl: SE3,
                 device=None):
        self.params = params
        self.calib_l = calib_l
        self.calib_r = calib_r
        self.T_rl = T_rl
        self.device = torch.device("cpu") if device is None else torch.device(device)
        self.n_truncations = 0

    # ------------------------------------------------------------------
    def build_problem(self, m: MapStore, new_kfid: int, max_kfs=BA_MAX_KFS,
                      max_lms=BA_MAX_LMS, max_obs=BA_MAX_OBS
                      ) -> Optional[Tuple[ba_mod.BAProblem, List[int],
                                          np.ndarray, Dict]]:
        """Window selection mirroring optimizer.cpp:128-267: KFs with
        covisibility score >= nmin_covscore are optimized, other observers
        of window landmarks enter as constants; >= 1 constant KF (stereo)
        fixes the gauge. The problem is padded to (max_kfs, max_lms,
        max_obs)."""
        p = self.params
        covis = m.covis.get(new_kfid, {})
        ranked = sorted(covis.items(), key=lambda kv: -kv[1])
        opt_kfs = [new_kfid] + [k for k, c in ranked if c >= p.nmin_covscore]
        opt_kfs = opt_kfs[:max_kfs - 2]

        groups = []
        for kfid in opt_kfs:
            rec = m.keyframes.get(kfid)
            if rec is not None:
                groups.append(rec.lmid[rec.valid & rec.is3d & (rec.lmid >= 0)])
        if not groups:
            return None
        cat = np.concatenate(groups)
        _, first_idx = np.unique(cat, return_index=True)
        uniq = cat[np.sort(first_idx)]
        good = m.lm_valid[uniq] & m.lm_is3d[uniq]
        n_lm_raw = int(good.sum())
        lm_set = [int(x) for x in uniq[good][:max_lms]]
        if n_lm_raw > max_lms:
            self.n_truncations += 1
            _log.warning("BA window at kf=%d truncated: %d landmarks > "
                         "capacity %d", new_kfid, n_lm_raw, max_lms)
        if len(lm_set) < 8:
            return None

        const_kfs: List[int] = []
        opt_set = set(opt_kfs)
        for lmid in lm_set:
            a = int(m.lm_anchor[lmid])
            if a >= 0 and a not in opt_set and a in m.keyframes:
                if a not in const_kfs:
                    const_kfs.append(a)
            for kfid in m.lm_obs.get(lmid, ()):
                if (kfid not in opt_set and kfid not in const_kfs
                        and kfid in m.keyframes):
                    const_kfs.append(kfid)
        const_kfs = const_kfs[: max_kfs - len(opt_kfs)]
        nmincst = 1 if p.stereo else 2
        while len(const_kfs) < nmincst and len(opt_kfs) > 1:
            const_kfs.append(opt_kfs.pop())

        F, L, O = max_kfs, max_lms, max_obs
        kf_list = (opt_kfs + const_kfs)[:F]
        if all(k in opt_set for k in kf_list) and len(kf_list) > 1:
            opt_set.discard(kf_list[-1])
        kf_slot = {kfid: i for i, kfid in enumerate(kf_list)}
        lm_set = lm_set[:L]

        R = np.tile(np.eye(3, dtype=np.float32), (F, 1, 1))
        t = np.zeros((F, 3), np.float32)
        pose_opt = np.zeros(F, bool)
        for kfid, i in kf_slot.items():
            T = m.keyframes[kfid].T_cw
            R[i] = T[:3, :3]
            t[i] = T[:3, 3]
            pose_opt[i] = kfid in opt_set

        lm_ids_np = np.asarray(lm_set, np.int64)
        lm_slot_arr = np.full(m.cap, -1, np.int32)
        lm_slot_arr[lm_ids_np] = np.arange(len(lm_set), dtype=np.int32)
        max_kfid = max(kf_list) + 1
        kfid_to_slot = np.full(max_kfid + 1, -1, np.int32)
        for kfid, i in kf_slot.items():
            kfid_to_slot[kfid] = i

        anchor = np.zeros(L, np.int64)
        bearing = np.zeros((L, 3), np.float32)
        bearing[:, 2] = 1.0
        lam = np.ones(L, np.float32)
        Xw = np.zeros((L, 3), np.float32)
        lm_valid = np.zeros(L, bool)
        anc_kf = m.lm_anchor[lm_ids_np]
        anc_slot = np.where((anc_kf >= 0) & (anc_kf <= max_kfid),
                            kfid_to_slot[np.clip(anc_kf, 0, max_kfid)], -1)
        ok = anc_slot >= 0
        jj = np.arange(len(lm_set))[ok]
        anchor[jj] = anc_slot[ok]
        bearing[jj] = m.lm_bearing[lm_ids_np[ok]]
        lam[jj] = m.lm_lam[lm_ids_np[ok]]
        Xw[jj] = m.lm_pos[lm_ids_np[ok]]
        lm_valid[jj] = True

        # observations: every (kf in window) x (lm in window); in inverse-
        # depth mode the anchor's own left-cam observation is skipped
        skip_anchor_obs = bool(p.buse_inv_depth)
        okf, olm, opx, orgt = [], [], [], []
        mkf, mlm, mslot, mright = [], [], [], []
        for kfid in kf_list:
            rec = m.keyframes[kfid]
            slots = np.nonzero(rec.valid & rec.is3d & (rec.lmid >= 0))[0]
            lmids = rec.lmid[slots]
            j = lm_slot_arr[lmids]
            keep = j >= 0
            keep[keep] &= lm_valid[j[keep]]
            slots, lmids, j = slots[keep], lmids[keep], j[keep]
            if skip_anchor_obs:
                lsel = m.lm_anchor[lmids] != kfid
            else:
                lsel = np.ones(len(slots), bool)
            rsel = rec.has_right[slots]
            for sel, right, px in ((lsel, False, rec.unpx), (rsel, True, rec.rpx)):
                okf.append(np.full(sel.sum(), kf_slot[kfid], np.int64))
                olm.append(j[sel])
                opx.append(px[slots[sel]])
                orgt.append(np.full(sel.sum(), right))
                mkf.append(np.full(sel.sum(), kfid, np.int64))
                mlm.append(lmids[sel])
                mslot.append(slots[sel])
                mright.append(np.full(sel.sum(), right))
        okf = np.concatenate(okf)
        if len(okf) > O:
            self.n_truncations += 1
            _log.warning("BA window at kf=%d truncated: %d observations > "
                         "capacity %d", new_kfid, len(okf), O)
        okf = okf[:O]
        n = len(okf)
        if n < 16:
            return None
        obs_kf = np.zeros(O, np.int64)
        obs_lm = np.zeros(O, np.int64)
        obs_px = np.zeros((O, 2), np.float32)
        obs_right = np.zeros(O, bool)
        obs_valid = np.zeros(O, bool)
        obs_kf[:n] = okf
        obs_lm[:n] = np.concatenate(olm)[:O]
        obs_px[:n] = np.concatenate(opx)[:O]
        obs_right[:n] = np.concatenate(orgt)[:O]
        obs_valid[:n] = True
        obs_meta = dict(
            kf=np.concatenate(mkf)[:O], lm=np.concatenate(mlm)[:O],
            slot=np.concatenate(mslot)[:O], right=np.concatenate(mright)[:O])

        to = lambda a: torch.from_numpy(a).to(self.device)  # noqa: E731
        prob = ba_mod.BAProblem(
            R=to(R), t=to(t), pose_opt=to(pose_opt), Xw=to(Xw),
            anchor=to(anchor), bearing=to(bearing), lam=to(lam),
            lm_valid=to(lm_valid), obs_kf=to(obs_kf), obs_lm=to(obs_lm),
            obs_px=to(obs_px), obs_right=to(obs_right),
            obs_valid=to(obs_valid), calib_l=self.calib_l,
            calib_r=self.calib_r, T_rl=self.T_rl)
        return prob, kf_list, lm_ids_np, {
            "obs_meta": obs_meta, "n_obs": n, "pose_opt": pose_opt,
            "lm_valid": lm_valid.copy()}

    # ------------------------------------------------------------------
    def _solve(self, prob, max_iters: int) -> ba_mod.BAResult:
        p = self.params
        return ba_mod.solve_ba(
            prob, invdepth=p.buse_inv_depth, max_iters=max_iters, robust=True,
            th2_mono=p.robust_mono_th, th2_stereo=p.robust_stereo_th,
            l2_refine=p.apply_l2_after_robust)

    def local_ba(self, m: MapStore, new_kfid: int, max_iters: int = 5
                 ) -> BAOutcome:
        built = self.build_problem(m, new_kfid)
        out = BAOutcome()
        if built is None:
            return out
        prob, kf_list, lm_ids, meta = built
        result = self._solve(prob, max_iters)
        return self._writeback(m, kf_list, lm_ids, meta, result, out)

    def _writeback(self, m, kf_list, lm_ids, meta, result, out) -> BAOutcome:
        R_np, t_np, Xw_np, lam_np, inl = (
            a.cpu().numpy() for a in (result.R, result.t, result.Xw,
                                      result.lam, result.obs_inlier))
        for i, kfid in enumerate(kf_list):
            if meta["pose_opt"][i] and kfid in m.keyframes:
                T = np.eye(4, dtype=np.float32)
                T[:3, :3] = R_np[i]
                T[:3, 3] = t_np[i]
                m.keyframes[kfid].T_cw = T

        # landmarks actually in the problem (an anchor outside the window
        # leaves its slot default-initialized)
        nL = len(lm_ids)
        in_prob = meta["lm_valid"][:nL]
        m.update_positions_from_ba(lm_ids[in_prob], Xw_np[:nL][in_prob],
                                   lam_np[:nL][in_prob])

        # outlier sweep (optimizer.cpp:737-895): right-cam outliers lose
        # has_right; left-cam outliers lose the observation (landmarks left
        # without observers are culled)
        om = meta["obs_meta"]
        nO = len(om["kf"])
        bad = ~inl[:nO]
        n_out = int(bad.sum())
        if n_out:
            rbad = bad & om["right"]
            for kfid in np.unique(om["kf"][rbad]):
                rec = m.keyframes.get(int(kfid))
                if rec is not None:
                    rec.has_right[om["slot"][rbad & (om["kf"] == kfid)]] = False
            for k in np.nonzero(bad & ~om["right"])[0]:
                m.remove_obs(int(om["lm"][k]), int(om["kf"][k]))
        out.ran = True
        out.n_kfs = len(kf_list)
        out.n_lms = nL
        out.n_obs = meta["n_obs"]
        out.n_outliers = n_out
        out.cost0 = float(result.cost0)
        out.cost = float(result.cost)
        return out

    # ------------------------------------------------------------------
    def map_filtering(self, m: MapStore, new_kfid: int) -> int:
        """Redundant-KF culling (estimator.cpp:101-183): remove covisible KFs
        whose 3D keypoints are >= fkf_filtering_ratio co-observed by > 4 KFs."""
        p = self.params
        if p.fkf_filtering_ratio >= 1.0 or new_kfid < 20:
            return 0
        removed = 0
        for kfid in list(m.covis.get(new_kfid, {})):
            if kfid == 0 or kfid >= new_kfid - 2:
                continue
            rec = m.keyframes.get(kfid)
            if rec is None:
                continue
            slots = np.nonzero(rec.valid & rec.is3d & (rec.lmid >= 0))[0]
            if len(slots) < p.nmin_covscore // 2:
                m.remove_keyframe(kfid)
                removed += 1
                continue
            n_obs = np.asarray([len(m.lm_obs.get(int(rec.lmid[s]), ()))
                                for s in slots])
            if int((n_obs > 4).sum()) > p.fkf_filtering_ratio * len(slots):
                m.remove_keyframe(kfid)
                removed += 1
        return removed
