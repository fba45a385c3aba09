"""Back-end estimator: local bundle adjustment driver + keyframe culling
(port of the local-BA path of ``ov2slam_tpu/slam/estimator.py``).

Replaces the reference's Estimator thread (estimator.cpp) and the
problem-construction half of Optimizer::localBA (optimizer.cpp:34-897):
select the covisibility window around the newest keyframe, assemble a
padded ``BAProblem`` from the host map store, run the Schur-LM (or dogleg)
solver on the device, write results back, sweep outlier observations, and
cull redundant keyframes. In the pipelined mode the solve is dispatched at
one keyframe (``begin_local_ba``) and written back frames later
(``finalize_local_ba``), its results fetched in between. The local BA's
caps are (F, L, O) = (24, 2048, 12288); windows beyond them are truncated
by covisibility score and counted in ``n_truncations``.

Span BA (the loose BA after a loop closure), full BA (``do_full_ba``, at
``write_results``) and the structure-only refinement of merged landmarks
build their problems through the same window builder with other caps.
Every problem has the live counts of keyframes, landmarks and observations
(the caps only truncate): the JAX package pads to fixed shapes and coarse
buckets to bound XLA recompiles, where padding adds exact zeros, and eager
PyTorch has no compiles to bound. Span and full BA run the matrix-free
Schur-PCG solver (``opt/ba_global.py``).
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ov2slam_tpu_torch.core.lie import SE3
from ov2slam_tpu_torch.device import Fetch, resolve_device
from ov2slam_tpu_torch.io.profiler import Profiler
from ov2slam_tpu_torch.opt import ba as ba_mod
from ov2slam_tpu_torch.opt import ba_global
from ov2slam_tpu_torch.opt.residuals import Calib
from ov2slam_tpu_torch.parallel import sharded
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
                 device=None, mesh=None):
        self.params = params
        self.calib_l = calib_l
        self.calib_r = calib_r
        self.T_rl = T_rl
        self.device = resolve_device(device)
        # a device mesh (parallel.sharded.make_mesh; SlamParams n_devices >
        # 1): the local BA solves through the observation-sharded solver
        self.mesh = mesh
        self.n_truncations = 0
        # budgeted span solves that hit their wall-clock limit
        self.n_ba_timeouts = 0
        self.prof = Profiler.instance()

    # ------------------------------------------------------------------
    def build_problem(self, m: MapStore, new_kfid: int, max_kfs=BA_MAX_KFS,
                      max_lms=BA_MAX_LMS, max_obs=BA_MAX_OBS
                      ) -> Optional[Tuple[ba_mod.BAProblem, List[int],
                                          np.ndarray, Dict]]:
        """Window selection mirroring optimizer.cpp:128-267: KFs with
        covisibility score >= nmin_covscore are optimized, other observers
        of window landmarks enter as constants; >= 1 constant KF (stereo)
        fixes the gauge. The problem has the live counts, truncated at the
        caps. Timed as ``1.BA_build``; each problem's observations are
        sampled as ``1.BA_nobs``."""
        with self.prof.scope("1.BA_build"):
            built = self._build_window(m, new_kfid, max_kfs, max_lms, max_obs)
        if built is not None:
            self.prof.sample("1.BA_nobs", built[3]["n_obs"])
        return built

    def _build_window(self, m: MapStore, new_kfid: int, max_kfs: int,
                      max_lms: int, max_obs: int):
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

        kf_list = (opt_kfs + const_kfs)[:max_kfs]
        F, L = len(kf_list), len(lm_set)
        if all(k in opt_set for k in kf_list) and len(kf_list) > 1:
            opt_set.discard(kf_list[-1])
        kf_slot = {kfid: i for i, kfid in enumerate(kf_list)}

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
        O = min(len(okf), max_obs)
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
    def solver_settings(self, max_iters: int) -> dict:
        """The local BA solver's keywords: Schur-LM, or the Powell dogleg
        when use_dogleg (or use_subspace_dogleg) is set
        (optimizer.cpp:448-456)."""
        p = self.params
        return dict(invdepth=p.buse_inv_depth, max_iters=max_iters,
                    robust=True, th2_mono=p.robust_mono_th,
                    th2_stereo=p.robust_stereo_th,
                    l2_refine=p.apply_l2_after_robust,
                    method=("dogleg" if p.use_dogleg or p.use_subspace_dogleg
                            else "lm"))

    def _solve(self, prob, max_iters: int) -> ba_mod.BAResult:
        """The local BA solve (``solver_settings``); with a mesh the
        observation-sharded equivalent, its observations padded to a
        multiple of the shard count with invalid ones."""
        kw = self.solver_settings(max_iters)
        with self.prof.scope("1.BA_solve"):
            if self.mesh is None:
                return ba_mod.solve_ba(prob, **kw)
            prob = sharded.pad_observations(prob, len(self.mesh))
            r = sharded.solve_ba_sharded(prob, self.mesh, **kw)
            return ba_mod.BAResult(*(x.to(self.device) if torch.is_tensor(x)
                                     else x for x in r))

    def begin_local_ba(self, m: MapStore, new_kfid: int, max_iters: int = 5):
        """Build and solve the local BA of `new_kfid` and start the fetch of
        its results; ``finalize_local_ba`` writes them back later (the
        reference's Estimator thread runs BA beside tracking,
        estimator.cpp:32-98). Returns None when there is no problem."""
        built = self.build_problem(m, new_kfid)
        if built is None:
            return None
        prob, kf_list, lm_ids, meta = built
        result = self._solve(prob, max_iters)
        fetch = Fetch(result.R, result.t, result.Xw, result.lam,
                      result.obs_inlier, result.cost0, result.cost)
        return (kf_list, lm_ids, meta, fetch)

    def finalize_local_ba(self, m: MapStore, pending) -> BAOutcome:
        out = BAOutcome()
        if pending is None:
            return out
        kf_list, lm_ids, meta, fetch = pending
        with self.prof.scope("1.BA_fetch"):
            prefetched = fetch.result()
        return self._writeback(m, kf_list, lm_ids, meta, None, out,
                               prefetched=prefetched)

    def local_ba(self, m: MapStore, new_kfid: int, max_iters: int = 5
                 ) -> BAOutcome:
        built = self.build_problem(m, new_kfid)
        out = BAOutcome()
        if built is None:
            return out
        prob, kf_list, lm_ids, meta = built
        result = self._solve(prob, max_iters)
        return self._writeback(m, kf_list, lm_ids, meta, result, out)

    def _writeback(self, m, kf_list, lm_ids, meta, result, out,
                   prefetched=None) -> BAOutcome:
        """Poses, landmarks and the outlier sweep from `result`, or from its
        arrays already fetched (`prefetched`, in ``Fetch`` order)."""
        if prefetched is None:
            with self.prof.scope("1.BA_fetch"):
                prefetched = tuple(a.cpu().numpy() for a in (
                    result.R, result.t, result.Xw, result.lam,
                    result.obs_inlier, result.cost0, result.cost))
        with self.prof.scope("1.BA_writeback"):
            R_np, t_np, Xw_np, lam_np, inl, cost0_np, cost_np = prefetched
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

            # outlier sweep (optimizer.cpp:737-895): right-cam outliers
            # lose has_right; left-cam outliers lose the observation
            # (landmarks left without observers are culled)
            om = meta["obs_meta"]
            nO = len(om["kf"])
            bad = ~inl[:nO]
            n_out = int(bad.sum())
            if n_out:
                rbad = bad & om["right"]
                for kfid in np.unique(om["kf"][rbad]):
                    rec = m.keyframes.get(int(kfid))
                    if rec is not None:
                        rec.has_right[
                            om["slot"][rbad & (om["kf"] == kfid)]] = False
                for k in np.nonzero(bad & ~om["right"])[0]:
                    m.remove_obs(int(om["lm"][k]), int(om["kf"][k]))
            out.ran = True
            out.n_kfs = len(kf_list)
            out.n_lms = nL
            out.n_obs = meta["n_obs"]
            out.n_outliers = n_out
            out.cost0 = float(cost0_np)
            out.cost = float(cost_np)
            return out

    # ------------------------------------------------------------------
    def full_ba(self, m: MapStore, max_kfs: int = 512, max_lms: int = 16384,
                max_obs: int = 131072, max_iters: int = 12) -> BAOutcome:
        """Final full BA pass (Optimizer::fullBA, optimizer.cpp:1674-2333,
        run from write_results when do_full_ba): one Schur-PCG solve over
        every keyframe (gauge = the oldest); overlapping dense-window sweeps
        only beyond max_kfs keyframes."""
        return self.span_ba(m, sorted(m.keyframes), max_kfs, max_lms,
                            max_obs, max_iters)

    def span_ba(self, m: MapStore, kfs, max_kfs: int = 512,
                max_lms: int = 16384, max_obs: int = 131072,
                max_iters: int = 12, cg_iters: int = 48,
                time_budget_s: Optional[float] = None) -> BAOutcome:
        """One global solve over a keyframe span (the oldest 1 (stereo) or
        2 (mono) KFs fixed as gauge) by the Schur-PCG solver: the final
        full BA and the loose BA over a loop's [loop KF, new KF] range
        (optimizer.cpp:995-1024, :1674-2333). ``time_budget_s`` bounds wall
        time like the reference's max_solver_time (optimizer.cpp:460-468):
        LM iterations run in chunks with a clock check between them."""
        p = self.params
        kfs = [k for k in sorted(kfs) if k in m.keyframes]
        if len(kfs) < 3:
            return BAOutcome()
        if len(kfs) > max_kfs:
            return self.windowed_ba(m, kfs, 64, 8192, 32768, max_iters)
        newest = kfs[-1]
        gauge = set(kfs[:1 if p.stereo else 2])
        saved = dict(m.covis.get(newest, {}))
        try:
            # the whole span through the window builder: span KFs get a
            # covisibility score above nmin_covscore (optimized), the gauge
            # 0 (it re-enters as constant observers)
            m.covis[newest] = {k: (0 if k in gauge else 10_000)
                               for k in kfs if k != newest}
            built = self.build_problem(m, newest, max_kfs, max_lms, max_obs)
        finally:
            m.covis[newest] = saved
        out = BAOutcome()
        if built is None:
            return out
        prob, kf_list, lm_ids, meta = built
        if time_budget_s is None:
            result = ba_global.solve_ba_global(
                prob, invdepth=p.buse_inv_depth, max_iters=max_iters,
                robust=True, th2_mono=p.robust_mono_th,
                th2_stereo=p.robust_stereo_th, cg_iters=cg_iters,
                l2_refine=p.apply_l2_after_robust)
        else:
            result = self._solve_global_budgeted(prob, max_iters, cg_iters,
                                                 time_budget_s)
        return self._writeback(m, kf_list, lm_ids, meta, result, out)

    # LM iterations per budgeted chunk
    _BUDGET_CHUNK = 3

    def _solve_global_budgeted(self, prob, max_iters: int, cg_iters: int,
                               time_budget_s: float) -> ba_mod.BAResult:
        """Chunked Schur-PCG LM with a wall-clock check between chunks (Ceres'
        max_solver_time_in_seconds and the cooperative signalStopLocalBA,
        optimizer.cpp:460-468, :2334-2344). The best state carries across
        chunks (the damping restarts per chunk). The clock is read after
        the chunk's cost is on the host, so it measures the device work,
        not only its launch."""
        p = self.params
        kw = dict(invdepth=p.buse_inv_depth, max_iters=self._BUDGET_CHUNK,
                  th2_mono=p.robust_mono_th, th2_stereo=p.robust_stereo_th,
                  cg_iters=cg_iters, l2_refine=False)
        t0 = time.monotonic()
        cur, done, cost0, result = prob, 0, None, None
        while done < max_iters:
            r = ba_global.solve_ba_global(cur, robust=True, **kw)
            float(r.cost)                   # wait for the chunk
            done += self._BUDGET_CHUNK
            cost0 = r.cost0 if cost0 is None else cost0
            result = r._replace(cost0=cost0)
            cur = cur._replace(R=r.R, t=r.t, Xw=r.Xw, lam=r.lam)
            if time.monotonic() - t0 > time_budget_s:
                self.n_ba_timeouts += 1
                break
        if result is None:                  # max_iters <= 0: one chunk
            result = ba_global.solve_ba_global(cur, robust=True, **kw)
            cur = cur._replace(R=result.R, t=result.t, Xw=result.Xw,
                               lam=result.lam)
        if p.apply_l2_after_robust and time.monotonic() - t0 < time_budget_s:
            # L2 re-solve on the robust phase's inliers
            r2 = ba_global.solve_ba_global(
                cur._replace(obs_valid=result.obs_inlier), robust=False, **kw)
            float(r2.cost)
            result = ba_mod.BAResult(
                r2.R, r2.t, r2.Xw, r2.lam, r2.obs_inlier & result.obs_inlier,
                result.cost0, r2.cost, result.n_iters + r2.n_iters)
        return result

    def windowed_ba(self, m: MapStore, kfs, max_kfs: int = 64,
                    max_lms: int = 8192, max_obs: int = 32768,
                    max_iters: int = 10) -> BAOutcome:
        """Bundle-adjust a keyframe span beyond the global solver's
        capacity with overlapping dense windows, oldest to newest: each
        window re-optimizes its keyframes while the first half of its
        overlap with the previous window enters as constant anchors (the
        first window anchors on the oldest KF(s), optimizer.cpp:1736-1747)."""
        out = BAOutcome()
        kfs = sorted(kfs)
        if len(kfs) < 3:
            return out
        win = max_kfs - 2
        if len(kfs) <= win:
            windows = [kfs]
        else:
            stride = max(1, win // 2)
            starts = list(range(0, len(kfs) - win, stride)) + [len(kfs) - win]
            windows = [kfs[s:s + win] for s in starts]
        for wi, W in enumerate(windows):
            newest = W[-1]
            overlap = set(W[:max(1, win // 2)] if wi > 0
                          else W[:(1 if self.params.stereo else 2)])
            saved = dict(m.covis.get(newest, {}))
            try:
                m.covis[newest] = {k: (0 if k in overlap else 10_000)
                                   for k in W if k != newest}
                out = self.local_ba_with_caps(m, newest, max_kfs, max_lms,
                                              max_obs, max_iters)
            finally:
                m.covis[newest] = saved
        return out

    def local_ba_with_caps(self, m: MapStore, kfid: int, max_kfs: int,
                           max_lms: int, max_obs: int, max_iters: int,
                           structure_only: bool = False,
                           only_lmids=None) -> BAOutcome:
        """A BA window at other caps, poses and landmarks written back (no
        outlier sweep). ``structure_only`` holds every pose fixed and runs
        the block-diagonal solver (Optimizer::structureOnlyBA,
        optimizer.cpp:2594-2782); ``only_lmids`` refines exactly those
        landmarks, every other one constant."""
        built = self.build_problem(m, kfid, max_kfs, max_lms, max_obs)
        out = BAOutcome()
        if built is None:
            return out
        prob, kf_list, lm_ids, meta = built
        if structure_only:
            prob = prob._replace(pose_opt=torch.zeros_like(prob.pose_opt))
            meta["pose_opt"] = np.zeros_like(meta["pose_opt"])
        if only_lmids is not None:
            sel = np.isin(lm_ids, np.asarray(sorted(only_lmids), np.int64))
            keep = np.zeros(int(prob.lm_valid.shape[0]), bool)
            keep[:len(sel)] = sel
            prob = prob._replace(
                lm_valid=prob.lm_valid & torch.from_numpy(keep).to(self.device))
            meta["lm_valid"] = meta["lm_valid"] & keep
            if not keep.any():
                return out
        if structure_only:
            p = self.params
            result = ba_mod.solve_structure_only(
                prob, max_iters=max_iters, th2_mono=p.robust_mono_th,
                th2_stereo=p.robust_stereo_th)
        else:
            result = self._solve(prob, max_iters)
        R_np, t_np, Xw_np, lam_np, cost0, cost = Fetch(
            result.R, result.t, result.Xw, result.lam, result.cost0,
            result.cost).result()
        for i, kfid_i in enumerate(kf_list):
            if meta["pose_opt"][i]:
                T = np.eye(4, dtype=np.float32)
                T[:3, :3] = R_np[i]
                T[:3, 3] = t_np[i]
                m.keyframes[kfid_i].T_cw = T
        nL = len(lm_ids)
        in_prob = meta["lm_valid"][:nL]
        m.update_positions_from_ba(lm_ids[in_prob], Xw_np[:nL][in_prob],
                                   lam_np[:nL][in_prob])
        out.ran = True
        out.n_kfs = len(kf_list)
        out.n_lms = nL
        out.cost0 = float(cost0)
        out.cost = float(cost)
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
