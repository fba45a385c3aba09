"""Loop closing: online place recognition, geometric verification,
pose-graph correction and map merging (port of
``ov2slam_tpu/slam/loopcloser.py``).

Replaces the reference's LoopCloser thread (loop_closer.cpp): per keyframe,
feed its descriptors to the place index (``bow.LCDetector``); on a
candidate, reject covisible matches, kNN-match descriptors on the device,
pre-filter with the 5-point essential RANSAC, run the P3P RANSAC, grow the
match set with the loop keyframe's local map, and with a robust PnP of >= 30
inliers solve the local pose graph, recompute landmark positions from their
corrected anchors, merge the duplicated landmarks, refine them
(structure-only BA) and, when the correction is large, run a loose span BA.
The same machinery relocalizes a lost frame.

The RANSACs take their sample indices from ``self.draw(valid, n_hyps,
size, seed)``: by default ``mvg.draw_samples`` with a ``torch.Generator``
seeded as the JAX package seeds its key (``bdo_random=0`` pins every seed to
0); tests put the JAX package's own draw there.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from ov2slam_tpu_torch.core.camera import Camera
from ov2slam_tpu_torch.core.lie import SE3
from ov2slam_tpu_torch.device import resolve_device
from ov2slam_tpu_torch.io.profiler import Profiler
from ov2slam_tpu_torch.ops import describe as desc_mod
from ov2slam_tpu_torch.ops import mvg
from ov2slam_tpu_torch.opt import pnp as pnp_mod
from ov2slam_tpu_torch.opt import posegraph as pg_mod
from ov2slam_tpu_torch.slam import bow
from ov2slam_tpu_torch.slam import frontend as fe_mod
from ov2slam_tpu_torch.slam import mapper as mapper_mod
from ov2slam_tpu_torch.slam.frame import FrameKps
from ov2slam_tpu_torch.slam.map import MapStore

LOOSE_BA_MIN_JUMP = 0.02     # reference: loop_closer.cpp:368
N_PAD = 512                  # kNN / RANSAC correspondence slots


@dataclass
class LoopClosureEvent:
    query_kf: int
    match_kf: int
    n_inliers: int
    n_merged: int
    pose_jump: float           # |t| correction applied to the query KF
    n_pairs_init: int = 0      # matches vs the single candidate KF
    n_pairs_local: int = 0     # after the loop-local-map expansion


def _T(R, t) -> np.ndarray:
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = R
    T[:3, 3] = t
    return T


class LoopCloser:
    def __init__(self, params, cam_l: Camera, estimator=None, device=None,
                 draw: Optional[Callable] = None):
        self.params = params
        self.cam_l = cam_l
        self.estimator = estimator
        self.device = resolve_device(device)
        self.detector = bow.LCDetector()
        self.last_closure_kf = -10
        self.draw = draw or self._draw

    def _seed(self, i: int) -> int:
        """RANSAC seed; bdo_random=0 pins sampling
        (multi_view_geometry.cpp:207)."""
        return int(i) if self.params.bdo_random else 0

    def _draw(self, valid: torch.Tensor, n_hyps: int, size: int, seed: int
              ) -> torch.Tensor:
        gen = torch.Generator(device=valid.device)
        gen.manual_seed(seed)
        return mvg.draw_samples(valid, n_hyps, size, gen)

    def _up(self, a: np.ndarray) -> torch.Tensor:
        """Host array -> device tensor (uint32 words become int64)."""
        a = np.ascontiguousarray(a)
        if a.dtype == np.uint32:
            a = a.astype(np.int64)
        return torch.from_numpy(a).to(self.device)

    def _knn(self, desc_a, valid_a, desc_b, valid_b):
        best, bd, sd = desc_mod.knn2_match(self._up(desc_a), self._up(valid_a),
                                           self._up(desc_b), self._up(valid_b))
        return tuple(x.cpu().numpy() for x in (best, bd, sd))

    def _p3p(self, Xw, bv, val, seed: int):
        """P3P RANSAC (512 hypotheses) on padded correspondences."""
        focal = 0.5 * (self.cam_l.fx + self.cam_l.fy)
        val_d = self._up(val)
        return mvg.p3p_ransac(
            self._up(Xw), self._up(bv), val_d,
            err_th_norm=self.params.fransac_err / focal,
            idx=self.draw(val_d, 512, 3, seed))

    def _pnp(self, T_est: SE3, Xw, unpx, valid):
        return pnp_mod.pnp_robust_then_l2(
            fe_mod.calib_of(self.cam_l), T_est, self._up(Xw), self._up(unpx),
            valid, robust_th2=self.params.robust_mono_th)

    # ------------------------------------------------------------------
    def process_kf(self, m: MapStore, kfid: int) -> Optional[LoopClosureEvent]:
        """An event if a loop was closed at keyframe `kfid` (the run loop
        of loop_closer.cpp:65-184)."""
        rec = m.keyframes.get(kfid)
        if rec is None:
            return None
        dmask = rec.valid & rec.desc_ok & (rec.lmid >= 0)
        descs = rec.desc[dmask]
        if rec.extra_desc is not None and len(rec.extra_desc):
            descs = np.concatenate([descs, rec.extra_desc], axis=0)
        cand = self.detector.process(kfid, descs)
        if cand is None or kfid - self.last_closure_kf < 5:
            return None
        # a culled match resolves to the best-scored surviving member of
        # the winning island (every member received index votes)
        match_kf = cand.match_kf
        if match_kf not in m.keyframes:
            alive = [(k, s) for k, s in cand.island if k in m.keyframes]
            if not alive:
                return None
            match_kf = max(alive, key=lambda t: t[1])[0]
        # covisibility rejection (loop_closer.cpp:201-209): a strongly
        # covisible "loop" is just the local map
        if m.covis.get(kfid, {}).get(match_kf, 0) > 10:
            return None
        ev = self._verify_and_close(m, kfid, match_kf)
        if ev is not None:
            self.last_closure_kf = kfid
        return ev

    # ------------------------------------------------------------------
    def relocalize(self, m: MapStore, descs: np.ndarray, desc_valid,
                   bvs: np.ndarray, unpxs: np.ndarray):
        """Relocalization from total tracking loss: query the place index
        with the lost frame's descriptors (without inserting), verify the
        best candidates geometrically (kNN + P3P + robust PnP). Returns
        (world-to-cam pose, candidate KF) or None. The arrays are padded,
        `desc_valid` marks the live rows."""
        if desc_valid.sum() < 20:
            return None
        for cand_kf, _score in self.index_query(descs[desc_valid])[:3]:
            if cand_kf not in m.keyframes:
                continue
            T = self._match_and_pnp(m, cand_kf, descs, desc_valid, bvs, unpxs)
            if T is not None:
                return T, cand_kf
        return None

    def index_query(self, descs: np.ndarray):
        return self.detector.index.query(descs, max_image_id=1 << 30, topk=5)

    def _match_and_pnp(self, m: MapStore, cand_kf: int, descs, desc_valid,
                       bvs, unpxs):
        p = self.params
        mrec = m.keyframes[cand_kf]
        loop_mask = mrec.valid & mrec.desc_ok & mrec.is3d & (mrec.lmid >= 0)
        if loop_mask.sum() < 20:
            return None
        best, bd, sd = self._knn(descs, desc_valid, mrec.desc, loop_mask)
        good = (desc_valid & (bd <= 0.85 * sd)
                & (bd < p.fmax_desc_dist * 2.0 * 256))
        if good.sum() < 15:
            return None
        N = N_PAD
        Xw = np.zeros((N, 3), np.float32)
        bv = np.zeros((N, 3), np.float32)
        bv[:, 2] = 1.0
        unpx = np.zeros((N, 2), np.float32)
        val = np.zeros(N, bool)
        j = 0
        for i in np.nonzero(good)[0]:
            lm = int(mrec.lmid[best[i]])
            if lm < 0 or not (m.lm_valid[lm] and m.lm_is3d[lm]) or j >= N:
                continue
            Xw[j], bv[j], unpx[j], val[j] = m.lm_pos[lm], bvs[i], unpxs[i], True
            j += 1
        if j < 15:
            return None
        T_est, inl, n_in, okflag = self._p3p(Xw, bv, val, self._seed(cand_kf))
        pnp = self._pnp(T_est, Xw, unpx, inl)
        okflag, n_in, n_pnp, R_np, t_np = (a.cpu().numpy() for a in (
            okflag, n_in, pnp.n_inliers, pnp.T_cw.R, pnp.T_cw.t))
        if not bool(okflag) or int(n_in) < 10 or int(n_pnp) < 30:
            return None
        return _T(R_np, t_np)

    # ------------------------------------------------------------------
    def _verify_and_close(self, m: MapStore, kfid: int, match_kf: int
                          ) -> Optional[LoopClosureEvent]:
        p = self.params
        rec = m.keyframes[kfid]
        mrec = m.keyframes[match_kf]

        # kNN descriptor matching current -> loop KF (loop_closer.cpp:378)
        cur_mask = rec.valid & rec.desc_ok & (rec.lmid >= 0)
        loop_mask = mrec.valid & mrec.desc_ok & mrec.is3d & (mrec.lmid >= 0)
        if cur_mask.sum() < 20 or loop_mask.sum() < 20:
            return None
        best, bd, sd = self._knn(rec.desc, cur_mask, mrec.desc, loop_mask)
        good = (cur_mask & (bd <= 0.85 * sd)
                & (bd < p.fmax_desc_dist * 2.0 * 256))
        if good.sum() < 15:
            return None

        # epipolar pre-filter (loop_closer.cpp:462-499): a 5-point
        # essential RANSAC over the kNN matches drops gross outliers before
        # the P3P + PnP cascade
        gi = np.nonzero(good)[0]
        bva = np.zeros((N_PAD, 3), np.float32)
        bva[:, 2] = 1.0
        bvb = bva.copy()
        evalid = np.zeros(N_PAD, bool)
        ne = min(len(gi), N_PAD)
        bva[:ne] = mrec.bv[best[gi[:ne]]]
        bvb[:ne] = rec.bv[gi[:ne]]
        evalid[:ne] = True
        focal = 0.5 * (self.cam_l.fx + self.cam_l.fy)
        ev_d = self._up(evalid)
        eres = mvg.essential_ransac(
            self._up(bva), self._up(bvb), ev_d, err_th=p.fransac_err / focal,
            idx=self.draw(ev_d, 1024, 5, self._seed(kfid ^ 0x5A5A)))
        esucc, einl = (a.cpu().numpy() for a in (eres.success, eres.inliers))
        if bool(esucc):
            good[gi[:ne][~einl[:ne]]] = False
            if good.sum() < 15:
                return None

        # matched pairs: current kp slot -> loop landmark id
        pairs = []
        for i in np.nonzero(good)[0]:
            lm = int(mrec.lmid[best[i]])
            if lm >= 0 and m.lm_valid[lm] and m.lm_is3d[lm]:
                pairs.append((int(i), lm))
        if len(pairs) < 15:
            return None

        # P3P RANSAC on the loop landmarks vs the current bearings
        Xw, bv, unpx, val = self._pad_pairs(m, rec, pairs, N_PAD)
        T_est, _, n_in, okflag = self._p3p(Xw, bv, val, self._seed(kfid))
        okflag, n_in = okflag.cpu().numpy(), n_in.cpu().numpy()
        if not bool(okflag) or int(n_in) < 10:
            return None

        # loop-local-map expansion (trackLoopLocalMap,
        # loop_closer.cpp:502-583), then PnP with >= 30 inliers
        n_pairs_init = len(pairs)
        pairs = self._expand_loop_matches(m, rec, match_kf, pairs, T_est)
        n_pairs_local = len(pairs)
        N = 1 << max(9, (rec.px.shape[0] - 1).bit_length())
        Xw, bv, unpx, val = self._pad_pairs(m, rec, pairs, N)
        pnp = self._pnp(T_est, Xw, unpx, self._up(val))
        n_inl, R_np, t_np, inl_np = (a.cpu().numpy() for a in (
            pnp.n_inliers, pnp.T_cw.R, pnp.T_cw.t, pnp.inliers))
        n_inl = int(n_inl)
        if n_inl < 30:           # reference threshold (loop_closer.cpp:304)
            return None

        # corrected pose of the query KF
        T_corr = _T(R_np, t_np)
        jump = float(np.linalg.norm(
            np.linalg.inv(T_corr)[:3, 3] - np.linalg.inv(rec.T_cw)[:3, 3]))
        # local pose graph over [match_kf .. kfid] (optimizer.cpp:2346)
        self._pose_graph_correct(m, match_kf, kfid, T_corr)
        self._recompute_landmarks(m)

        # merge the verified landmark pairs (map_manager.cpp:801-882)
        mdst, msrc = [], []
        for j, (s, lm) in enumerate(pairs[:N]):
            if not inl_np[j]:
                continue
            src = int(rec.lmid[s])
            if src >= 0 and src != lm:
                mdst.append(lm)
                msrc.append(src)
        with Profiler.instance().scope("2.LC_MergeBookkeeping"):
            n_merged = m.merge_landmarks_batch(mdst, msrc)
            m.update_covisibility(kfid)

        # structure-only refinement of exactly the merged landmarks
        # (Optimizer::structureOnlyBA, optimizer.cpp:2594-2782;
        # loop_closer.cpp:353)
        if self.estimator is not None and n_merged > 0:
            with Profiler.instance().scope("1.BA_structureOnly"):
                self.estimator.local_ba_with_caps(
                    m, kfid, max_kfs=24, max_lms=4096, max_obs=16384,
                    max_iters=3, structure_only=True,
                    only_lmids={d for d in mdst if m.lm_valid[d]})

        # loose BA over the loop span when the correction was large
        # (looseBA, optimizer.cpp:900-1673, at pose error >= 0.02,
        # loop_closer.cpp:368), wall-clock bounded like the reference's
        # max_solver_time (optimizer.cpp:460-468)
        if self.estimator is not None and jump >= LOOSE_BA_MIN_JUMP:
            span = sorted(k for k in m.keyframes if match_kf <= k <= kfid)
            if len(span) >= 3:
                with Profiler.instance().scope("1.BA_looseBA"):
                    self.estimator.span_ba(
                        m, span, max_iters=6,
                        time_budget_s=p.lc_loose_ba_time_s or None)
                self._recompute_landmarks(m)

        return LoopClosureEvent(
            query_kf=kfid, match_kf=match_kf, n_inliers=n_inl,
            n_merged=n_merged, pose_jump=jump, n_pairs_init=n_pairs_init,
            n_pairs_local=n_pairs_local)

    @staticmethod
    def _pad_pairs(m: MapStore, rec, pairs, N: int):
        """(Xw, bv, unpx, valid) of the first N (kp slot, landmark) pairs,
        padded to N rows."""
        Xw = np.zeros((N, 3), np.float32)
        bv = np.zeros((N, 3), np.float32)
        bv[:, 2] = 1.0
        unpx = np.zeros((N, 2), np.float32)
        val = np.zeros(N, bool)
        for j, (s, lm) in enumerate(pairs[:N]):
            Xw[j], bv[j], unpx[j], val[j] = m.lm_pos[lm], rec.bv[s], rec.unpx[s], True
        return Xw, bv, unpx, val

    # ------------------------------------------------------------------
    def _expand_loop_matches(self, m: MapStore, rec, match_kf: int, pairs,
                             T_est: SE3, max_cands: int = 2048):
        """Grow the (query kp slot, loop landmark) pairs with the loop KF's
        local map (LoopCloser::trackLoopLocalMap, loop_closer.cpp:502-583:
        covisible KFs within +/-15 ids, projected matching within 10 px).
        Returns the extended pair list."""
        p = self.params
        matched_slots = {s for s, _ in pairs}
        matched_lms = {lm for _, lm in pairs}
        groups = []
        for ckf in [match_kf] + [k for k in m.covisible_kfs(match_kf)
                                 if abs(k - match_kf) <= 15]:
            crec = m.keyframes.get(ckf)
            if crec is not None:
                groups.append(crec.lmid[crec.valid & crec.is3d & (crec.lmid >= 0)])
        if not groups:
            return pairs
        ids = np.unique(np.concatenate(groups))
        ids = ids[m.lm_valid[ids] & m.lm_is3d[ids]]

        # landmarks the query KF already observes join directly
        # (loop_closer.cpp:545-552)
        local_set = set(int(x) for x in ids) - matched_lms
        for s in np.nonzero(rec.valid & (rec.lmid >= 0))[0]:
            lm = int(rec.lmid[s])
            if lm in local_set and s not in matched_slots:
                pairs.append((int(s), lm))
                matched_slots.add(int(s))
                matched_lms.add(lm)
                local_set.discard(lm)

        cand = np.asarray([lm for lm in local_set if m.lm_desc_ok[lm]],
                          np.int64)[:max_cands]
        if len(cand) == 0:
            return pairs
        M = max_cands
        pos = np.zeros((M, 3), np.float32)
        cdesc = np.zeros((M, 8), np.uint32)
        cvalid = np.zeros(M, bool)
        pos[:len(cand)] = m.lm_pos[cand]
        cdesc[:len(cand)] = m.lm_desc[cand]
        cvalid[:len(cand)] = True
        matchable = rec.valid & rec.desc_ok
        matchable[list(matched_slots)] = False
        snap = FrameKps.empty(rec.px.shape[0], device=self.device)._replace(
            px=self._up(rec.px), valid=self._up(rec.valid))
        res = mapper_mod.match_to_local_map(
            snap, self._up(rec.desc), self._up(rec.desc_ok),
            self._up(matchable), self._up(pos), self._up(cdesc),
            self._up(cvalid), self.cam_l, T_est.R, T_est.t,
            max_px_dist=10.0,                       # loop_closer.cpp:269
            max_desc_dist=p.fmax_desc_dist * 1.5)
        ok_np, slot_np = res.ok.cpu().numpy(), res.kp_slot.cpu().numpy()
        for ci in np.nonzero(ok_np)[0]:
            s = int(slot_np[ci])
            if s < 0 or s in matched_slots:
                continue
            pairs.append((s, int(cand[ci])))
            matched_slots.add(s)
        return pairs

    # ------------------------------------------------------------------
    def _pose_graph_correct(self, m: MapStore, loop_kf: int, new_kf: int,
                            T_corr_new: np.ndarray):
        """Chain + loop-edge pose graph over [loop_kf .. new_kf], the loop KF
        gauge-fixed; corrected poses written back; newer keyframes follow
        new_kf's correction (optimizer.cpp:2346-2592)."""
        kf_ids = sorted(k for k in m.keyframes if loop_kf <= k <= new_kf)
        if len(kf_ids) < 3:
            m.keyframes[new_kf].T_cw = T_corr_new.copy()
            return
        F = 1 << max(3, (len(kf_ids) - 1).bit_length())
        E = F + 4
        R = np.tile(np.eye(3, dtype=np.float32), (F, 1, 1))
        t = np.zeros((F, 3), np.float32)
        opt = np.zeros(F, bool)
        for i, k in enumerate(kf_ids):
            T = m.keyframes[k].T_cw
            R[i], t[i], opt[i] = T[:3, :3], T[:3, 3], i != 0
        ei = np.zeros(E, np.int64)
        ej = np.zeros(E, np.int64)
        mR = np.tile(np.eye(3, dtype=np.float32), (E, 1, 1))
        mt = np.zeros((E, 3), np.float32)
        w = np.zeros(E, np.float32)

        def edge(n, i, j, Trel):
            ei[n], ej[n], w[n] = i, j, 1.0
            mR[n] = Trel[:3, :3].astype(np.float32)
            mt[n] = Trel[:3, 3].astype(np.float32)

        for i in range(1, len(kf_ids)):
            Ta = m.keyframes[kf_ids[i]].T_cw.astype(np.float64)
            Tb = m.keyframes[kf_ids[i - 1]].T_cw.astype(np.float64)
            edge(i - 1, i, i - 1, Ta @ np.linalg.inv(Tb))
        # loop edge: corrected relative pose new-vs-loop, unit weight like
        # the chain edges (optimizer.cpp:2420-2423)
        T_loop = m.keyframes[loop_kf].T_cw.astype(np.float64)
        edge(len(kf_ids) - 1, len(kf_ids) - 1, 0,
             T_corr_new.astype(np.float64) @ np.linalg.inv(T_loop))
        to = lambda a: torch.from_numpy(a).to(self.device)  # noqa: E731
        out = pg_mod.solve_pose_graph(pg_mod.PoseGraphProblem(
            to(R), to(t), to(opt), to(ei), to(ej), to(mR), to(mt), to(w)),
            max_iters=10)
        R_new, t_new = out.R.cpu().numpy(), out.t.cpu().numpy()
        for i, k in enumerate(kf_ids):
            m.keyframes[k].T_cw = _T(R_new[i], t_new[i])
        # keyframes newer than new_kf follow its correction
        # (optimizer.cpp:2527)
        newer = [k for k in m.keyframes if k > new_kf]
        if newer:
            T_old = np.eye(4)
            T_old[:3, :3] = R[len(kf_ids) - 1]
            T_old[:3, 3] = t[len(kf_ids) - 1]
            corr = np.linalg.inv(T_old) @ m.keyframes[new_kf].T_cw.astype(np.float64)
            for k in newer:
                m.keyframes[k].T_cw = (
                    m.keyframes[k].T_cw.astype(np.float64) @ corr
                ).astype(np.float32)

    # ------------------------------------------------------------------
    def _recompute_landmarks(self, m: MapStore):
        """Anchored landmarks follow their anchor keyframes: world positions
        from (anchor pose, bearing, inverse depth), one pose inversion per
        anchor KF; the device mirrors are marked stale."""
        ids = np.nonzero(m.lm_valid & m.lm_is3d)[0]
        if len(ids) == 0:
            return
        anchors = m.lm_anchor[ids]
        kf_ids = np.unique(anchors)
        live = np.asarray([int(k) in m.keyframes for k in kf_ids])
        T_wa = np.tile(np.eye(4), (len(kf_ids), 1, 1))
        for i in np.nonzero(live)[0]:
            T_wa[i] = np.linalg.inv(
                m.keyframes[int(kf_ids[i])].T_cw.astype(np.float64))
        idx = np.searchsorted(kf_ids, anchors)
        keep = live[idx]
        ids, idx = ids[keep], idx[keep]
        Xa = m.lm_bearing[ids] / np.maximum(m.lm_lam[ids][:, None], 1e-9)
        m.lm_pos[ids] = (
            np.einsum("nij,nj->ni", T_wa[idx, :3, :3], Xa) + T_wa[idx, :3, 3]
        ).astype(np.float32)
        m._device_dirty = True
