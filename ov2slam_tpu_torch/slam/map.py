"""Map store: landmarks + keyframes + covisibility (port of
``ov2slam_tpu/slam/map.py``).

Replaces the reference's MapManager + MapPoint + keyframe side of Frame
(map_manager.cpp, map_point.cpp). The host bookkeeping — identity, the
observation sets, covisibility counts and keyframe records in numpy and
dicts — is the JAX package's, carried over as is. Only the device mirrors
differ: ``device_landmarks`` / ``device_lm_valid`` return torch tensors on
the store's device. (The JAX ``MapStore`` cannot be subclassed: its module
imports jax.)
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Set

import numpy as np
import torch


@dataclass
class KeyframeRecord:
    """Host snapshot of a keyframe (reference: deep-copied Frame,
    map_manager.cpp:621-633)."""

    kfid: int
    time: float
    T_cw: np.ndarray          # (4, 4)
    # keypoint table snapshot (numpy copies of FrameKps)
    px: np.ndarray
    unpx: np.ndarray
    bv: np.ndarray
    lmid: np.ndarray
    valid: np.ndarray
    is3d: np.ndarray
    rpx: np.ndarray
    has_right: np.ndarray
    desc: np.ndarray          # (K, 8) uint32 BRIEF
    desc_ok: np.ndarray       # (K,) bool
    extra_desc: np.ndarray = None   # (C, 8) place-recognition-only corners


    def kp_slot_of(self, lmid: int) -> int:
        hits = np.nonzero((self.lmid == lmid) & self.valid)[0]
        return int(hits[0]) if len(hits) else -1

    def kp_slots_of(self, lmids: np.ndarray) -> np.ndarray:
        """Vectorized slot lookup: (M,) lmids -> (M,) slots (-1 = absent)."""
        vs = np.nonzero(self.valid & (self.lmid >= 0))[0]
        if len(vs) == 0:
            return np.full(len(lmids), -1, np.int64)
        keys = self.lmid[vs]
        order = np.argsort(keys, kind="stable")
        sk = keys[order]
        pos = np.minimum(np.searchsorted(sk, lmids), len(sk) - 1)
        ok = sk[pos] == lmids
        return np.where(ok, vs[order[pos]], -1)


class MapStore:
    """Host map with device landmark arenas."""

    def __init__(self, lm_capacity: int = 1 << 16, dtype=np.float32,
                 kf_capacity: int = 1 << 11, device=None):
        self.device = torch.device("cpu") if device is None else torch.device(device)
        self.cap = lm_capacity
        # planning ceiling for keyframe count (SlamParams.kf_capacity):
        # sizes the pose-graph padding expectations; exceeding it is legal
        # (the KF registry is a host dict) but warned once
        self.kf_capacity = kf_capacity
        self._kf_cap_warned = False
        # landmark arenas (host numpy; device mirrors pushed on demand)
        self.lm_pos = np.zeros((lm_capacity, 3), dtype)
        self.lm_lam = np.ones((lm_capacity,), dtype)        # inverse depth
        self.lm_anchor = np.full((lm_capacity,), -1, np.int32)
        self.lm_bearing = np.zeros((lm_capacity, 3), dtype) # anchor-frame, z=1
        self.lm_valid = np.zeros((lm_capacity,), bool)
        self.lm_is3d = np.zeros((lm_capacity,), bool)
        self.lm_desc = np.zeros((lm_capacity, 8), np.uint32)
        self.lm_desc_ok = np.zeros((lm_capacity,), bool)
        # per-bit vote counts for the "most representative descriptor"
        # (map_point.cpp:164-213 keeps the min-median-distance descriptor;
        # bitwise majority over all observations approximates it in O(1))
        self.lm_bit_votes = np.zeros((lm_capacity, 256), np.uint16)
        self.lm_desc_n = np.zeros((lm_capacity,), np.uint16)
        # observation bookkeeping: lmid -> {kfid}
        self.lm_obs: Dict[int, Set[int]] = {}
        self._free: List[int] = list(range(lm_capacity - 1, -1, -1))
        # keyframes
        self.keyframes: Dict[int, KeyframeRecord] = {}
        # covisibility: kfid -> {kfid: shared-3d-landmark count}
        self.covis: Dict[int, Dict[int, int]] = {}
        self.next_kf_id = 0
        self._device_dirty = True
        self._dev_pos = None
        self._dev_is3d = None
        self._dev_valid = None

    # ------------------------------------------------------------------
    # landmarks
    # ------------------------------------------------------------------

    def _grow(self, min_cap: int):
        """Double the landmark arena until it holds min_cap slots. Rare (a
        handful of times on KITTI-length sequences); each growth changes the
        device-array shapes and therefore costs one re-jit of the tracking
        step — logged so long-run perf regressions are attributable."""
        new_cap = self.cap
        while new_cap < min_cap:
            new_cap *= 2
        if new_cap == self.cap:
            return
        import sys
        print(f"[map] growing landmark arena {self.cap} -> {new_cap}",
              file=sys.stderr)
        extra = new_cap - self.cap

        def pad(a, fill=0):
            shape = (extra,) + a.shape[1:]
            return np.concatenate([a, np.full(shape, fill, a.dtype)])

        self.lm_pos = pad(self.lm_pos)
        self.lm_lam = pad(self.lm_lam, 1)
        self.lm_anchor = pad(self.lm_anchor, -1)
        self.lm_bearing = pad(self.lm_bearing)
        self.lm_valid = pad(self.lm_valid, False)
        self.lm_is3d = pad(self.lm_is3d, False)
        self.lm_desc = pad(self.lm_desc)
        self.lm_desc_ok = pad(self.lm_desc_ok, False)
        self.lm_bit_votes = pad(self.lm_bit_votes)
        self.lm_desc_n = pad(self.lm_desc_n)
        # new slots go to the back of the free stack (popped last)
        self._free = list(range(new_cap - 1, self.cap - 1, -1)) + self._free
        self.cap = new_cap
        self._device_dirty = True

    def alloc_landmarks(self, n: int) -> np.ndarray:
        if len(self._free) < n:
            self._grow(self.cap + (n - len(self._free)))
        ids = np.asarray([self._free.pop() for _ in range(n)], np.int32)
        for i in ids:
            self.lm_obs[int(i)] = set()
        self.lm_valid[ids] = True
        self.lm_is3d[ids] = False
        self.lm_desc_ok[ids] = False
        self.lm_bit_votes[ids] = 0
        self.lm_desc_n[ids] = 0
        self._device_dirty = True
        return ids

    def free_landmarks(self, lmids):
        """Return never-used candidate ids to the free list (no observations
        or keyframe references exist yet)."""
        for i in lmids:
            i = int(i)
            if self.lm_valid[i]:
                self.lm_valid[i] = False
                self.lm_is3d[i] = False
                self.lm_obs.pop(i, None)
                self._free.append(i)
        self._device_dirty = True

    def remove_landmark(self, lmid: int):
        if not self.lm_valid[lmid]:
            return
        for kfid in self.lm_obs.get(lmid, ()):  # drop from KF tables
            kf = self.keyframes.get(kfid)
            if kf is not None:
                m = kf.lmid == lmid
                kf.valid[m] = False
        self._covis_remove_lm(lmid)
        self.lm_valid[lmid] = False
        self.lm_is3d[lmid] = False
        self.lm_obs.pop(lmid, None)
        self._free.append(int(lmid))
        self._device_dirty = True

    def set_positions(self, lmids: np.ndarray, pos: np.ndarray,
                      anchor_kf=None,
                      bearings: Optional[np.ndarray] = None,
                      lams: Optional[np.ndarray] = None):
        """Mark landmarks as triangulated (is3d) with world positions.
        anchor_kf may be a scalar or a per-landmark array."""
        self.lm_pos[lmids] = pos
        self.lm_is3d[lmids] = True
        if anchor_kf is not None:
            self.lm_anchor[lmids] = anchor_kf
        if bearings is not None:
            self.lm_bearing[lmids] = bearings
        if lams is not None:
            self.lm_lam[lmids] = lams
        self._device_dirty = True

    def first_obs_of(self, lmids: np.ndarray) -> np.ndarray:
        """(M,) first (oldest) observing keyframe per landmark, -1 if none."""
        return np.asarray(
            [min(self.lm_obs[i]) if self.lm_obs.get(int(i)) else -1
             for i in np.asarray(lmids).tolist()], np.int32)

    def update_positions_from_ba(self, lmids, pos, lams):
        self.lm_pos[lmids] = pos
        self.lm_lam[lmids] = lams
        self._device_dirty = True

    def add_descriptor(self, lmid: int, desc: np.ndarray):
        self.add_descriptors(np.asarray([lmid]), desc[None])

    def add_descriptors(self, lmids: np.ndarray, descs: np.ndarray):
        """Accumulate per-bit votes and refresh the majority-bit
        representative descriptor (vectorized over all of a keyframe's
        landmarks at once)."""
        bits = np.unpackbits(
            descs.astype(np.uint32).view(np.uint8), axis=1, bitorder="little")
        self.lm_bit_votes[lmids] += bits.astype(np.uint16)
        self.lm_desc_n[lmids] += 1
        n = self.lm_desc_n[lmids][:, None]
        maj = (2 * self.lm_bit_votes[lmids] >= n).astype(np.uint8)
        packed = np.packbits(maj, axis=1, bitorder="little")
        self.lm_desc[lmids] = packed.view(np.uint32).reshape(-1, 8)
        self.lm_desc_ok[lmids] = True

    # ------------------------------------------------------------------
    # device mirrors
    # ------------------------------------------------------------------

    def device_landmarks(self):
        """(pos (L,3), is3d (L,)) as tensors on the store's device, cached
        until mutation."""
        if self._device_dirty or self._dev_pos is None:
            to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(self.device)  # noqa: E731
            self._dev_pos = to(self.lm_pos)
            self._dev_is3d = to(self.lm_is3d & self.lm_valid)
            self._dev_valid = to(self.lm_valid)
            self._device_dirty = False
        return self._dev_pos, self._dev_is3d

    def device_lm_valid(self):
        self.device_landmarks()
        return self._dev_valid

    # ------------------------------------------------------------------
    # keyframes + covisibility
    # ------------------------------------------------------------------

    def add_keyframe(self, rec: KeyframeRecord):
        self.keyframes[rec.kfid] = rec
        self.covis.setdefault(rec.kfid, {})
        self.next_kf_id = max(self.next_kf_id, rec.kfid + 1)
        if len(self.keyframes) > self.kf_capacity and not self._kf_cap_warned:
            self._kf_cap_warned = True
            import warnings
            warnings.warn(
                f"keyframe count exceeded kf_capacity={self.kf_capacity}; "
                "pose-graph problems will pad past the planned ceiling "
                "(raise kf_capacity to silence)", stacklevel=2)
        # register observations
        for slot in np.nonzero(rec.valid & (rec.lmid >= 0))[0]:
            lmid = int(rec.lmid[slot])
            if lmid in self.lm_obs:
                self.lm_obs[lmid].add(rec.kfid)
        self.update_covisibility(rec.kfid)

    def remove_keyframe(self, kfid: int):
        """KF culling (reference: map_manager.cpp:885-1051): keep landmark
        and covisibility structures consistent."""
        rec = self.keyframes.pop(kfid, None)
        if rec is None:
            return
        for lmid, obs in list(self.lm_obs.items()):
            obs.discard(kfid)
            if not obs and self.lm_valid[lmid]:
                self.remove_landmark(lmid)
            elif self.lm_anchor[lmid] == kfid and obs:
                # re-anchor to the oldest remaining observer
                self._reanchor(lmid, min(obs))
        for other in self.covis.pop(kfid, {}):
            self.covis.get(other, {}).pop(kfid, None)

    def _reanchor(self, lmid: int, new_kf: int):
        kf = self.keyframes.get(new_kf)
        if kf is None or not self.lm_is3d[lmid]:
            self.lm_anchor[lmid] = new_kf
            return
        slot = kf.kp_slot_of(lmid)
        T = kf.T_cw
        Xc = T[:3, :3] @ self.lm_pos[lmid] + T[:3, 3]
        z = max(float(Xc[2]), 1e-6)
        self.lm_anchor[lmid] = new_kf
        self.lm_lam[lmid] = 1.0 / z
        self.lm_bearing[lmid] = Xc / z
        self._device_dirty = True

    def remove_obs(self, lmid: int, kfid: int):
        obs = self.lm_obs.get(lmid)
        if obs is None:
            return
        obs.discard(kfid)
        kf = self.keyframes.get(kfid)
        if kf is not None:
            m = kf.lmid == lmid
            kf.valid[m] = False
        if not obs:
            self.remove_landmark(lmid)

    def merge_landmarks(self, dst: int, src: int):
        """Merge landmark src into dst (reference: MapManager::mergeMapPoints,
        map_manager.cpp:801-882): transfer observations (KF keypoint slots
        re-pointed to dst), keep dst's geometry, drop src."""
        if dst == src or not self.lm_valid[dst] or not self.lm_valid[src]:
            return
        for kfid in list(self.lm_obs.get(src, ())):
            kf = self.keyframes.get(kfid)
            if kf is not None:
                m = (kf.lmid == src)
                if kfid in self.lm_obs.get(dst, ()):
                    # dst already seen there: drop the duplicate keypoint
                    kf.valid[m] = False
                else:
                    kf.lmid[m] = dst
                    self.lm_obs[dst].add(kfid)
        self.lm_obs[src] = set()
        self.remove_landmark(src)
        self._device_dirty = True

    def merge_landmarks_batch(self, dsts, srcs) -> int:
        """Merge many (dst, src) pairs at once (loop-closure events merge
        100s of landmarks; the per-pair path scans every observing KF's full
        keypoint table per call). Grouping by keyframe turns the bookkeeping
        into one vectorized re-point pass per affected KF. Falls back to the
        scalar path when pairs chain (a src that is another pair's dst), so
        sequential semantics are preserved exactly. Returns merge count."""
        keep = [(int(d), int(s)) for d, s in zip(dsts, srcs)
                if int(d) != int(s)
                and self.lm_valid[int(d)] and self.lm_valid[int(s)]]
        seen: Set[int] = set()
        pairs = []
        for d, s in keep:
            if s not in seen:
                pairs.append((d, s))
                seen.add(s)
        if not pairs:
            return 0
        if {d for d, _ in pairs} & seen:
            n = 0
            for d, s in pairs:
                if self.lm_valid[d] and self.lm_valid[s]:
                    self.merge_landmarks(d, s)
                    n += 1
            return n
        dst_arr = np.asarray([d for d, _ in pairs])
        src_arr = np.asarray([s for _, s in pairs])
        remap = np.full(self.cap, -1, np.int64)
        remap[src_arr] = dst_arr
        kfs: Set[int] = set()
        for s in src_arr.tolist():
            kfs |= self.lm_obs.get(s, set())
        for kfid in kfs:
            kf = self.keyframes.get(kfid)
            if kf is None:
                continue
            lm = kf.lmid
            live = kf.valid & (lm >= 0)
            sel = np.nonzero(live & (remap[np.clip(lm, 0, self.cap - 1)] >= 0)
                             )[0]
            if len(sel) == 0:
                continue
            have = set(lm[live].tolist())
            for slot, d in zip(sel.tolist(), remap[lm[sel]].tolist()):
                if d in have or kfid in self.lm_obs.get(d, ()):
                    # dst already observed here: drop the duplicate keypoint
                    kf.valid[slot] = False
                else:
                    kf.lmid[slot] = d
                    self.lm_obs[d].add(kfid)
                    have.add(d)
        for s in src_arr.tolist():
            self.lm_obs[s] = set()
            self.remove_landmark(s)
        self._device_dirty = True
        return len(pairs)

    def update_covisibility(self, kfid: int):
        """Recount shared 3D landmarks between kfid and all co-observers
        (reference: map_manager.cpp:117-193)."""
        rec = self.keyframes[kfid]
        counts: Dict[int, int] = {}
        for slot in np.nonzero(rec.valid & rec.is3d & (rec.lmid >= 0))[0]:
            lmid = int(rec.lmid[slot])
            for other in self.lm_obs.get(lmid, ()):
                if other != kfid:
                    counts[other] = counts.get(other, 0) + 1
        self.covis[kfid] = counts
        for other, c in counts.items():
            self.covis.setdefault(other, {})[kfid] = c

    def _covis_remove_lm(self, lmid: int):
        obs = list(self.lm_obs.get(lmid, ()))
        for i, a in enumerate(obs):
            for b in obs[i + 1:]:
                for x, y in ((a, b), (b, a)):
                    d = self.covis.get(x)
                    if d and y in d:
                        d[y] = max(0, d[y] - 1)

    def covisible_kfs(self, kfid: int, min_score: int = 0) -> List[int]:
        d = self.covis.get(kfid, {})
        return sorted([k for k, c in d.items() if c > min_score],
                      key=lambda k: -d[k])

    def n_landmarks(self) -> int:
        return int(self.lm_valid.sum())

    def n_3d(self) -> int:
        return int((self.lm_valid & self.lm_is3d).sum())

    # ------------------------------------------------------------------
    # checkpoint / resume (the reference has none — SURVEY §5; tensors-first
    # design makes snapshots nearly free)
    # ------------------------------------------------------------------

    def save(self, path: str):
        """Snapshot the full map (landmark arenas + keyframes + covisibility)
        to one .npz file."""
        kf_ids = sorted(self.keyframes)
        payload = dict(
            lm_pos=self.lm_pos, lm_lam=self.lm_lam, lm_anchor=self.lm_anchor,
            lm_bearing=self.lm_bearing, lm_valid=self.lm_valid,
            lm_is3d=self.lm_is3d, lm_desc=self.lm_desc,
            lm_desc_ok=self.lm_desc_ok,
            kf_ids=np.asarray(kf_ids, np.int64),
            next_kf_id=np.asarray(self.next_kf_id),
        )
        for k in kf_ids:
            r = self.keyframes[k]
            payload[f"kf{k}_T"] = r.T_cw
            payload[f"kf{k}_time"] = np.asarray(r.time)
            for field in ("px", "unpx", "bv", "lmid", "valid", "is3d",
                          "rpx", "has_right", "desc", "desc_ok"):
                payload[f"kf{k}_{field}"] = getattr(r, field)
        # observation sets as ragged arrays
        obs_lm, obs_kf = [], []
        for lmid, s in self.lm_obs.items():
            for kf in s:
                obs_lm.append(lmid)
                obs_kf.append(kf)
        payload["obs_lm"] = np.asarray(obs_lm, np.int64)
        payload["obs_kf"] = np.asarray(obs_kf, np.int64)
        np.savez_compressed(path, **payload)

    @staticmethod
    def load(path: str, device=None) -> "MapStore":
        z = np.load(path, allow_pickle=False)
        m = MapStore(lm_capacity=len(z["lm_valid"]), device=device)
        for k in ("lm_pos", "lm_lam", "lm_anchor", "lm_bearing", "lm_valid",
                  "lm_is3d", "lm_desc", "lm_desc_ok"):
            setattr(m, k, z[k].copy())
        m._free = [i for i in range(m.cap - 1, -1, -1) if not m.lm_valid[i]]
        m.next_kf_id = int(z["next_kf_id"])
        for k in z["kf_ids"]:
            k = int(k)
            m.keyframes[k] = KeyframeRecord(
                kfid=k, time=float(z[f"kf{k}_time"]), T_cw=z[f"kf{k}_T"].copy(),
                px=z[f"kf{k}_px"].copy(), unpx=z[f"kf{k}_unpx"].copy(),
                bv=z[f"kf{k}_bv"].copy(), lmid=z[f"kf{k}_lmid"].copy(),
                valid=z[f"kf{k}_valid"].copy(), is3d=z[f"kf{k}_is3d"].copy(),
                rpx=z[f"kf{k}_rpx"].copy(),
                has_right=z[f"kf{k}_has_right"].copy(),
                desc=z[f"kf{k}_desc"].copy(), desc_ok=z[f"kf{k}_desc_ok"].copy())
            m.covis.setdefault(k, {})
        for lmid, kf in zip(z["obs_lm"], z["obs_kf"]):
            m.lm_obs.setdefault(int(lmid), set()).add(int(kf))
        for k in list(m.keyframes):
            m.update_covisibility(k)
        m._device_dirty = True
        return m
