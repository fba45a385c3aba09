"""Online place recognition: incremental BoW-style index + loop candidate
detection (port of ``ov2slam_tpu/slam/bow.py``).

Replaces OBIndex2 + iBoW-LCD (Thirdparty/obindex2,
Thirdparty/ibow_lcd/src/lcdetector.cc:54-160): keyframe descriptors feed an
incremental binary index; queries return vote-ranked earlier keyframes;
candidates pass island grouping and temporal consistency before geometric
verification.

The index is C++ (``csrc/bow_index.cpp``, the port's own copy of the JAX
package's), compiled with ``g++`` at first use into
``ov2slam_tpu_torch/build/`` under a name keyed on the source's hash and
the flags, and loaded with ctypes. A failed build raises: the numpy index
votes differently (brute force, no LSH buckets), so it runs only when asked
for (``force_python=True``), never in place of a failed build.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from ov2slam_tpu_torch.ops import _build

_LIB: Optional[ctypes.CDLL] = None


def library_path() -> str:
    """Where the index library of the current source and flags lives."""
    return str(_build.cxx_library_path("bow_index"))


def _get_lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(_build.build_cxx("bow_index")))
        lib.bow_create.restype = ctypes.c_void_p
        lib.bow_destroy.argtypes = [ctypes.c_void_p]
        lib.bow_num_images.argtypes = [ctypes.c_void_p]
        lib.bow_num_images.restype = ctypes.c_int
        words = np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS")
        lib.bow_add_image.argtypes = [ctypes.c_void_p, ctypes.c_int, words,
                                      ctypes.c_int]
        lib.bow_query.argtypes = [
            ctypes.c_void_p, words, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")]
        lib.bow_query.restype = ctypes.c_int
        _LIB = lib
    return _LIB


class BinaryIndex:
    """Incremental image index over packed 256-bit descriptors ((n, 8)
    uint32 words)."""

    def __init__(self, force_python: bool = False):
        self._lib = None if force_python else _get_lib()
        if self._lib is not None:
            self._h = ctypes.c_void_p(self._lib.bow_create())
        else:
            self._imgs: List[Tuple[int, np.ndarray]] = []

    def __del__(self):
        if getattr(self, "_lib", None) is not None:
            self._lib.bow_destroy(self._h)

    @property
    def native(self) -> bool:
        return self._lib is not None

    def add_image(self, image_id: int, descs: np.ndarray):
        d = np.ascontiguousarray(descs, np.uint32)
        if self._lib is not None:
            self._lib.bow_add_image(self._h, int(image_id), d, len(d))
        else:
            self._imgs.append((int(image_id), d))

    def query(self, descs: np.ndarray, max_image_id: int, topk: int = 10
              ) -> List[Tuple[int, float]]:
        """(image id, score) of the best `topk` images with id <=
        max_image_id, best first."""
        d = np.ascontiguousarray(descs, np.uint32)
        if self._lib is not None:
            ids = np.zeros(topk, np.int32)
            scores = np.zeros(topk, np.float32)
            k = self._lib.bow_query(self._h, d, len(d), int(max_image_id),
                                    topk, ids, scores)
            return [(int(ids[i]), float(scores[i])) for i in range(k)]
        # numpy index: brute-force Hamming voting
        votes: Dict[int, float] = {}
        q = np.unpackbits(d.view(np.uint8), axis=1)            # (n, 256)
        for img_id, stored in self._imgs:
            if img_id > max_image_id or len(stored) == 0:
                continue
            s = np.unpackbits(stored.view(np.uint8), axis=1)
            best = (q[:, None, :] != s[None, :, :]).sum(-1).min(axis=1)
            m = best <= 64
            if m.any():
                votes[img_id] = float((1.0 - best[m] / 256.0).sum())
        ranked = sorted(votes.items(), key=lambda kv: -kv[1])[:topk]
        return [(i, s) for i, s in ranked]


@dataclass
class LoopCandidate:
    query_kf: int
    match_kf: int
    score: float
    # every (kf, score) member of the winning island: keyframes the index
    # voted for, used to re-resolve the match if match_kf was culled
    island: List[Tuple[int, float]] = field(default_factory=list)


@dataclass
class LCDetector:
    """iBoW-LCD-style loop candidate detection: vote query + island grouping
    + temporal consistency.

    Defaults follow iBoW-LCD's LCDetectorParams
    (Thirdparty/ibow_lcd/include/ibow_lcd/lcdetector.h:42-80, used
    unmodified by ov2slam, loop_closer.cpp:48): p = 100 keyframes,
    island_size = 20, min_score 0.3 on min-max-normalized scores. As in the
    JAX package, `min_consecutive` consistent islands gate the geometric
    verification, and `min_score` is an optional absolute island-vote floor
    (0 = off). Short sequences override p_wait / min_consecutive."""

    p_wait: int = 100          # KFs excluded before loop search (iBoW p)
    island_size: int = 20      # id radius grouping candidates into islands
    min_score: float = 0.0     # absolute island vote floor (0 = off)
    min_consecutive: int = 2   # consecutive consistent islands required
    # min-max-normalized per-candidate cut before island grouping
    # (iBoW-LCD filterCandidates, lcdetector.cc:183-204)
    min_norm_score: float = 0.3
    force_python_index: bool = False

    def __post_init__(self):
        self.index = BinaryIndex(force_python=self.force_python_index)
        self._last_island: Optional[Tuple[int, int]] = None
        self._consecutive = 0

    def process(self, kf_id: int, descs: np.ndarray) -> Optional[LoopCandidate]:
        """Query, then add (the reference queries before inserting,
        lcdetector.cc:54-90). Returns a candidate or None."""
        result = None
        if len(descs) > 0:
            hits = self.index.query(descs, max_image_id=kf_id - self.p_wait,
                                    topk=20)
            result = self._detect(kf_id, hits)
            self.index.add_image(kf_id, descs)
        return result

    def _reset_streak(self):
        self._consecutive = 0
        self._last_island = None

    def _detect(self, kf_id: int, hits: List[Tuple[int, float]]
                ) -> Optional[LoopCandidate]:
        if not hits:
            self._reset_streak()
            return None
        # min-max-normalized candidate cut (filterCandidates): weak tail
        # candidates never join an island
        if len(hits) > 1:
            scores = [s for _, s in hits]
            hi_s, lo_s = max(scores), min(scores)
            if hi_s > lo_s:
                hits = [(k, s) for k, s in hits
                        if (s - lo_s) / (hi_s - lo_s) > self.min_norm_score]
        if not hits:
            self._reset_streak()
            return None
        # islands of nearby keyframe ids
        islands: List[List[Tuple[int, float]]] = []
        for kf, sc in sorted(hits):
            if islands and kf - islands[-1][-1][0] <= self.island_size:
                islands[-1].append((kf, sc))
            else:
                islands.append([(kf, sc)])

        def island_score(isl):
            return sum(s for _, s in isl)

        def near_last(lo, hi):
            plo, phi = self._last_island
            return lo <= phi + self.island_size and hi >= plo - self.island_size

        best = max(islands, key=island_score)
        # prior-island preference (getPriorIslands, lcdetector.cc:124-130):
        # the first island overlapping the previous query's wins if it
        # clears the floor
        if self._last_island is not None:
            for isl in islands:
                if near_last(isl[0][0], isl[-1][0]):
                    if island_score(isl) >= self.min_score:
                        best = isl
                    break
        score = island_score(best)
        if score < self.min_score:
            self._reset_streak()
            return None
        lo, hi = best[0][0], best[-1][0]
        # temporal consistency with the previous query's best island
        if self._last_island is not None and near_last(lo, hi):
            self._consecutive += 1
        else:
            self._consecutive = 1
        self._last_island = (lo, hi)
        if self._consecutive >= self.min_consecutive:
            kf_best = max(best, key=lambda t: t[1])[0]
            return LoopCandidate(query_kf=kf_id, match_kf=kf_best,
                                 score=score, island=list(best))
        return None
