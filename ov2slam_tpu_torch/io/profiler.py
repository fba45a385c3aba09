"""Named-timer profiler with Welford statistics (port of
``ov2slam_tpu/io/profiler.py``).

Replaces the reference's Profiler (reference: include/profiler.hpp:38-229):
one process-wide set of named timers (``Profiler.instance()``), start / stop
/ pause, and the mean, std, min and max summary table under the reference's
hierarchical labels ("0.Full-Front_End", "1.BA_localBA", ...). ``scope``
also opens a ``torch.profiler.record_function`` span of the same label, so
device traces line up with the host table.

The timers read the host clock and add no synchronisation, so the
pipelined mode keeps its timing. On the card a block's time is the time to
issue its work plus whatever it waits for: a ``device.Fetch.result()`` (an
event wait), a host read of a device value (``.item()``, ``.cpu()``,
``float()``) or an upload from pageable host memory (which waits for the
stream). Labels that hold such a wait: ``2.KF_Registry_fetch`` and
``2.KF_LMM_fetch`` (the staged reads, and ``2.KF_Registry`` /
``2.KF_MatchLocalMap`` / ``1.KF_Processing`` around them);
``0.Full-Front_End`` (the frame's stats read in the synchronous mode, the
epipolar gate's read); ``1.BA_localBA`` (the synchronous solve's stop test,
``1.BA_finalize_prev``'s read of the deferred solve); ``2.LC_Process``,
``1.BA_fullBA`` and ``1.BA_fullPoseGraph`` (host reads of their results).
``1.BA_MapFiltering``, ``2.KF_LMM_merge`` and ``2.LC_MergeBookkeeping``
are host-only bookkeeping. ``2.KF_DeviceStep``, ``2.KF_LMM_dispatch`` and
``1.BA_begin`` issue device work and wait only behind their uploads.

Finer spans name what the host does at each boundary of the port's work,
by kind: *work* (host computation), *issue* (enqueues device work) or
*wait* (the host blocks on the card). The chunk call
(``SlamSystem.process_stereo_chunk``): ``0.FE_prepare`` (work + issue: the
frames' rectification and uploads, the landmark arena),
``0.FE_capture`` (work: a graph key's warm-up and captures),
``0.FE_load`` (issue: the state into the graphs' buffers),
``0.FE_graph_front`` / ``_filter`` / ``_back`` (issue: one replay each),
``0.FE_gate_read`` (wait: the parallax gate), ``0.FE_stats_read`` (wait:
the chunk's stats) and ``0.FE_finalize`` (work: poses, keyframe decisions,
the log; ``1.KF_Processing`` inside). The keyframe path: ``2.KF_Anchors``
(work: candidate ids and anchor data), ``1.BA_build`` (work: the problem
from the host map), ``1.BA_solve`` (issue, with the solver's stop-test
reads), ``1.BA_fetch`` (wait: the result's reads) and ``1.BA_writeback``
(work). ``9.Host_GC`` (work) is each garbage collection while the process-wide
profiler (``Profiler.instance()``) is enabled: one ``gc.callbacks`` hook,
which updates a table entry made when timing is turned on and on
``reset()``, so that a collection never adds a key to ``timers`` while a
reader walks it. ``sample`` adds a count to a label's
statistics instead of a time: ``1.BA_nobs``, the observations of each
built BA problem.

Disabled, ``scope`` returns one shared no-op context: no clock read, no
table entry and no ``record_function``.
"""

from __future__ import annotations

import contextlib
import gc
import time
from dataclasses import dataclass
from typing import Dict, Optional

from torch.profiler import record_function

GC_LABEL = "9.Host_GC"
_NO_SCOPE = contextlib.nullcontext()


@dataclass
class _TimerStats:
    n: int = 0
    mean: float = 0.0
    m2: float = 0.0
    vmin: float = float("inf")
    vmax: float = 0.0
    t_start: Optional[float] = None
    acc: float = 0.0

    def add(self, x: float):
        self.n += 1
        d = x - self.mean
        self.mean += d / self.n
        self.m2 += d * (x - self.mean)
        self.vmin = min(self.vmin, x)
        self.vmax = max(self.vmax, x)

    @property
    def std(self) -> float:
        return (self.m2 / self.n) ** 0.5 if self.n > 1 else 0.0


class Profiler:
    """start/stop timers by label; display a summary table."""

    _instance: Optional["Profiler"] = None

    def __init__(self, enabled: bool = True):
        self.timers: Dict[str, _TimerStats] = {}
        self._gc_span = None
        self.enabled = enabled

    @property
    def enabled(self) -> bool:
        return self._enabled

    @enabled.setter
    def enabled(self, on) -> None:
        """Turn timing on or off. For the process-wide profiler, on also
        times each garbage collection as ``GC_LABEL``; off removes the hook
        again, and the label's entry if no collection was timed."""
        self._enabled = bool(on)
        if self is not Profiler._instance:
            return
        if self._enabled:
            self.timers.setdefault(GC_LABEL, _TimerStats())
            if _gc_hook not in gc.callbacks:
                gc.callbacks.append(_gc_hook)
        else:
            if _gc_hook in gc.callbacks:
                gc.callbacks.remove(_gc_hook)
            st = self.timers.get(GC_LABEL)
            if st is not None and st.n == 0:
                del self.timers[GC_LABEL]

    @classmethod
    def instance(cls) -> "Profiler":
        if cls._instance is None:
            cls._instance = Profiler(enabled=False)
            cls._instance.enabled = True
        return cls._instance

    def start(self, label: str):
        if not self.enabled:
            return
        st = self.timers.setdefault(label, _TimerStats())
        st.t_start = time.perf_counter()

    def pause(self, label: str):
        if not self.enabled:
            return
        st = self.timers.get(label)
        if st and st.t_start is not None:
            st.acc += time.perf_counter() - st.t_start
            st.t_start = None

    def stop(self, label: str):
        if not self.enabled:
            return
        st = self.timers.get(label)
        if st is None:
            return
        total = st.acc
        if st.t_start is not None:
            total += time.perf_counter() - st.t_start
        st.add(total * 1000.0)  # ms
        st.t_start = None
        st.acc = 0.0

    class _Scope:
        def __init__(self, prof, label):
            self.prof = prof
            self.label = label
            self.trace = record_function(label)

        def __enter__(self):
            self.prof.start(self.label)
            self.trace.__enter__()
            return self

        def __exit__(self, *a):
            self.trace.__exit__(*a)
            self.prof.stop(self.label)

    def scope(self, label: str):
        if not self._enabled:
            return _NO_SCOPE
        return Profiler._Scope(self, label)

    def sample(self, label: str, value: float):
        """Add `value` (a count, not a time) to the label's statistics."""
        if self._enabled:
            self.timers.setdefault(label, _TimerStats()).add(float(value))

    def _on_gc(self, phase: str):
        # updates the entry the setter or reset() made; adds no key
        st = self.timers.get(GC_LABEL)
        if st is None:
            return
        if phase == "start":
            st.t_start = time.perf_counter()
            self._gc_span = record_function(GC_LABEL)
            self._gc_span.__enter__()
        elif self._gc_span is not None:
            span, self._gc_span = self._gc_span, None
            span.__exit__(None, None, None)
            if st.t_start is not None:
                st.add((time.perf_counter() - st.t_start) * 1000.0)
                st.t_start = None

    def summary(self) -> str:
        lines = ["=" * 72,
                 f"{'label':<40}{'mean':>8}{'std':>8}{'min':>8}{'max':>8}"]
        for label in sorted(self.timers):
            st = self.timers[label]
            if label == GC_LABEL and st.n == 0:
                continue            # made ready, no collection timed
            lines.append(
                f"{label:<40}{st.mean:>8.2f}{st.std:>8.2f}"
                f"{st.vmin:>8.2f}{st.vmax:>8.2f}")
        lines.append("=" * 72)
        return "\n".join(lines)

    def reset(self):
        st = _TimerStats()
        self.timers.clear()
        if self._enabled and self is Profiler._instance:
            self.timers[GC_LABEL] = st


def _gc_hook(phase, info):
    """The ``gc.callbacks`` entry: times each collection in the
    process-wide profiler while it is enabled."""
    prof = Profiler._instance
    if prof is not None and prof._enabled:
        prof._on_gc(phase)
