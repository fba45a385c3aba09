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
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, Optional

from torch.profiler import record_function


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
        self.enabled = enabled
        self.timers: Dict[str, _TimerStats] = {}

    @classmethod
    def instance(cls) -> "Profiler":
        if cls._instance is None:
            cls._instance = Profiler()
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

    def scope(self, label: str) -> "_Scope":
        return Profiler._Scope(self, label)

    def summary(self) -> str:
        lines = ["=" * 72,
                 f"{'label':<40}{'mean':>8}{'std':>8}{'min':>8}{'max':>8}"]
        for label in sorted(self.timers):
            st = self.timers[label]
            lines.append(
                f"{label:<40}{st.mean:>8.2f}{st.std:>8.2f}"
                f"{st.vmin:>8.2f}{st.vmax:>8.2f}")
        lines.append("=" * 72)
        return "\n".join(lines)

    def reset(self):
        self.timers.clear()
