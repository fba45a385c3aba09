"""Reduction of a ``torch.profiler`` trace of the measured window to what
the per-layer metrics and the result line read: the device's busy time
(the union of its kernel, copy and set intervals), the traced window's
length, device time by kernel name, the klt_track kernels in order, and
the longest idle gaps of the device, each named by the innermost span the
host was in when it began. Device work is every event the profiler put on
the card (kernels, copies, sets) but the card's copies of host spans.

It reads the profiler's raw events (``kineto_results.events()``), not the
``FunctionEvent`` tree, which takes minutes to build for a window of graph
replays.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Dict, List, Optional

def _on_device(e) -> bool:
    return "CUDA" in str(e.device_type())


def _annotation(e) -> bool:
    try:
        return bool(e.is_user_annotation())
    except (AttributeError, RuntimeError):
        return False


WINDOW_SPAN = "bench.traced_window"


def reduce(prof, top: int = 10) -> Optional[Dict]:
    """The traced window of `prof` (a stopped ``torch.profiler.profile``):
    the interval of its ``WINDOW_SPAN`` span. None where the trace holds no
    such span or no device operation."""
    events = prof.profiler.kineto_results.events()
    dev, spans = [], []
    for e in events:
        s = e.start_ns()
        if _annotation(e):
            if not _on_device(e):
                spans.append((s, s + e.duration_ns(), e.name()))
        elif _on_device(e):
            dev.append((s, s + e.duration_ns(), e.name()))
    # the device's copy of a host span (a "gpu_user_annotation") is no work
    names = {n for _, _, n in spans}
    dev = [d for d in dev if d[2] not in names]
    win = [s for s in spans if s[2] == WINDOW_SPAN]
    if not win:
        return None
    t0_ns, t1_ns = win[0][0], win[0][1]
    spans = [s for s in spans if s[2] != WINDOW_SPAN]
    dev = [d for d in dev if d[1] > t0_ns and d[0] < t1_ns]
    if not dev:
        return None
    dev.sort()
    by_name: Dict[str, float] = defaultdict(float)
    for s, e, n in dev:
        by_name[n] += (min(e, t1_ns) - max(s, t0_ns)) * 1e-9
    # union of device intervals, and the gaps between them
    busy, gaps, cur = 0, [], None
    last_end = t0_ns
    for s, e, _ in dev:
        s, e = max(s, t0_ns), min(e, t1_ns)
        if cur is None or s > cur[1]:
            if cur is not None:
                busy += cur[1] - cur[0]
            if s > last_end:
                gaps.append((s - last_end, last_end))
            cur = [s, e]
        else:
            cur[1] = max(cur[1], e)
        last_end = max(last_end, e)
    if cur is not None:
        busy += cur[1] - cur[0]
    if t1_ns > last_end:
        gaps.append((t1_ns - last_end, last_end))
    gaps.sort(reverse=True)
    spans.sort()
    starts = [s[0] for s in spans]

    def host_at(t: int) -> str:
        """Innermost span open at t (the latest-starting one that covers
        it), or "host"."""
        best = None
        for k in range(bisect.bisect_right(starts, t) - 1, -1, -1):
            s, e, n = spans[k]
            if e >= t and (best is None or s > best[0]):
                best = (s, n)
                break
        return best[1] if best else "host"

    klt = [(s, e) for s, e, n in dev if "klt_track" in n]
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])
    return {
        "busy_s": busy * 1e-9,
        "window_s": (t1_ns - t0_ns) * 1e-9,
        "n_device_ops": len(dev),
        "kernel_s": dict(by_name),
        "klt_ms": [(e - s) * 1e-6 for s, e in klt],
        "device_ops": [[n, v] for n, v in ranked[:top]],
        "idle_gaps": [[host_at(t), g * 1e-9] for g, t in gaps[:top]],
    }
