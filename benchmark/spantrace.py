"""The card's busy and idle time in a traced window, put down to the
program's spans (its ``Profiler.scope`` labels), from the same raw events
and the same split into host spans and device operations as
``devtrace.reduce``:

* ``span_n`` ``{label: count}``: the spans that open in the window;
* ``span_busy_s`` ``{label: s}``: the union of the card's operations
  inside the union of the label's intervals;
* ``span_idle_s`` ``{label: s}``: the card's idle time, each stretch of it
  under the innermost span open there (the latest-started one, as
  ``devtrace`` names a gap), ``"host"`` where none is (the caller between
  the program's calls). The values add up to ``window_s - busy_s``.

``devtrace.reduce``'s result and the per-layer metrics do not carry these
keys yet: ``attribute(window(prof))`` is what ``reduce`` would merge into
its result. ``scripts/bench_spans.py`` reads them on the card today.
"""

from __future__ import annotations

import bisect
import heapq
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

from devtrace import WINDOW_SPAN, _annotation, _on_device

Interval = Tuple[int, int]


def window(prof) -> Optional[Tuple[int, int, list, list]]:
    """(t0_ns, t1_ns, spans, dev) of `prof` (a stopped
    ``torch.profiler.profile``): the ``WINDOW_SPAN`` interval, the
    program's host spans but that one, and the device operations that
    overlap the interval, each a sorted list of (start_ns, end_ns, name).
    None where ``devtrace.reduce`` finds no window either."""
    dev, spans = [], []
    for e in prof.profiler.kineto_results.events():
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
    spans = sorted(s for s in spans if s[2] != WINDOW_SPAN)
    dev = sorted(d for d in dev if d[1] > t0_ns and d[0] < t1_ns)
    return (t0_ns, t1_ns, spans, dev) if dev else None


def busy_union(dev: list, t0_ns: int, t1_ns: int):
    """(busy_ns, union, gaps) of the sorted device operations `dev` cut to
    [t0, t1): their busy time, its sorted disjoint intervals, and the idle
    gaps as (length_ns, start_ns), longest first, as ``devtrace`` finds
    them."""
    union: List[Interval] = []
    gaps, last_end = [], t0_ns
    for s, e, _ in dev:
        s, e = max(s, t0_ns), min(e, t1_ns)
        if union and s <= union[-1][1]:
            union[-1] = (union[-1][0], max(union[-1][1], e))
        else:
            if s > last_end:
                gaps.append((s - last_end, last_end))
            union.append((s, e))
        last_end = max(last_end, e)
    if t1_ns > last_end:
        gaps.append((t1_ns - last_end, last_end))
    gaps.sort(reverse=True)
    return sum(e - s for s, e in union), union, gaps


def clipped(spans: list, t0_ns: int, t1_ns: int) -> list:
    """The spans that overlap [t0, t1), cut to it."""
    return [(max(s, t0_ns), min(e, t1_ns), n) for s, e, n in spans
            if s < t1_ns and e > t0_ns]


def innermost(spans: list, t0_ns: int, t1_ns: int) -> list:
    """[t0, t1) cut into (start, end, label) pieces, each under the
    innermost span open over it (the latest-started), "host" where none
    is."""
    events = sorted([(s, 1, k) for k, (s, _, _) in enumerate(spans)]
                    + [(e, 0, k) for k, (_, e, _) in enumerate(spans)])
    open_: list = []                     # heap of (-start, index)
    ended = set()
    out, t = [], t0_ns
    for when, opens, k in events:
        while open_ and open_[0][1] in ended:
            heapq.heappop(open_)
        if when > t:
            out.append((t, when, spans[open_[0][1]][2] if open_ else "host"))
            t = when
        if opens:
            heapq.heappush(open_, (-spans[k][0], k))
        else:
            ended.add(k)
    if t1_ns > t:
        out.append((t, t1_ns, "host"))
    return out


def _merged(ivs: List[Interval]) -> List[Interval]:
    """The union of intervals, as sorted disjoint intervals."""
    out: List[List[int]] = []
    for s, e in sorted(ivs):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def _busy_before(union: List[Interval]):
    """t -> the card's busy ns before t, from the sorted disjoint busy
    intervals `union`."""
    starts = [s for s, _ in union]
    before = [0]
    for s, e in union:
        before.append(before[-1] + e - s)

    def at(t: int) -> int:
        k = bisect.bisect_right(starts, t) - 1
        if k < 0:
            return 0
        s, e = union[k]
        return before[k] + min(t, e) - s
    return at


def attribute(w) -> Dict:
    """``span_n``, ``span_busy_s``, ``span_idle_s``, ``busy_s`` and
    ``window_s`` of ``window``'s (t0_ns, t1_ns, spans, dev)."""
    t0_ns, t1_ns, spans, dev = w
    busy, union, _ = busy_union(dev, t0_ns, t1_ns)
    busy_in = _busy_before(union)
    in_win = clipped(spans, t0_ns, t1_ns)
    span_n: Dict[str, int] = defaultdict(int)
    for s, _, n in spans:
        if t0_ns <= s <= t1_ns:
            span_n[n] += 1
    by_label: Dict[str, List[Interval]] = defaultdict(list)
    for s, e, n in in_win:
        by_label[n].append((s, e))
    span_busy = {n: sum(busy_in(e) - busy_in(s) for s, e in _merged(ivs)) * 1e-9
                 for n, ivs in by_label.items()}
    span_idle: Dict[str, float] = defaultdict(float)
    for s, e, n in innermost(in_win, t0_ns, t1_ns):
        span_idle[n] += ((e - s) - (busy_in(e) - busy_in(s))) * 1e-9
    return {"span_n": dict(span_n), "span_busy_s": span_busy,
            "span_idle_s": dict(span_idle), "busy_s": busy * 1e-9,
            "window_s": (t1_ns - t0_ns) * 1e-9}
