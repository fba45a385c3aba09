"""``scripts/bench_spans.py``'s reading of a trace, on hand-made profiler
events: the traced window's spans and busy intervals (``spantrace``'s
split, the one ``devtrace`` makes), each long idle gap cut along the
innermost span over it, and the spans' lengths per label.

    python -m pytest tests/test_bench_spans_tool.py -q
"""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT / "scripts"), str(ROOT / "benchmark")]
import bench_spans  # noqa: E402
import devtrace  # noqa: E402
import spantrace  # noqa: E402

MS = 1_000_000


class _Event:
    def __init__(self, a, b, name, device=False, annotation=True):
        self.s, self.d, self.n = int(a * MS), int((b - a) * MS), name
        self.dev, self.ann = device, annotation

    def start_ns(self):
        return self.s

    def duration_ns(self):
        return self.d

    def name(self):
        return self.n

    def device_type(self):
        return "DeviceType.CUDA" if self.dev else "DeviceType.CPU"

    def is_user_annotation(self):
        return self.ann


class _Prof:
    def __init__(self, events):
        results = type("R", (), {"events": lambda self: events})()
        self.profiler = type("P", (), {"kineto_results": results})()


def _op(a, b):
    return _Event(a, b, "kernel", device=True, annotation=False)


# window 0-100 ms: two graph replays whose launches leave the card idle,
# a gate read while it works, a local BA solve with a long idle stretch
EVENTS = [_Event(0, 100, devtrace.WINDOW_SPAN), _Event(-5, -1, "0.FE_prepare"),
          _Event(0, 20, "0.FE_graph_back"), _Event(20, 30, "0.FE_gate_read"),
          _Event(30, 45, "0.FE_graph_back"), _Event(50, 95, "1.BA_solve"),
          _op(18, 30), _op(44, 52), _op(90, 100),
          _Event(18, 30, "0.FE_gate_read", device=True)]


def test_window_events():
    t0, t1, spans, dev = spantrace.window(_Prof(EVENTS))
    assert (t0, t1) == (0, 100 * MS)
    assert [n for _, _, n in spantrace.clipped(spans, t0, t1)] == [
        "0.FE_graph_back", "0.FE_gate_read", "0.FE_graph_back", "1.BA_solve"]
    assert spantrace.busy_union(dev, t0, t1)[1] == [
        (18 * MS, 30 * MS), (44 * MS, 52 * MS), (90 * MS, 100 * MS)]


def test_gaps_cut_along_spans():
    gaps = bench_spans.gap_pieces(*spantrace.window(_Prof(EVENTS)), k=2)
    assert [round(g["ms"], 6) for g in gaps] == [38.0, 18.0]
    assert gaps[0]["at_ms"] == pytest.approx(52.0)
    assert [[n, round(v, 6)] for n, v in gaps[0]["pieces"]] == [["1.BA_solve", 38.0]]
    assert [[n, round(v, 6)] for n, v in gaps[1]["pieces"]] == [
        ["0.FE_graph_back", 18.0]]
    # the same gaps, longest first, as the reduction names them
    out = devtrace.reduce(_Prof(EVENTS))
    assert [round(g * 1e3, 6) for _, g in out["idle_gaps"][:2]] == [38.0, 18.0]


def test_span_ms():
    t0, t1, spans, _ = spantrace.window(_Prof(EVENTS))
    out = bench_spans.span_ms(spantrace.clipped(spans, t0, t1))
    n, med, mx, first = out["0.FE_graph_back"]
    assert (n, round(med, 6), round(mx, 6)) == (2, 17.5, 20.0)
    assert [round(x, 6) for x in first] == [20.0, 15.0]
    assert out["1.BA_solve"][0] == 1 and "0.FE_prepare" not in out
