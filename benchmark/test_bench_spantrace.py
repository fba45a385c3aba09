"""``spantrace`` on hand-made profiler events, and the readers of the
per-layer metrics built on the program's spans, on hand-made run dicts.

* A stub of a stopped ``torch.profiler.profile``: host spans (the window's
  and the program's, one nested in another, one outside the window) and
  device operations (one across the window's start, two that overlap, the
  card's copy of a host span). ``span_n``, ``span_busy_s`` and
  ``span_idle_s`` (``"host"`` included) take the values worked out by hand
  below; the busy time, the window and the idle gaps are
  ``devtrace.reduce``'s, whose keys stay as they were.
* On random nested spans and operations the idle values add up to
  ``window_s - busy_s`` and no label is busier than the card.
* Each of the five readers on a run dict, and None where the program has
  not what it reads.

    python -m pytest benchmark/test_bench_spantrace.py -q
"""

from __future__ import annotations

import importlib.util
import sys
from pathlib import Path

import numpy as np
import pytest

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
import devtrace  # noqa: E402
import spantrace  # noqa: E402

MS = 1_000_000                      # ns


class _Event:
    def __init__(self, start_ms, end_ms, name, device, annotation):
        self.s, self.d = int(start_ms * MS), int((end_ms - start_ms) * MS)
        self.n, self.dev, self.ann = name, device, annotation

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


class _Stub:
    """What ``reduce`` reads of a stopped ``torch.profiler.profile``."""

    def __init__(self, events):
        results = type("R", (), {"events": lambda self: events})()
        self.profiler = type("P", (), {"kineto_results": results})()


def span(a, b, name):
    return _Event(a, b, name, False, True)


def op(a, b, name="kernel"):
    return _Event(a, b, name, True, False)


# window 0-100 ms; the front end 10-40 with its gate read 20-30, a keyframe
# 50-80, a span before the window; device work 5-15, 25-35 (klt_track),
# 60-70 and 65-75, one op from before the window into it, and the card's
# copy of the front end's span, which is no work
EVENTS = [span(0, 100, devtrace.WINDOW_SPAN), span(-20, -10, "0.FE_prepare"),
          span(10, 40, "0.Full-Front_End"), span(20, 30, "0.FE_gate_read"),
          span(50, 80, "1.KF_Processing"),
          op(-5, 2, "memcpy"), op(5, 15), op(25, 35, "klt_track_kernel"),
          op(60, 70), op(65, 75),
          _Event(10, 40, "0.Full-Front_End", True, True)]


def _attribute(events):
    return spantrace.attribute(spantrace.window(_Stub(events)))


def test_span_keys_by_hand():
    t = _attribute(EVENTS)
    # busy: 0-2, 5-15, 25-35, 60-75 = 37 ms
    assert t["span_n"] == {"0.Full-Front_End": 1, "0.FE_gate_read": 1,
                           "1.KF_Processing": 1}
    busy = {k: round(v * 1e3, 9) for k, v in t["span_busy_s"].items()}
    assert busy == {"0.Full-Front_End": 15.0, "0.FE_gate_read": 5.0,
                    "1.KF_Processing": 15.0}
    idle = {k: round(v * 1e3, 9) for k, v in t["span_idle_s"].items()}
    # host 2-5, 40-50, 80-100; the front end 15-20, 35-40; its gate 20-25
    assert idle == {"host": 33.0, "0.Full-Front_End": 10.0,
                    "0.FE_gate_read": 5.0, "1.KF_Processing": 15.0}
    assert sum(t["span_idle_s"].values()) == pytest.approx(
        t["window_s"] - t["busy_s"], abs=1e-12)


def test_agrees_with_devtrace():
    t = devtrace.reduce(_Stub(EVENTS))
    assert set(t) == {"busy_s", "window_s", "n_device_ops", "kernel_s",
                      "klt_ms", "device_ops", "idle_gaps"}
    a = _attribute(EVENTS)
    assert a["busy_s"] == pytest.approx(t["busy_s"], abs=1e-12)
    assert a["window_s"] == pytest.approx(t["window_s"], abs=1e-12)
    t0, t1, _, dev = spantrace.window(_Stub(EVENTS))
    assert len(dev) == t["n_device_ops"]
    gaps = spantrace.busy_union(dev, t0, t1)[2]
    assert [g * 1e-9 for g, _ in gaps] == [g for _, g in t["idle_gaps"]]
    # no window span, or no device operation in it: no window for either
    for ev in (EVENTS[1:], [e for e in EVENTS if not e.dev or e.ann]):
        assert spantrace.window(_Stub(ev)) is None
        assert devtrace.reduce(_Stub(ev)) is None


def _nested(rng, a, b, depth, out):
    """Random spans nested inside [a, b)."""
    t = a
    while depth and t < b - 2:
        s = t + rng.uniform(0, (b - t) / 3)
        e = min(b, s + rng.uniform(0.5, (b - s)))
        out.append(span(s, e, f"{depth}.L{int(rng.integers(3))}"))
        _nested(rng, s, e, depth - 1, out)
        t = e


@pytest.mark.parametrize("seed", range(4))
def test_idle_adds_up_on_random_events(seed):
    rng = np.random.default_rng(seed)
    ev = [span(0, 200, devtrace.WINDOW_SPAN)]
    _nested(rng, -10, 210, 3, ev)
    for _ in range(60):
        s = rng.uniform(-5, 205)
        ev.append(op(s, s + rng.exponential(3)))
    t = _attribute(ev)
    assert sum(t["span_idle_s"].values()) == pytest.approx(
        t["window_s"] - t["busy_s"], rel=1e-9)
    assert all(0 <= v <= t["busy_s"] + 1e-12 for v in t["span_busy_s"].values())
    assert all(v >= -1e-12 for v in t["span_idle_s"].values())


def _reader(name):
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location("m_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


RUN = dict(
    frames=80,
    timers={"0.FE_gate_read": {"n": 80, "total_ms": 40.0},
            "0.FE_graph_front": {"n": 80, "total_ms": 8.0},
            "0.FE_graph_filter": {"n": 20, "total_ms": 2.0},
            "1.BA_build": {"n": 4, "total_ms": 60.0},
            "1.BA_writeback": {"n": 4, "total_ms": 20.0},
            "1.BA_nobs": {"n": 4, "total_ms": 30000.0},
            "9.Host_GC": {"n": 3, "total_ms": 12.0}},
    trace={"frames": 16, "busy_s": 0.1, "window_s": 0.5})


@pytest.mark.parametrize("name,value", [
    ("frontend.gate_wait_ms_per_frame", 0.5),
    ("frontend.gate_open_pct", 25.0),
    ("keyframe.ba_host_ms", 20.0),
    ("keyframe.ba_obs_per_solve", 7500.0),
    ("manager.gc_ms_per_frame", 0.15)])
def test_readers(name, value):
    read = _reader(name)
    assert read(RUN) == pytest.approx(value)
    # a program without the spans these read (the timers and trace of a
    # program before them): nothing, except the collector's 0.0
    bare = dict(frames=80, timers={"0.Full-Front_End": {"n": 10, "total_ms": 5.0}},
                trace={"frames": 16, "busy_s": 0.1, "window_s": 0.5})
    assert read(bare) == (0.0 if name == "manager.gc_ms_per_frame" else None)
    assert read(dict(bare, trace=None)) == (
        0.0 if name == "manager.gc_ms_per_frame" else None)


def test_gate_open_pct_without_openings():
    run = dict(RUN, timers={"0.FE_graph_front": {"n": 80, "total_ms": 8.0}})
    assert _reader("frontend.gate_open_pct")(run) == 0.0
