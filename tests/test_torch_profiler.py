"""The port's profiler (``ov2slam_tpu_torch/io/profiler.py``) against the
JAX package's, and its wiring into ``SlamSystem``.

Welford statistics and the summary table are byte-equal to the JAX
package's for the same timer values (both driven by one fake clock). Both systems, run over the same synthetic frames with
``log_timings`` on and the process-wide profiler reset before each, fill
the JAX package's labels, synchronous (15 frames) and pipelined
(``force_realtime``, 20 frames at 0.08 m steps: enough keyframes for the
staged commits, the local-map merge and the deferred BA); the port's
further labels are exactly ``EXTRA_LABELS``' of the path. With
``log_timings`` off nothing is recorded, and no span reaches a
``torch.profiler`` trace; on, a span reaches it with the table's duration,
and each garbage collection is timed by the process-wide profiler's one
hook, without adding a key to a table being walked. ``process_stereo_chunk`` fills the
chunk call's spans and the local BA's, each child within its parent.
"""

import gc
import time

import numpy as np
import pytest
import torch

import ov2slam_tpu.io.profiler as jprof
from ov2slam_tpu.config import SlamParams as JParams
from ov2slam_tpu.slam.manager import SlamSystem as JSlam
import ov2slam_tpu_torch.io.profiler as tprof
from ov2slam_tpu_torch.config import SlamParams
from ov2slam_tpu_torch.slam.manager import SlamSystem

import synthetic_np as syn
import torch_parity  # noqa: F401  (caps torch threads)

# the port's labels beyond the JAX package's, by path (process_stereo, a
# collection forced at the end): the registry and local-map commits carry
# their labels on the synchronous path too, the anchors and the local BA's
# build / solve / fetch / write-back are split out, the observations of
# each BA problem are sampled, and the collector is timed
_BA = {"2.KF_Anchors", "1.BA_build", "1.BA_nobs", "1.BA_solve", "1.BA_fetch",
       "1.BA_writeback", "9.Host_GC"}
EXTRA_LABELS = {"sync": _BA | {"2.KF_Registry", "2.KF_MatchLocalMap"},
                "pipelined": _BA}
# child label -> the label every one of its spans lies in, on the chunk path
PARENTS = {"0.FE_stats_read": "0.Full-Front_End",
           "1.KF_Processing": "0.FE_finalize",
           "2.KF_Anchors": "2.KF_DeviceStep",
           "2.KF_DeviceStep": "1.KF_Processing",
           "2.KF_Registry": "1.KF_Processing",
           "2.KF_Registry_fetch": "2.KF_Registry",
           "2.KF_MatchLocalMap": "1.KF_Processing",
           "1.BA_localBA": "2.KF_MatchLocalMap",
           "1.BA_build": "1.BA_localBA", "1.BA_solve": "1.BA_localBA",
           "1.BA_fetch": "1.BA_localBA", "1.BA_writeback": "1.BA_localBA"}


def _annotations(tp) -> list:
    """(name, duration ns) of the user annotations of a stopped
    ``torch.profiler.profile``."""
    return [(e.name(), e.duration_ns())
            for e in tp.profiler.kineto_results.events()
            if e.is_user_annotation()]


def _cpu_profile():
    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])


class _Clock:
    def __init__(self):
        self.now = 100.0

    def perf_counter(self):
        return self.now


def test_stats_and_summary_equal_jax(monkeypatch):
    rng = np.random.default_rng(0)
    clock = _Clock()
    profs = []
    for mod in (jprof, tprof):
        monkeypatch.setattr(mod, "time", clock)
        profs.append(mod.Profiler())
    labels = ["0.Full-Front_End", "1.BA_localBA", "2.KF_Registry_fetch",
              "a_very_long_label_that_fills_the_column_x"]
    for step in range(60):
        label = labels[int(rng.integers(len(labels)))]
        for p in profs:
            p.start(label)
        clock.now += float(rng.exponential(0.02))
        if step % 3 == 0:           # a paused stretch is not counted
            for p in profs:
                p.pause(label)
            clock.now += 1.0
            for p in profs:
                p.start(label)
            clock.now += float(rng.exponential(0.01))
        for p in profs:
            p.stop(label)
    with profs[0].scope("scoped"), profs[1].scope("scoped"):
        clock.now += 0.5
    jp, tp = profs
    assert sorted(jp.timers) == sorted(tp.timers)
    for k, js in jp.timers.items():
        ts = tp.timers[k]
        assert (ts.n, ts.mean, ts.m2, ts.vmin, ts.vmax, ts.std) == (
            js.n, js.mean, js.m2, js.vmin, js.vmax, js.std), k
    assert tp.summary() == jp.summary()
    tp.reset()
    assert tp.summary() == jprof.Profiler().summary()


@pytest.mark.parametrize("realtime,n,step", [(0, 15, 0.04), (1, 20, 0.08)],
                         ids=["sync", "pipelined"])
def test_labels_equal_jax(realtime, n, step):
    fl, fr, _ = syn.render_sequence(n_frames=n, step=step)
    d = syn.slam_params_dict()
    d.update(log_timings=1, force_realtime=realtime)
    labels = {}
    for name, make, prof in (
            ("jax", lambda: JSlam(JParams.from_dict(d)), jprof.Profiler),
            ("torch", lambda: SlamSystem(SlamParams.from_dict(d), device="cpu"),
             tprof.Profiler)):
        prof.instance().reset()
        slam = make()
        assert slam.prof is prof.instance() and slam.prof.enabled
        for i in range(n):
            slam.process_stereo(fl[i], fr[i], i * 0.05)
        slam.flush()
        gc.collect()
        labels[name] = sorted(prof.instance().timers)
    prof.instance().enabled = False
    path = "pipelined" if realtime else "sync"
    assert set(labels["jax"]) <= set(labels["torch"])
    assert set(labels["torch"]) - set(labels["jax"]) == EXTRA_LABELS[path]
    assert {"0.Full-Front_End", "2.KF_DeviceStep", "2.KF_Registry_fetch",
            "1.BA_localBA"} <= set(labels["torch"])
    if realtime:
        assert {"2.KF_Registry", "2.KF_MatchLocalMap", "1.BA_begin",
                "1.BA_finalize_prev"} <= set(labels["torch"])


def test_log_timings_off_records_nothing():
    fl, fr, _ = syn.render_sequence(n_frames=3)
    tprof.Profiler.instance().reset()
    slam = SlamSystem(SlamParams.from_dict(syn.slam_params_dict()), device="cpu")
    assert not slam.prof.enabled
    for i in range(3):
        slam.process_stereo(fl[i], fr[i], i * 0.05)
    assert tprof.Profiler.instance().timers == {}


def test_disabled_scope_opens_no_record_function():
    p = tprof.Profiler(enabled=False)
    assert p.scope("a") is p.scope("b")
    with _cpu_profile() as tp:
        with p.scope("0.Full-Front_End"):
            torch.ones(8).add_(1)
        p.sample("1.BA_nobs", 3)
    assert _annotations(tp) == []
    assert p.timers == {}


def test_enabled_scope_in_trace_with_table_duration():
    p = tprof.Profiler()
    try:
        with _cpu_profile() as tp:
            for _ in range(3):
                with p.scope("0.FE_finalize"):
                    time.sleep(0.02)
        spans = [d for name, d in _annotations(tp) if name == "0.FE_finalize"]
        st = p.timers["0.FE_finalize"]
        assert len(spans) == st.n == 3
        table_ms = st.n * st.mean
        trace_ms = 1e-6 * sum(spans)
        assert abs(trace_ms - table_ms) <= max(0.05 * table_ms, 0.05 * 3)
    finally:
        p.enabled = False


def _hooks() -> int:
    return sum(h is tprof._gc_hook for h in gc.callbacks)


def test_gc_is_timed_while_enabled():
    p = tprof.Profiler.instance()
    p.enabled = True
    try:
        assert _hooks() == 1
        with _cpu_profile() as tp:
            gc.collect()
        assert p.timers[tprof.GC_LABEL].n >= 1
        assert tprof.GC_LABEL in {name for name, _ in _annotations(tp)}
    finally:
        p.enabled = False
    assert _hooks() == 0
    n = p.timers[tprof.GC_LABEL].n
    gc.collect()
    assert p.timers[tprof.GC_LABEL].n == n
    p.enabled = True
    p.enabled = True
    assert _hooks() == 1
    p.enabled = False
    p.reset()
    # another profiler, enabled, times its own spans but no collection
    q = tprof.Profiler()
    assert _hooks() == 0 and q.timers == {}
    gc.collect()
    assert q.timers == {}


def test_gc_while_timers_are_walked_adds_no_key():
    p = tprof.Profiler.instance()
    p.enabled = True
    try:
        p.reset()
        assert p.timers[tprof.GC_LABEL].n == 0
        assert tprof.GC_LABEL not in p.summary()    # no row until one ran
        for label in ("0.FE_prepare", "0.FE_finalize"):
            with p.scope(label):
                pass
        seen = []
        for label, st in p.timers.items():    # a collection mid-walk
            gc.collect()
            seen.append((label, st.n))
        assert len(seen) == 3 and p.timers[tprof.GC_LABEL].n >= 3
        assert tprof.GC_LABEL in p.summary()
    finally:
        p.enabled = False
        p.reset()
    assert p.timers == {}


def test_sample_adds_counts():
    p = tprof.Profiler()
    p.enabled = False
    p.enabled = True
    for v in (10, 30):
        p.sample("1.BA_nobs", v)
    p.enabled = False
    st = p.timers["1.BA_nobs"]
    assert (st.n, st.mean, st.vmin, st.vmax) == (2, 20.0, 10.0, 30.0)


def test_chunk_call_fills_its_spans():
    fl, fr, _ = syn.render_sequence(n_frames=28, step=0.08)
    d = syn.slam_params_dict()
    d.update(log_timings=1)
    prof = tprof.Profiler.instance()
    slam = SlamSystem(SlamParams.from_dict(d), device="cpu")
    try:
        frames = [(fl[i], fr[i], i * 0.05) for i in range(len(fl))]
        slam.process_stereo_chunk(frames[:4])      # frame by frame: the map
        prof.reset()
        for i in range(4, len(frames), 8):
            slam.process_stereo_chunk(frames[i:i + 8])
        timers = dict(prof.timers)
    finally:
        prof.enabled = False
        prof.reset()
    assert {"0.FE_prepare", "0.Full-Front_End", "0.FE_stats_read",
            "0.FE_finalize", "1.KF_Processing", "1.BA_localBA", "1.BA_build",
            "1.BA_fetch", "1.BA_writeback", "1.BA_nobs"} <= set(timers)
    assert timers["0.FE_prepare"].n == timers["0.FE_finalize"].n == 3
    assert timers["1.BA_nobs"].vmin > 0
    total = {k: st.n * st.mean for k, st in timers.items()}
    for child, parent in PARENTS.items():
        if child in total:
            assert total[child] <= total[parent], (child, parent)
