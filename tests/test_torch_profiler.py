"""The port's profiler (``ov2slam_tpu_torch/io/profiler.py``) against the
JAX package's, and its wiring into ``SlamSystem``.

Welford statistics and the summary table are byte-equal to the JAX
package's for the same timer values (both driven by one fake clock). Both
systems, run over the same synthetic frames with ``log_timings`` on and
the process-wide profiler reset before each, fill the same set of table
labels, synchronous (15 frames) and pipelined (``force_realtime``, 20
frames at 0.08 m steps: enough keyframes for the staged commits, the
local-map merge and the deferred BA). With ``log_timings`` off nothing is
recorded.
"""

import numpy as np
import pytest

import ov2slam_tpu.io.profiler as jprof
from ov2slam_tpu.config import SlamParams as JParams
from ov2slam_tpu.slam.manager import SlamSystem as JSlam
import ov2slam_tpu_torch.io.profiler as tprof
from ov2slam_tpu_torch.config import SlamParams
from ov2slam_tpu_torch.slam.manager import SlamSystem

import synthetic_np as syn
import torch_parity  # noqa: F401  (caps torch threads)


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
        labels[name] = sorted(prof.instance().timers)
    assert labels["torch"] == labels["jax"]
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
