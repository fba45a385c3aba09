"""The port's command-line entry point (``python -m ov2slam_tpu_torch.run``)
against the JAX package's (``python -m ov2slam_tpu.run``).

A 12-frame synthetic stereo run (``tests/synthetic_np.py``) is written as
an EuRoC ASL tree (``tests/dataset_np.py``: 20 Hz ns stamps from
V1_01_easy's first, the right camera 2 ms later) with the synthetic rig's
preset as an OpenCV-dialect YAML (``do_full_ba`` on, as
``tests/test_harness.py::test_cli_end_to_end`` runs it). Both CLIs run it
as subprocesses on the CPU, with ``--viz-every 6``: they write the same
set of files with equal row counts, and the port's ATE is within 1 mm of
the JAX CLI's and within a quarter of it plus 0.1 mm. The port's CLI writes byte for byte the trajectory its own
``SlamSystem`` writes when driven in process over the same frames. Under
one fake clock and fake per-frame costs, both CLIs' loops process and drop
the same frames with ``force_realtime``. Without ``--device`` and without a
card the port's CLI raises.
"""

import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

import ov2slam_tpu.run as jrun
from ov2slam_tpu.config import SlamParams as JParams
from ov2slam_tpu_torch import device as device_mod
from ov2slam_tpu_torch import run as trun
from ov2slam_tpu_torch.config import SlamParams
from ov2slam_tpu_torch.io.datasets import make_reader
from ov2slam_tpu_torch.io.trajectories import ate_rmse
from ov2slam_tpu_torch.slam.manager import SlamSystem

import dataset_np as dnp
import synthetic_np as syn
import torch_parity  # noqa: F401  (caps torch threads)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 12
STAMPS = dnp.euroc_stamps(N)
# the ATEs (m) may differ by 1 mm and by a quarter of the JAX CLI's ATE
# plus 0.1 mm, whichever is tighter: the 1 mm alone could pass a port twice
# as far off when the JAX CLI's ATE is itself ~1 mm
ATE_TOL, ATE_REL, ATE_FLOOR = 1e-3, 0.25, 1e-4


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli")
    fl, fr, gt = syn.render_sequence(n_frames=N)
    dnp.write_euroc(str(root / "seq"), [f.astype(np.uint8) for f in fl],
                    [f.astype(np.uint8) for f in fr], STAMPS,
                    [t + 2_000_000 for t in STAMPS])
    d = syn.slam_params_dict()
    d.update(do_full_ba=1, buse_loop_closer=0)
    dnp.write_opencv_yaml(str(root / "params.yaml"), d)
    return root, np.stack([T[:3, 3] for T in gt])


def _cli(module, root, out, *extra):
    # two torch threads, as in this process (torch_parity), so that the
    # port's CPU sums run in the same order in both
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO,
               OMP_NUM_THREADS="2")
    return subprocess.run(
        [sys.executable, "-m", module, str(root / "params.yaml"),
         str(root / "seq"), "--dataset", "euroc", "--out", str(out), *extra],
        capture_output=True, text=True, env=env, timeout=400)


def _ate(path, gt):
    rows = np.loadtxt(path, ndmin=2)
    idx = np.rint((rows[:, 0] - STAMPS[0] * 1e-9) / 0.05).astype(int)
    return ate_rmse(rows[:, 1:4], gt[idx])


def _files(out):
    return {os.path.relpath(os.path.join(d, f), out): os.path.join(d, f)
            for d, _, fs in os.walk(out) for f in fs}


@pytest.fixture(scope="module")
def runs(dataset):
    root, _ = dataset
    outs = {}
    for name, module, extra in (("jax", "ov2slam_tpu.run", ["--no-cache"]),
                                ("torch", "ov2slam_tpu_torch.run",
                                 ["--device", "cpu"])):
        out = root / f"out_{name}"
        res = _cli(module, root, out, "--viz-every", "6", *extra)
        assert res.returncode == 0, res.stderr[-3000:]
        assert f"processed {N} frames" in res.stdout
        outs[name] = out
    return outs


def test_cli_writes_the_jax_file_set(runs, dataset):
    _, gt = dataset
    jf, tf = _files(runs["jax"]), _files(runs["torch"])
    assert sorted(tf) == sorted(jf)
    assert {"ov2slam_traj.txt", "ov2slam_full_traj_wlc_opt.txt",
            "viz/ov2slam_map_points.ply"} <= set(tf)
    for rel in tf:
        if rel.endswith(".txt"):
            a, b = np.loadtxt(tf[rel], ndmin=2), np.loadtxt(jf[rel], ndmin=2)
            assert a.shape == b.shape and np.isfinite(a).all(), rel
    assert np.loadtxt(tf["ov2slam_traj.txt"]).shape == (N, 8)
    ate_t = _ate(tf["ov2slam_traj.txt"], gt)
    ate_j = _ate(jf["ov2slam_traj.txt"], gt)
    gap = abs(ate_t - ate_j)
    assert gap <= ATE_TOL and gap <= ATE_REL * ate_j + ATE_FLOOR, (
        f"port ATE {ate_t:.6f} m, JAX {ate_j:.6f} m, gap {gap:.6f} m")


def test_cli_equals_the_system_in_process(runs, dataset, tmp_path):
    root, _ = dataset
    with device_mod.deterministic():
        slam = SlamSystem(SlamParams.from_yaml(str(root / "params.yaml")),
                          device="cpu")
        for il, ir, t in make_reader("euroc", str(root / "seq")):
            slam.process_stereo(il, ir, t)
        slam.write_results(str(tmp_path))
    for f in ("ov2slam_traj.txt", "ov2slam_kfs_traj.txt"):
        assert (tmp_path / f).read_text() == (runs["torch"] / f).read_text(), f


class _Clock:
    """A fake host clock that the fake system advances by each frame's
    processing cost."""

    def __init__(self, costs):
        self.now, self.costs = 0.0, costs

    def perf_counter(self):
        return self.now


def _fake_system(clock, processed):
    class FakeSlam:
        def __init__(self, params, device=None):
            self.map = types.SimpleNamespace(keyframes={}, n_3d=lambda: 0)
            self.prof = None

        def process_stereo(self, iml, imr, t):
            processed.append(t)
            clock.now += clock.costs[iml]

        def write_results(self, out):
            pass
    return FakeSlam


def test_frame_dropping_equals_jax(monkeypatch, tmp_path):
    """force_realtime's replay: frames at 20 Hz, processing costs drawn
    around the period, so that some frames drop and some do not."""
    rng = np.random.default_rng(0)
    n = 60
    costs = rng.uniform(0.0, 0.12, n)
    # (left, right, t): the left "image" is the frame's index into costs
    frames = [(i, 0, 100.0 + 0.05 * i) for i in range(n)]
    params = types.SimpleNamespace(force_realtime=1, stereo=1, log_timings=0)
    processed = {}
    for name, mod, cfg, slam_mod, ds_mod, extra in (
            ("jax", jrun, JParams, "ov2slam_tpu.slam.manager",
             "ov2slam_tpu.io.datasets", ["--no-cache"]),
            ("torch", trun, SlamParams, "ov2slam_tpu_torch.slam.manager",
             "ov2slam_tpu_torch.io.datasets", ["--device", "cpu"])):
        clock, done = _Clock(costs), []
        monkeypatch.setattr(mod, "_time", clock)
        monkeypatch.setattr(f"{slam_mod}.SlamSystem", _fake_system(clock, done))
        monkeypatch.setattr(f"{ds_mod}.make_reader", lambda *a, **k: frames)
        monkeypatch.setattr(cfg, "from_yaml", staticmethod(lambda path: params))
        mod.main(["params.yaml", "seq", "--out", str(tmp_path), *extra])
        processed[name] = done
    assert processed["torch"] == processed["jax"]
    assert 0 < len(processed["torch"]) < n
    # the helper alone, under the same clock: the same frames, and the
    # dropped ones are the rest
    clock, done, dropped = _Clock(costs), [], []
    for iml, _, t in trun._stream(frames, True, clock.perf_counter, dropped):
        done.append(t)
        clock.now += costs[iml]
    assert done == processed["jax"]
    assert sorted(done + dropped) == [f[2] for f in frames]


def test_cli_without_device_needs_a_card(dataset, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    root, _ = dataset
    res = _cli("ov2slam_tpu_torch.run", root, tmp_path / "out")
    assert res.returncode != 0
    assert "no CUDA device" in res.stderr
    assert not (tmp_path / "out").exists()
