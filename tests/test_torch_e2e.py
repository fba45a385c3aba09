"""The ported stereo slice end to end, against the JAX SlamSystem on the same
synthetic sequence, plus the port's import hygiene.

The slice configuration is tests/synthetic.py's with doepipolar off. The two
systems cannot be bit-equal — the JAX package stores its pyramids in float16,
the port in float32 — so they are held to trajectory-level agreement. Runs
of this test measured an ATE difference of ~0.01 mm and per-frame positions
within 0.6 mm; the bounds below leave a tenfold margin.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from ov2slam_tpu.config import SlamParams as JParams
from ov2slam_tpu.io.trajectories import ate_rmse
from ov2slam_tpu.slam.manager import SlamSystem as JSlam
from ov2slam_tpu_torch.config import SlamParams
from ov2slam_tpu_torch.slam.manager import SlamSystem
from ov2slam_tpu_torch.slam.map import MapStore

import synthetic as syn
import torch_parity  # noqa: F401  (caps torch threads)

N_FRAMES = 20
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _params():
    d = syn.slam_params_dict()
    d["doepipolar"] = 0
    return d


@pytest.fixture(scope="module")
def sequence():
    return syn.render_sequence(n_frames=N_FRAMES, step=0.05)


def _run(slam, fl, fr, n):
    return np.stack([slam.process_stereo(fl[i], fr[i], i * 0.05)
                     for i in range(n)])


def test_slice_matches_jax_end_to_end(sequence, tmp_path):
    fl, fr, gt = sequence
    gt_t = np.stack([T[:3, 3] for T in gt])
    js = JSlam(JParams.from_dict(_params()))
    ts = SlamSystem(SlamParams.from_dict(_params()), device="cpu")
    est_j = _run(js, fl, fr, N_FRAMES)
    est_t = _run(ts, fl, fr, N_FRAMES)
    ate_j = ate_rmse(est_j[:, :3, 3], gt_t)
    ate_t = ate_rmse(est_t[:, :3, 3], gt_t)
    assert ate_j < 0.05 and ate_t < 0.05, (ate_j, ate_t)
    assert abs(ate_t - ate_j) <= 1e-3, (ate_t, ate_j)
    assert abs(len(ts.map.keyframes) - len(js.map.keyframes)) <= 1
    assert ts.initialized and ts.map.n_3d() > 50
    dpos = np.linalg.norm(est_t[:, :3, 3] - est_j[:, :3, 3], axis=1)
    assert dpos.max() <= 5e-3, dpos
    ts.write_results(str(tmp_path))
    assert np.loadtxt(tmp_path / "ov2slam_traj.txt").shape == (N_FRAMES, 8)
    assert np.loadtxt(tmp_path / "ov2slam_traj_kitti.txt").shape == (N_FRAMES, 12)
    kfs = np.loadtxt(tmp_path / "ov2slam_kfs_traj.txt", ndmin=2)
    assert kfs.shape == (len(ts.map.keyframes), 8)
    # the port's map store checkpoints like the JAX one
    ts.map.save(str(tmp_path / "map.npz"))
    m2 = MapStore.load(str(tmp_path / "map.npz"))
    assert m2.n_3d() == ts.map.n_3d() and sorted(m2.keyframes) == sorted(ts.map.keyframes)
    np.testing.assert_array_equal(m2.lm_pos, ts.map.lm_pos)
    assert m2.covis == ts.map.covis
    for a, b in zip(m2.device_landmarks(), ts.map.device_landmarks()):
        assert torch.equal(a, b)


def test_slice_is_deterministic(sequence):
    fl, fr, _ = sequence
    runs = [_run(SlamSystem(SlamParams.from_dict(_params()), device="cpu"),
                 fl, fr, 8) for _ in range(2)]
    np.testing.assert_array_equal(runs[0], runs[1])


def test_port_imports_no_jax_cv2_or_yaml():
    code = ("import sys, ov2slam_tpu_torch.slam.manager, ov2slam_tpu_torch.interop; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'ov2slam_tpu', 'cv2', 'yaml')); "
            "assert not bad, bad")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env["PYTHONPATH"] = ROOT
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
