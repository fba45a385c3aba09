"""The port's monocular path (``SlamSystem.process_mono``) end to end on
the CPU, mirroring ``tests/test_e2e_mono.py``, against the JAX system on
the same sequence.

The two systems draw their RANSAC samples from different generators (JAX
keys vs torch.Generator), so they are held at the trajectory level: both
initialize, each has a Sim(3)-aligned ATE below 0.08 m (the bound of
``test_e2e_mono.py``), their init frames and keyframe counts agree within
one, their ATEs within 5e-5 m and their Sim(3)-aligned positions within
5 mm on every frame. Measured on this 50-frame sequence: ATE 0.0232286 m
vs 0.0232318 m (3.2e-6 m apart), aligned positions at most 0.93 mm apart,
the same init frame 4, 10 keyframes and 245 landmarks each; the
bootstrap's 5-point RANSAC and the Gauss-Newton polish after it pin the
initial pose whatever the draw.
"""

import numpy as np
import pytest

from ov2slam_tpu.config import SlamParams as JParams
from ov2slam_tpu.slam.manager import SlamSystem as JSlam
from ov2slam_tpu_torch.config import SlamParams
from ov2slam_tpu_torch.slam import frontend as tfe
from ov2slam_tpu_torch.slam.manager import SlamSystem

import synthetic as syn
import torch_parity  # noqa: F401  (caps torch threads)
from test_e2e_mono import umeyama_scale_ate

N_FRAMES = 50


def _sim3_aligned(est, gt):
    """est (N, 3) positions after the Sim(3) alignment onto gt that
    ``umeyama_scale_ate`` scores."""
    est, gt = np.asarray(est, np.float64), np.asarray(gt, np.float64)
    mu_e, mu_g = est.mean(0), gt.mean(0)
    E, G = est - mu_e, gt - mu_g
    U, D, Vt = np.linalg.svd(G.T @ E / len(est))
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    c = np.trace(np.diag(D) @ S) / max((E ** 2).sum() / len(est), 1e-12)
    return c * (U @ S @ Vt @ E.T).T + mu_g


def _mono(**extra):
    d = syn.slam_params_dict()
    d.update({"mono": 1, "stereo": 0})
    d.update(extra)
    return d


@pytest.fixture(scope="module")
def sequence():
    return syn.render_sequence(n_frames=N_FRAMES, step=0.05)


def _run(slam, frames, n):
    est, init_at = [], None
    for i in range(n):
        est.append(slam.process_mono(frames[i], time=i * 0.05))
        if slam.initialized and init_at is None:
            init_at = i
    return np.stack(est), init_at


def test_mono_matches_jax_end_to_end(sequence, tmp_path):
    fl, _, gt = sequence
    gt_t = np.stack([T[:3, 3] for T in gt])
    js = JSlam(JParams.from_dict(_mono()))
    ts = SlamSystem(SlamParams.from_dict(_mono()), device="cpu")
    est_j, init_j = _run(js, fl, N_FRAMES)
    est_t, init_t = _run(ts, fl, N_FRAMES)
    assert js.initialized and ts.initialized
    assert np.isfinite(est_t).all()
    ate_j, _ = umeyama_scale_ate(est_j[:, :3, 3], gt_t)
    ate_t, _ = umeyama_scale_ate(est_t[:, :3, 3], gt_t)
    assert ate_j < 0.08 and ate_t < 0.08, (ate_j, ate_t)
    assert abs(ate_t - ate_j) <= 5e-5, (ate_t, ate_j)
    dpos = np.linalg.norm(_sim3_aligned(est_t[:, :3, 3], gt_t)
                          - _sim3_aligned(est_j[:, :3, 3], gt_t), axis=1)
    assert dpos.max() <= 5e-3, dpos
    assert abs(init_t - init_j) <= 1
    assert abs(len(ts.map.keyframes) - len(js.map.keyframes)) <= 1
    assert ts.map.n_3d() > 40
    assert np.linalg.norm(np.diff(est_t[:, :3, 3], axis=0), axis=1).sum() > 0.1
    ts.write_results(str(tmp_path))
    assert np.loadtxt(tmp_path / "ov2slam_traj.txt").shape == (N_FRAMES, 8)
    assert np.loadtxt(tmp_path / "ov2slam_traj_kitti.txt").shape == (N_FRAMES, 12)


def test_mono_no_parallax_no_init(sequence):
    """A static camera never initializes (no parallax)."""
    fl = sequence[0]
    slam = SlamSystem(SlamParams.from_dict(_mono()), device="cpu")
    for i in range(12):
        T = slam.process_mono(fl[0], time=i * 0.05)
        assert np.isfinite(T).all()
    assert not slam.initialized and len(slam.map.keyframes) == 1


def test_mono_pnp_failure_recovered_by_p3p(sequence, monkeypatch):
    """A frame whose prior-seeded PnP fails (pose_ok forced to 0 in its
    stats) is recovered by P3P-RANSAC + robust PnP, close to the pose the
    PnP had found, and tracking goes on."""
    fl, _, gt = sequence
    slam = SlamSystem(SlamParams.from_dict(_mono()), device="cpu")
    _run(slam, fl, 12)
    assert slam.initialized
    real_step = tfe.frame_step
    seen = {}

    def failing_step(*a, **k):
        state, stats = real_step(*a, **k)
        seen["stats"] = stats.clone()
        stats[0] = 0.0
        return state, stats

    recoveries = []
    real_recovery = slam._try_p3p_recovery
    monkeypatch.setattr(slam, "_try_p3p_recovery",
                        lambda: recoveries.append(real_recovery()) or recoveries[-1])
    monkeypatch.setattr(tfe, "frame_step", failing_step)
    slam.process_mono(fl[12], time=12 * 0.05)
    monkeypatch.setattr(tfe, "frame_step", real_step)
    assert recoveries == [True]
    pnp_t = seen["stats"].numpy()[5:8]
    assert seen["stats"][2] >= 10
    np.testing.assert_allclose(slam.T_cw[:3, 3], pnp_t, atol=5e-3)
    for i in range(13, 16):
        T = slam.process_mono(fl[i], time=i * 0.05)
        assert np.isfinite(T).all()
    assert slam.initialized and len(slam.logger.times) == 16


def test_mono_is_deterministic(sequence):
    """One seed, one trajectory: with the P3P start (dop3p) drawing every
    frame and the bootstrap drawing once."""
    fl = sequence[0]
    runs = [_run(SlamSystem(SlamParams.from_dict(_mono(dop3p=1)), device="cpu"),
                 fl, 9)[0] for _ in range(2)]
    np.testing.assert_array_equal(runs[0], runs[1])
    assert not np.allclose(runs[0][-1], np.eye(4))
