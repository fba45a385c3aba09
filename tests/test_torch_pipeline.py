"""The port's pipelined stereo mode (``force_realtime``: in-flight frames,
the staged keyframe commit, deferred local BA) against the JAX system in
the same mode, on the same synthetic sequence, plus the late-correction
algebra of ``tests/test_e2e_stereo.py``.

Both systems stage at the same fixed frame lags, so their keyframes land
on the same frames: the keyframe timestamps must be equal. Trajectories
are held as in ``test_torch_e2e.py`` (pyramids stored float16 in both,
triangulations rounded alike, RANSAC draws and other sums not): ATE
within 1 mm, every frame within 5 mm.
"""

import numpy as np
import pytest

from ov2slam_tpu.config import SlamParams as JParams
from ov2slam_tpu.io.trajectories import ate_rmse
from ov2slam_tpu.slam.manager import SlamSystem as JSlam
from ov2slam_tpu_torch.config import SlamParams
from ov2slam_tpu_torch.slam.manager import SlamSystem

import synthetic as syn
import torch_parity  # noqa: F401  (caps torch threads)

N_FRAMES = 40


def realtime_params():
    d = syn.slam_params_dict()
    d["force_realtime"] = 1
    return d


def run_pipelined(slam, fl, fr, n):
    """Frames 0..n-1, then flush: the logged poses (n, 4, 4), the keyframe
    timestamps and the deepest in-flight FIFO."""
    depth = 0
    for i in range(n):
        slam.process_stereo(fl[i], fr[i], i * 0.05)
        depth = max(depth, len(slam._inflight))
    slam.flush()
    lg = slam.logger
    kf_times = [t for t, k in zip(lg.times, lg.is_kf) if k]
    return np.stack(lg.poses_wc), kf_times, depth


@pytest.fixture(scope="module")
def sequence():
    return syn.render_sequence(n_frames=N_FRAMES, step=0.05)


def test_pipelined_stereo_matches_jax(sequence):
    fl, fr, gt = sequence
    gt_t = np.stack([T[:3, 3] for T in gt])
    js = JSlam(JParams.from_dict(realtime_params()))
    ts = SlamSystem(SlamParams.from_dict(realtime_params()), device="cpu")
    est_j, kf_j, _ = run_pipelined(js, fl, fr, N_FRAMES)
    est_t, kf_t, depth = run_pipelined(ts, fl, fr, N_FRAMES)
    assert est_t.shape == (N_FRAMES, 4, 4) and np.isfinite(est_t).all()
    assert kf_t == kf_j, (kf_t, kf_j)
    assert len(kf_t) >= 3
    ate_j = ate_rmse(est_j[:, :3, 3], gt_t)
    ate_t = ate_rmse(est_t[:, :3, 3], gt_t)
    assert ate_j < 0.05 and ate_t < 0.05, (ate_j, ate_t)
    assert abs(ate_t - ate_j) <= 1e-3, (ate_t, ate_j)
    dpos = np.linalg.norm(est_t[:, :3, 3] - est_j[:, :3, 3], axis=1)
    assert dpos.max() <= 5e-3, dpos
    # the pipeline ran: the FIFO filled, a staged commit and a deferred BA
    # writeback landed at their lags
    assert depth == ts.params.pipeline_depth
    assert ts.pipeline_counts["kf_commit_lag"] >= 1
    assert ts.pipeline_counts["ba_writeback"] >= 1
    assert not ts._inflight and ts._pending_kf is None and ts._pending_ba is None
    assert len(ts.map.keyframes) == len(js.map.keyframes)


def test_inflight_frames_get_late_corrections():
    """tests/test_e2e_stereo.py::test_inflight_frames_get_late_corrections
    on the port: a correction that lands while a frame is in flight is
    folded into its pose at finalize, corrections compose in order, and
    reset clears the accumulator."""
    slam = SlamSystem(SlamParams.from_dict(realtime_params()), device="cpu")
    rng = np.random.default_rng(3)
    T = np.eye(4, dtype=np.float32)
    T[:3, 3] = rng.normal(0, 1, 3)
    corr_at_dispatch = slam._corr_cw
    np.testing.assert_array_equal(slam._late_corrected(T, corr_at_dispatch), T)
    T_old = np.eye(4)
    T_new = np.eye(4)
    T_new[:3, 3] = [0.3, -0.2, 0.1]
    dT = np.linalg.inv(T_old) @ T_new
    slam._apply_pose_correction(T_old, T_new)
    np.testing.assert_allclose(slam._corr_cw, dT, atol=1e-12)
    np.testing.assert_allclose(slam._late_corrected(T, corr_at_dispatch),
                               T.astype(np.float64) @ dT, atol=1e-6)
    T_new2 = np.eye(4)
    T_new2[:3, :3] = np.array([[0, -1, 0], [1, 0, 0], [0, 0, 1]], np.float64)
    slam._apply_pose_correction(T_old, T_new2)
    np.testing.assert_allclose(slam._late_corrected(T, corr_at_dispatch),
                               T.astype(np.float64) @ dT @ T_new2, atol=1e-6)
    np.testing.assert_array_equal(slam._late_corrected(T, slam._corr_cw), T)
    slam.reset()
    np.testing.assert_array_equal(slam._corr_cw, np.eye(4))
