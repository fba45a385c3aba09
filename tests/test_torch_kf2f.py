"""The port with ``btrack_keyframetoframe`` (KLT templates from the last
keyframe's pyramid at the keyframe positions) against the JAX system on 30
frames of the synthetic slice: ATE within 1 mm of JAX, every frame within
5 mm, keyframe counts within one; and the templates re-anchor at every
keyframe.
"""

import numpy as np

from ov2slam_tpu.config import SlamParams as JParams
from ov2slam_tpu.io.trajectories import ate_rmse
from ov2slam_tpu.slam.manager import SlamSystem as JSlam
from ov2slam_tpu_torch.config import SlamParams
from ov2slam_tpu_torch.slam.manager import SlamSystem

import synthetic as syn
import torch_parity  # noqa: F401  (caps torch threads)

N_FRAMES = 30


def test_kf_to_frame_tracking_matches_jax():
    fl, fr, gt = syn.render_sequence(n_frames=N_FRAMES, step=0.05)
    gt_t = np.stack([T[:3, 3] for T in gt])
    d = syn.slam_params_dict()
    d["btrack_keyframetoframe"] = 1
    js = JSlam(JParams.from_dict(d))
    ts = SlamSystem(SlamParams.from_dict(d), device="cpu")
    est_j, est_t, tmpl = [], [], []
    for i in range(N_FRAMES):
        est_j.append(js.process_stereo(fl[i], fr[i], i * 0.05)[:3, 3])
        est_t.append(ts.process_stereo(fl[i], fr[i], i * 0.05)[:3, 3])
        tmpl.append(ts.fe_state.kf_pyr[0])
    est_j, est_t = np.stack(est_j), np.stack(est_t)
    ate_j, ate_t = ate_rmse(est_j, gt_t), ate_rmse(est_t, gt_t)
    assert ate_j < 0.05 and ate_t < 0.05, (ate_j, ate_t)
    assert abs(ate_t - ate_j) <= 1e-3, (ate_t, ate_j)
    assert np.linalg.norm(est_t - est_j, axis=1).max() <= 5e-3
    assert abs(len(ts.map.keyframes) - len(js.map.keyframes)) <= 1
    # the template changed exactly at the keyframes
    n_changes = sum(tmpl[i] is not tmpl[i - 1] for i in range(1, N_FRAMES))
    assert n_changes == len(ts.map.keyframes) - 1 >= 2
