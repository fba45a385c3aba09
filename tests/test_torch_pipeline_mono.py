"""The port's pipelined mono mode (``force_realtime`` after the bootstrap)
against the JAX system in the same mode on the same 50 synthetic frames:
equal keyframe timestamps, Sim(3)-aligned ATEs within 1e-4 m of each other
and below the 0.08 m bound of ``tests/test_e2e_mono.py``.
"""

import numpy as np

from ov2slam_tpu.config import SlamParams as JParams
from ov2slam_tpu.slam.manager import SlamSystem as JSlam
from ov2slam_tpu_torch.config import SlamParams
from ov2slam_tpu_torch.slam.manager import SlamSystem

import synthetic as syn
import torch_parity  # noqa: F401  (caps torch threads)
from test_e2e_mono import umeyama_scale_ate

N_FRAMES = 50


def test_pipelined_mono_matches_jax():
    fl, _, gt = syn.render_sequence(n_frames=N_FRAMES, step=0.05)
    gt_t = np.stack([T[:3, 3] for T in gt])
    d = syn.slam_params_dict()
    d.update({"mono": 1, "stereo": 0, "force_realtime": 1})
    runs = []
    for slam in (JSlam(JParams.from_dict(d)),
                 SlamSystem(SlamParams.from_dict(d), device="cpu")):
        depth = 0
        for i in range(N_FRAMES):
            slam.process_mono(fl[i], i * 0.05)
            depth = max(depth, len(slam._inflight))
        slam.flush()
        lg = slam.logger
        est = np.stack(lg.poses_wc)
        assert est.shape == (N_FRAMES, 4, 4) and slam.initialized
        runs.append((umeyama_scale_ate(est[:, :3, 3], gt_t)[0],
                     [t for t, k in zip(lg.times, lg.is_kf) if k], depth))
    (ate_j, kf_j, _), (ate_t, kf_t, depth_t) = runs
    assert kf_t == kf_j, (kf_t, kf_j)
    assert ate_j < 0.08 and ate_t < 0.08, (ate_j, ate_t)
    assert abs(ate_t - ate_j) <= 1e-4, (ate_t, ate_j)
    assert depth_t == d.get("pipeline_depth", 6)
