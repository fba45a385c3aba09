"""The port with ``bdo_stereo_rect`` on the distorted hard-synthetic rig
(k1 = -0.28, k2 = 0.07), 30 frames, against the JAX system on the same
frames: every frame is remapped (bicubic) on the device before tracking.

Held as ``test_torch_e2e.py`` holds the slice: ATE within 1 mm of JAX,
every frame within 5 mm, keyframe counts within one.
"""

import numpy as np

from ov2slam_tpu.config import SlamParams as JParams
from ov2slam_tpu.io.trajectories import ate_rmse
from ov2slam_tpu.slam.manager import SlamSystem as JSlam
from ov2slam_tpu_torch.config import SlamParams
from ov2slam_tpu_torch.slam.manager import SlamSystem

import hard_synthetic as hs
import torch_parity  # noqa: F401  (caps torch threads)

N_FRAMES = 30


def test_stereo_rect_matches_jax():
    L, R, gt = [], [], []
    for i, (il, ir, _, T) in enumerate(hs.render_hard_sequence(n_frames=1000)):
        if i == N_FRAMES:
            break
        L.append(il.astype(np.uint8))
        R.append(ir.astype(np.uint8))
        gt.append(T[:3, 3])
    gt = np.stack(gt)
    d = hs.params_dict(dist=(-0.28, 0.07), use_clahe=0)
    d.update(bdo_stereo_rect=1, prewarm=0)
    js = JSlam(JParams.from_dict(d))
    ts = SlamSystem(SlamParams.from_dict(d), device="cpu")
    assert ts.rect_maps is not None and ts._rows_aligned
    est = [np.stack([s.process_stereo(L[i], R[i], i * 0.05)[:3, 3]
                     for i in range(N_FRAMES)]) for s in (js, ts)]
    ate_j, ate_t = (ate_rmse(e, gt) for e in est)
    assert ate_j < 0.05 and ate_t < 0.05, (ate_j, ate_t)
    assert abs(ate_t - ate_j) <= 1e-3, (ate_t, ate_j)
    dpos = np.linalg.norm(est[1] - est[0], axis=1)
    assert dpos.max() <= 5e-3, dpos
    assert abs(len(ts.map.keyframes) - len(js.map.keyframes)) <= 1
    assert ts.initialized and ts.map.n_3d() > 50
