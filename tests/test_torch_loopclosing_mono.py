"""Loop closing end to end, mono: the port's ``SlamSystem.process_mono``
against the JAX package's over the out-and-back world (100 frames,
synchronous): the same (query, match) keyframe pair closes the loop, the
live and the relaxed full-trajectory Sim(3) ATEs within 5 mm of the JAX
package's, the relaxed trajectory finite, accurate (< 0.08) and no worse
than the live one (x 1.2 + 1 mm), the gates of
``tests/test_loopclosing.py::test_mono_loop_closure_corrects_drift``.
"""

import numpy as np

from ov2slam_tpu.config import SlamParams as JParams
from ov2slam_tpu.slam.manager import SlamSystem as JSlam
from ov2slam_tpu_torch.config import SlamParams
from ov2slam_tpu_torch.slam.manager import SlamSystem

import loop_synthetic_np as lsn
from test_torch_loopclosing import r1  # noqa: F401  (the R1 name patch)
from test_torch_loopclosing_e2e import ATE_TOL, run


def test_mono_loop_closure_matches_jax(tmp_path, r1):
    frames = lsn.render_out_and_back()
    d = lsn.loop_params_dict(mono=1, stereo=0, lc_loose_ba_time_s=0)
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    js = JSlam(JParams.from_dict(d))
    ate_j, opt_j, _ = run(js, frames, tmp_path / "jax", mono=True)
    ts = SlamSystem(SlamParams.from_dict(d), device="cpu")
    ate_t, opt_t, files = run(ts, frames, tmp_path / "port", mono=True)

    assert ts.initialized
    evj, ev = js.last_loop_event, ts.last_loop_event
    assert evj is not None and ev is not None
    assert (ev.query_kf, ev.match_kf) == (evj.query_kf, evj.match_kf)
    assert ev.match_kf < ev.query_kf
    assert abs(ate_t - ate_j) < ATE_TOL and abs(opt_t - opt_j) < ATE_TOL
    opt = files["ov2slam_full_traj_wlc_opt.txt"]
    assert opt.shape == (len(frames[0]), 8) and np.isfinite(opt).all()
    assert opt_t < 0.08 and opt_t <= 1.2 * ate_t + 1e-3
