"""Loop closing end to end, stereo: the port's ``SlamSystem`` against the
JAX package's over the out-and-back world (``tests/loop_synthetic_np.py``,
100 frames, synchronous, local-map matching off, ``do_full_ba`` on).

The two packages draw their RANSAC samples from different generators, so
they agree at trajectory level: the same (query, match) keyframe pair
closes the loop, the live ATEs and the relaxed full-trajectory
(``ov2slam_full_traj_wlc_opt.txt``) ATEs within 5 mm of each other, every
final-pass file written with one finite row per frame (per keyframe for the
full-BA file). The JAX package runs with the R1 name patch
(``ov2slam_tpu/opt/ba.py:536``, the fixture ``r1``); ``lc_loose_ba_time_s``
is 0 in both.
"""

import os

import numpy as np
import pytest

from ov2slam_tpu.config import SlamParams as JParams
from ov2slam_tpu.slam.manager import SlamSystem as JSlam
from ov2slam_tpu_torch.config import SlamParams
from ov2slam_tpu_torch.io.trajectories import ate_rmse
from ov2slam_tpu_torch.slam.manager import SlamSystem

import loop_synthetic_np as lsn
import torch_parity  # noqa: F401  (caps torch threads)
from test_torch_loopclosing import r1  # noqa: F401  (the R1 name patch)

ATE_TOL = 0.005
FILES = ("ov2slam_traj.txt", "ov2slam_fullba_kfs_traj.txt",
         "ov2slam_full_traj_wlc.txt", "ov2slam_full_traj_wlc_opt.txt")


def run(slam, frames, out_dir, mono=False):
    """Drive the system over the frames and write its results: (live ATE,
    wlc_opt ATE, the loaded final-pass files)."""
    fl, fr, gt = frames
    lsn.set_detector(slam)
    est = []
    for i in range(len(fl)):
        T = (slam.process_mono(fl[i], i * 0.05) if mono
             else slam.process_stereo(fl[i], fr[i], i * 0.05))
        est.append(np.asarray(T)[:3, 3])
    slam.write_results(str(out_dir))
    files = {f: np.loadtxt(out_dir / f) for f in FILES
             if (out_dir / f).exists()}
    gt_t = np.stack([T[:3, 3] for T in gt])
    return (ate_rmse(np.stack(est), gt_t, with_scale=mono),
            ate_rmse(files["ov2slam_full_traj_wlc_opt.txt"][:, 1:4], gt_t,
                     with_scale=mono), files)


@pytest.fixture(scope="module")
def frames():
    return lsn.render_out_and_back()


def test_stereo_loop_closure_matches_jax(frames, tmp_path, r1):
    d = lsn.loop_params_dict(do_full_ba=1, lc_loose_ba_time_s=0)
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    js = JSlam(JParams.from_dict(d))
    ate_j, opt_j, _ = run(js, frames, tmp_path / "jax")
    ts = SlamSystem(SlamParams.from_dict(d), device="cpu")
    ate_t, opt_t, files = run(ts, frames, tmp_path / "port")

    evj, ev = js.last_loop_event, ts.last_loop_event
    assert evj is not None and ev is not None
    assert (ev.query_kf, ev.match_kf) == (evj.query_kf, evj.match_kf)
    assert ev.n_inliers >= 30 and ev.n_pairs_local >= ev.n_pairs_init > 0
    assert abs(ate_t - ate_j) < ATE_TOL and abs(opt_t - opt_j) < ATE_TOL
    assert ate_t < 0.08 and opt_t < 0.08
    n_frames = len(frames[0])
    for f in FILES[2:]:
        assert files[f].shape == (n_frames, 8) and np.isfinite(files[f]).all(), f
    kfs = files["ov2slam_fullba_kfs_traj.txt"]
    assert kfs.shape == (len(ts.map.keyframes), 8) and np.isfinite(kfs).all()
    assert set(os.listdir(tmp_path / "port")) == set(os.listdir(tmp_path / "jax"))
