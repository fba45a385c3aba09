"""The port's loop closer (``slam/loopcloser.py``) against the JAX package's,
step by step, from the same map.

The JAX system runs the out-and-back world (``tests/loop_synthetic_np.py``)
until its first loop closure; each call of its ``_verify_and_close`` is
recorded with a copy of the map taken just before and just after
(``interop.map_store``). The port's loop closer then runs the same call on
the copy, its RANSACs fed the indices the JAX package draws
(``jax.random.choice`` under the same keys; ``jax_draw`` and
``port_closer`` serve ``tests/test_torch_relocalize.py`` too). The JAX
package needs the R1 name patch (``ov2slam_tpu/opt/ba.py:536``), supplied
by monkeypatch; ``lc_loose_ba_time_s`` is 0 (no wall-clock budget) in both.

Tolerances: the same event (query and match keyframes, the kNN pairs before
and after the local-map expansion exactly, PnP inliers and merges within
2); corrected keyframe poses within 1e-3 m and 1e-3 rad, landmark
positions within 5 mm (the LMs and PCG run float32 in another summation
order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ov2slam_tpu.config import SlamParams as JParams
from ov2slam_tpu.slam.manager import SlamSystem as JSlam
from ov2slam_tpu_torch import interop
from ov2slam_tpu_torch.config import SlamParams
from ov2slam_tpu_torch.slam.estimator import Estimator
from ov2slam_tpu_torch.slam.loopcloser import LoopCloser

import loop_synthetic_np as lsn
from torch_parity import r1_patched  # (also caps torch threads)

POSE_TOL, LM_TOL = 1e-3, 5e-3


def jax_draw(valid, n_hyps, size, seed):
    """The JAX package's RANSAC draw under PRNGKey(seed), as indices."""
    p = valid.cpu().numpy().astype(np.float32)
    p = p / max(float(p.sum()), 1.0)
    idx = jax.random.choice(jax.random.PRNGKey(seed), len(p),
                            shape=(n_hyps, size), p=jnp.asarray(p))
    return torch.from_numpy(np.asarray(idx).astype(np.int64))


@pytest.fixture(scope="module")
def r1():
    """Supply the name the JAX structure-only solver misses (R1), for the
    module (``torch_parity.r1_patched``)."""
    with r1_patched():
        yield


def port_closer(jslam, d):
    """A port LoopCloser on the JAX system's camera and calibration, with
    the JAX package's draws."""
    est = Estimator(SlamParams.from_dict(d), interop.calib(jslam.estimator.calib_l),
                    interop.calib(jslam.estimator.calib_r),
                    interop.se3(jslam.estimator.T_rl), device="cpu")
    return LoopCloser(SlamParams.from_dict(d), interop.camera(jslam.cam_l), est,
                      device="cpu", draw=jax_draw)


def spy(obj, name, calls, wrap):
    real = getattr(obj, name)
    setattr(obj, name, lambda *a, **k: wrap(real, calls, *a, **k))


@pytest.fixture(scope="module")
def closure(r1):
    """The JAX system up to its first loop closure, recording every
    verification with the map before and after it."""
    fl, fr, _ = lsn.render_out_and_back()
    d = lsn.loop_params_dict(lc_loose_ba_time_s=0)
    slam = JSlam(JParams.from_dict(d))
    lsn.set_detector(slam)
    calls = []

    def verify(real, calls, m, kfid, match_kf, key):
        before = interop.map_store(m)
        ev = real(m, kfid, match_kf, key)
        calls.append(dict(map=before, kfid=kfid, match_kf=match_kf, ev=ev,
                          after=interop.map_store(m)))
        return ev
    spy(slam.loopcloser, "_verify_and_close", calls, verify)
    for i in range(len(fl)):
        slam.process_stereo(fl[i], fr[i], i * 0.05)
        if any(c["ev"] is not None for c in calls):
            break
    return slam, d, calls


def test_verify_and_close_matches_jax(closure):
    jslam, d, calls = closure
    call = next(c for c in calls if c["ev"] is not None)
    mt = call["map"]
    ev = port_closer(jslam, d)._verify_and_close(mt, call["kfid"],
                                                  call["match_kf"])
    evj, mj = call["ev"], call["after"]
    assert ev is not None
    assert (ev.query_kf, ev.match_kf, ev.n_pairs_init, ev.n_pairs_local) == (
        evj.query_kf, evj.match_kf, evj.n_pairs_init, evj.n_pairs_local)
    assert abs(ev.n_inliers - evj.n_inliers) <= 2
    assert abs(ev.n_merged - evj.n_merged) <= 2
    assert abs(ev.pose_jump - evj.pose_jump) <= POSE_TOL
    assert sorted(mt.keyframes) == sorted(mj.keyframes)
    for k, rec in mj.keyframes.items():
        Tt, Tj = mt.keyframes[k].T_cw, rec.T_cw
        np.testing.assert_allclose(np.linalg.inv(Tt)[:3, 3],
                                   np.linalg.inv(Tj)[:3, 3], atol=POSE_TOL)
        np.testing.assert_allclose(Tt[:3, :3], Tj[:3, :3], atol=POSE_TOL)
    both = mt.lm_valid & mj.lm_valid & mt.lm_is3d & mj.lm_is3d
    assert both.sum() >= 0.98 * (mj.lm_valid & mj.lm_is3d).sum()
    np.testing.assert_allclose(mt.lm_pos[both], mj.lm_pos[both], atol=LM_TOL)


def test_failed_verifications_match_jax(closure):
    """Every candidate the JAX package rejected, the port rejects too."""
    jslam, d, calls = closure
    for c in calls:
        if c["ev"] is None:
            assert port_closer(jslam, d)._verify_and_close(
                c["map"], c["kfid"], c["match_kf"]) is None, c["kfid"]
