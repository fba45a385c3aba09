"""Relocalization after total tracking loss: the port's
``LoopCloser.relocalize`` against the JAX package's from the same map, and
the port's own kidnap runs, stereo and mono.

The kidnap scenarios of ``tests/test_loopclosing.py``: map 30 frames of the
out-and-back world, blind the camera for 6 frames, then show the view of a
mapped frame again (frame 6 in stereo, frame 8 in mono, as
``test_mono_relocalization_after_kidnap`` runs it). The JAX system (R1 name
patch, see ``tests/test_torch_loopclosing.py``) records every
``relocalize`` call with a copy of its map and the place-index insertions
before it; the port's loop closer repeats each call on the copy, its index
rebuilt from the same insertions and its RANSACs fed the JAX package's
draws. Tolerances: the same outcome and candidate keyframe, the pose within
1e-3 m. The port's own run starts a new tracking chain and relocalizes:
stereo within 0.1 m of the truth; mono, whose map has the bootstrap's
scale, without a reset and within 0.05 map units of its own estimate of
that view.
"""

import numpy as np
import pytest

from ov2slam_tpu.config import SlamParams as JParams
from ov2slam_tpu.slam.manager import SlamSystem as JSlam
from ov2slam_tpu_torch import interop
from ov2slam_tpu_torch.config import SlamParams
from ov2slam_tpu_torch.slam.manager import SlamSystem

import loop_synthetic_np as lsn
from test_torch_loopclosing import POSE_TOL, port_closer, r1, spy  # noqa: F401


# mode -> (settings over loop_params_dict, the mapped frame shown again)
KIDNAPS = {"stereo": ({}, 6), "mono": (dict(mono=1, stereo=0), 8)}


def _kidnap(make, mode, n_half=30):
    """(system, pose at the end, true pose of the view shown again, the
    system's own estimate of that view, keyframes before the blackout)."""
    fl, fr, gt = lsn.render_out_and_back(n_half=n_half)
    reappear = KIDNAPS[mode][1]
    slam = make()
    slam.loopcloser.detector.p_wait = 5

    def process(l, r, t):
        if mode == "mono":
            return slam.process_mono(l, t)
        return slam.process_stereo(l, r, t)
    est = [process(fl[i], fr[i], i * 0.05).copy() for i in range(n_half)]
    n_kf = len(slam.map.keyframes)
    blank = np.full_like(fl[0], 127.0)
    for i in range(n_half, n_half + 6):
        process(blank, blank, i * 0.05)
    T = None
    for i in range(n_half + 6, n_half + 10):
        T = process(fl[reappear], fr[reappear], i * 0.05)
    return slam, T, gt[reappear], est[reappear], n_kf


def _params(mode):
    return lsn.loop_params_dict(lc_loose_ba_time_s=0, **KIDNAPS[mode][0])


@pytest.mark.parametrize("mode", list(KIDNAPS))
def test_relocalize_matches_jax(r1, mode):
    d = _params(mode)
    adds, relocs = [], []

    def make():
        slam = JSlam(JParams.from_dict(d))
        det = slam.loopcloser.detector

        def process(real, calls, kf_id, descs):
            calls.append((kf_id, np.array(descs)))
            return real(kf_id, descs)

        def relocalize(real, calls, m, descs, valid, bvs, unpxs, key=None):
            snap = interop.map_store(m)
            res = real(m, descs, valid, bvs, unpxs, key)
            calls.append(dict(map=snap, n_adds=len(adds), args=tuple(
                np.array(a) for a in (descs, valid, bvs, unpxs)), res=res))
            return res
        spy(det, "process", adds, process)
        spy(slam.loopcloser, "relocalize", relocs, relocalize)
        return slam

    jslam = _kidnap(make, mode)[0]
    assert relocs and relocs[-1]["res"] is not None
    for call in relocs:
        lc = port_closer(jslam, d)
        for kf_id, descs in adds[:call["n_adds"]]:
            if len(descs):
                lc.detector.index.add_image(kf_id, descs)
        res = lc.relocalize(call["map"], *call["args"])
        assert (res is None) == (call["res"] is None)
        if res is not None:
            (T, kf), (Tj, kfj) = res, call["res"]
            assert kf == kfj
            np.testing.assert_allclose(np.linalg.inv(T)[:3, 3],
                                       np.linalg.inv(Tj)[:3, 3], atol=POSE_TOL)


@pytest.mark.parametrize("mode", list(KIDNAPS))
def test_port_relocalizes_after_kidnap(mode):
    """tests/test_loopclosing.py's kidnap tests on the port: blind frames,
    then a view mapped 24 (stereo) or 22 (mono) frames before; the system
    starts a new tracking chain and relocalizes."""
    slam, T, gt, own, n_kf = _kidnap(
        lambda: SlamSystem(SlamParams.from_dict(_params(mode)), device="cpu"),
        mode)
    assert slam._chain_gen >= 1
    if mode == "stereo":
        err = np.linalg.norm(T[:3, 3] - gt[:3, 3])
        assert err < 0.1, f"relocalization error {err:.3f} m"
    else:
        assert slam.initialized and len(slam.map.keyframes) >= n_kf, "map was reset"
        err = np.linalg.norm(T[:3, 3] - own[:3, 3])
        assert err < 0.05, f"mono relocalization error {err:.3f} (map units)"
