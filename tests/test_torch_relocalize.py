"""Relocalization after total tracking loss: the port's
``LoopCloser.relocalize`` against the JAX package's from the same map, and
the port's own kidnap run.

The kidnap scenario of ``tests/test_loopclosing.py``: map 30 frames of the
out-and-back world, blind the camera for 6 frames, then show the view of
frame 6 again. The JAX system (R1 name patch, see
``tests/test_torch_loopclosing.py``) records every ``relocalize`` call with a
copy of its map and the place-index insertions before it; the port's loop
closer repeats each call on the copy, its index rebuilt from the same
insertions and its RANSACs fed the JAX package's draws. Tolerances: the
same outcome and candidate keyframe, the pose within 1e-3 m. The port's own
run relocalizes within 0.1 m of the truth and starts a new tracking chain.
"""

import numpy as np

from ov2slam_tpu.config import SlamParams as JParams
from ov2slam_tpu.slam.manager import SlamSystem as JSlam
from ov2slam_tpu_torch import interop
from ov2slam_tpu_torch.config import SlamParams
from ov2slam_tpu_torch.slam.manager import SlamSystem

import loop_synthetic_np as lsn
from test_torch_loopclosing import POSE_TOL, port_closer, r1, spy  # noqa: F401


def _kidnap(make, process, n_half=30, reappear=6):
    fl, fr, gt = lsn.render_out_and_back(n_half=n_half)
    slam = make()
    slam.loopcloser.detector.p_wait = 5
    for i in range(n_half):
        process(slam, fl[i], fr[i], i * 0.05)
    blank = np.full_like(fl[0], 127.0)
    for i in range(n_half, n_half + 6):
        process(slam, blank, blank, i * 0.05)
    T = None
    for i in range(n_half + 6, n_half + 10):
        T = process(slam, fl[reappear], fr[reappear], i * 0.05)
    return slam, T, gt[reappear]


def test_relocalize_matches_jax(r1):
    d = lsn.loop_params_dict(lc_loose_ba_time_s=0)
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

    jslam, _, _ = _kidnap(make, lambda s, l, r, t: s.process_stereo(l, r, t))
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


def test_port_relocalizes_after_kidnap():
    """tests/test_loopclosing.py::test_relocalization_after_kidnap on the
    port: blind frames, then a view mapped 24 frames before; the system
    relocalizes within 0.1 m and starts a new tracking chain."""
    d = lsn.loop_params_dict(lc_loose_ba_time_s=0)
    slam, T, gt = _kidnap(
        lambda: SlamSystem(SlamParams.from_dict(d), device="cpu"),
        lambda s, l, r, t: s.process_stereo(l, r, t))
    assert slam._chain_gen >= 1
    err = np.linalg.norm(T[:3, 3] - gt[:3, 3])
    assert err < 0.1, f"relocalization error {err:.3f} m"
