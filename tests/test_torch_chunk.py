"""The chunked tracking path of the port (``frontend.frame_chunk_step``,
``SlamSystem.process_stereo_chunk``, ``run --chunk``) against the JAX
package's (its ``lax.scan`` over the frame step), on the CPU.

* ``frame_chunk_step`` over 4 frames from the JAX package's state after the
  first keyframe (``doepipolar`` off), as ``test_torch_slam.py`` holds one
  ``frame_step``: pose_ok, tracked and 3D counts equal, positions to 3e-5
  m and rotations to 2e-6 in every row (both packages store their pyramids
  in float16; this CPU measured 2.6e-6 m and 2.0e-7: the bounds are
  tenfold).
* On the CPU ``frame_chunk_step`` is N calls of ``frame_step``: equal bit
  for bit, the epipolar filter on (its draws from one seeded generator).
* ``process_stereo_chunk`` over ``tests/synthetic.py``'s 20-frame sequence
  in chunks of 4 through both packages: ATE difference <= 2.5e-5 m,
  positions within 1.2e-3 m, keyframes equal (this CPU measured 2.3e-6 m
  and 1.2e-4 m: tenfold); 20 poses logged, and inside a chunk a keyframe
  only on its last frame.

``run --chunk`` is held to the JAX CLI in ``test_torch_chunk_cli.py`` (a
file of its own, so that the test workers run the two JAX compiles of the
scan side by side).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from ov2slam_tpu.config import SlamParams as JParams
from ov2slam_tpu.io.trajectories import ate_rmse
from ov2slam_tpu.slam import frontend as jfe
from ov2slam_tpu.slam.manager import SlamSystem as JSlam
from ov2slam_tpu_torch import interop
from ov2slam_tpu_torch.config import SlamParams
from ov2slam_tpu_torch.slam import frontend as tfe
from ov2slam_tpu_torch.slam.manager import SlamSystem

import synthetic as syn
from torch_parity import n

N_FRAMES, CHUNK = 20, 4


def _params(doepipolar):
    d = syn.slam_params_dict()
    d["doepipolar"] = doepipolar
    return d


@pytest.fixture(scope="module")
def sequence():
    return syn.render_sequence(n_frames=N_FRAMES, step=0.05)


def test_frame_chunk_step_matches_jax(sequence):
    """Frames 1-4 in one chunk from the JAX state after frame 0."""
    fl, fr, _ = sequence
    js = JSlam(JParams.from_dict(_params(0)))
    js.process_stereo(fl[0], fr[0], 0.0)
    st = interop.fe_state(js.fe_state)       # before the donating call
    lm_pos, lm_is3d = js.map.device_landmarks()
    lm_t = interop.landmarks(np.asarray(lm_pos), np.asarray(lm_is3d))
    imgs = np.stack([f.astype(np.uint8) for f in fl[1:5]])
    p = js.params
    kw = dict(levels=p.nklt_pyr_lvl, use_clahe=False, clahe_clip=p.fclahe_val,
              nklt_win=p.nklt_win_size, nmax_iter=p.nmax_iter,
              fmax_px_precision=p.fmax_px_precision,
              fmax_fbklt_dist=p.fmax_fbklt_dist, klt_err=p.nklt_err,
              do_epipolar=False, fransac_err=p.fransac_err,
              robust_th2=p.robust_mono_th, n_ransac_hyps=jfe.ransac_hyps_of(p))
    _, stats_j = jfe.frame_chunk_step(js.fe_state, jnp.asarray(imgs), lm_pos,
                                      lm_is3d, js.cam_l, **kw)
    new_t, stats_t = tfe.frame_chunk_step(
        st, torch.from_numpy(imgs), *lm_t, interop.camera(js.cam_l), **kw)
    sj, s_t = np.asarray(stats_j), n(stats_t)
    assert sj.shape == s_t.shape == (4, 12)
    np.testing.assert_array_equal(s_t[:, 0], sj[:, 0])
    assert (s_t[:, 0] == 1.0).all()
    np.testing.assert_array_equal(s_t[:, 1:3], sj[:, 1:3])
    np.testing.assert_allclose(s_t[:, 5:8], sj[:, 5:8], atol=3e-5)
    np.testing.assert_allclose(s_t[:, 8:12], sj[:, 8:12], atol=2e-6)
    np.testing.assert_allclose(n(new_t.t_cw), s_t[-1, 5:8], atol=0)
    assert bool(new_t.has_vel) and not bool(st.has_vel)


def test_frame_chunk_step_on_cpu_is_frame_steps(sequence, monkeypatch):
    """The plain version: N frame_step calls, bit for bit (filter on)."""
    fl, fr, _ = sequence
    opened = []
    gate_open = tfe.gate_open
    monkeypatch.setattr(tfe, "gate_open",
                        lambda g: opened.append(gate_open(g)) or opened[-1])
    slam = SlamSystem(SlamParams.from_dict(_params(1)), device="cpu")
    for i in range(3):
        slam.process_stereo(fl[i], fr[i], i * 0.05)
    lm = slam.map.device_landmarks()
    kw = slam._step_kwargs()
    # frames 3-10 only: wide steps that open the parallax gate
    imgs = torch.from_numpy(np.stack([f.astype(np.uint8) for f in fl[3:11:2]]))
    gen_state = slam.fe_state.gen.get_state()
    chunk_state, chunk_stats = tfe.frame_chunk_step(
        slam.fe_state, imgs, *lm, slam.cam_l, **kw)
    slam.fe_state.gen.set_state(gen_state)
    state, rows = slam.fe_state, []
    for img in imgs:
        state, s = tfe.frame_step(state, img, *lm, slam.cam_l, **kw)
        rows.append(s)
    assert any(opened[:len(imgs)]), opened
    assert torch.equal(chunk_stats, torch.stack(rows))
    for a, b in zip(chunk_state, state):
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b)
        elif isinstance(a, tuple):
            assert all(torch.equal(x, y) for x, y in zip(a, b))


def _run_chunks(slam, fl, fr):
    for i in range(0, N_FRAMES, CHUNK):
        slam.process_stereo_chunk(
            [(fl[j], fr[j], j * 0.05) for j in range(i, i + CHUNK)])
    slam.flush()
    return np.stack([np.asarray(T)[:3, 3] for T in slam.logger.poses_wc])


def test_process_stereo_chunk_matches_jax(sequence):
    fl, fr, gt = sequence
    gt_t = np.stack([T[:3, 3] for T in gt])
    js = JSlam(JParams.from_dict(_params(1)))
    ts = SlamSystem(SlamParams.from_dict(_params(1)), device="cpu")
    est_j = _run_chunks(js, fl, fr)
    est_t = _run_chunks(ts, fl, fr)
    assert est_t.shape == est_j.shape == (N_FRAMES, 3)
    ate_j, ate_t = ate_rmse(est_j, gt_t), ate_rmse(est_t, gt_t)
    assert ate_j < 0.05 and ate_t < 0.05, (ate_j, ate_t)
    assert abs(ate_t - ate_j) <= 2.5e-5, (ate_t, ate_j)
    assert len(ts.map.keyframes) == len(js.map.keyframes)
    assert ts.initialized and ts.map.n_3d() > 50
    dpos = np.linalg.norm(est_t - est_j, axis=1)
    assert dpos.max() <= 1.2e-3, dpos
    # the first chunk runs frame by frame (the map is initialized on frame
    # 0 of it); in every later chunk a keyframe falls on its last frame only
    assert ts.logger.times == [j * 0.05 for j in range(N_FRAMES)]
    kf_frames = [j for j, k in enumerate(ts.logger.is_kf) if k]
    assert all(j < CHUNK or j % CHUNK == CHUNK - 1 for j in kf_frames), kf_frames
    assert any(j >= CHUNK for j in kf_frames), kf_frames
    assert ts.frame_id == js.frame_id == N_FRAMES - 1
