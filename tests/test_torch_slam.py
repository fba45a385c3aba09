"""Front-end and keyframe steps of the port against the JAX package, started
from the JAX package's own state carried across by ``interop``, plus the
settings the port refuses.

The JAX system is run over the first frames of the synthetic sequence; its
front-end state, map arenas and keyframe anchors are handed to both
packages' step functions on the next frame.

Tolerances:
* ``track_frame`` and ``kf_step`` are fed the same float32 pyramids: pose
  to 1e-4, tracked/detected pixels to 1e-3 px, masks equal up to 1% (a
  point at the edge of a gate may flip on float32 reordering). Stereo
  points to 1e-2 relative: the midpoint solve divides by
  det = 1 - cos^2(ray angle) ~ (disparity / f)^2 ~ 2e-4 on this rig, which
  amplifies float32 rounding by orders of magnitude; the two packages'
  summation orders alone moved depths by up to 0.24% from identical
  inputs, and the bound leaves a fourfold margin for other CPUs' codegen.
* ``frame_step`` builds its own pyramid, stored float16 by the JAX package
  and float32 by the port (ROADMAP R2); the ~0.06 gray-level quantization
  moves tracked points by up to ~0.05 px and the pose by under 1 mm.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from ov2slam_tpu.config import SlamParams as JParams
from ov2slam_tpu.ops import image as jim
from ov2slam_tpu.slam import frontend as jfe
from ov2slam_tpu.slam import mapper as jmapper
from ov2slam_tpu.slam.manager import SlamSystem as JSlam
from ov2slam_tpu_torch import interop
from ov2slam_tpu_torch.config import SlamParams
from ov2slam_tpu_torch.slam import frontend as tfe
from ov2slam_tpu_torch.slam import mapper as tmapper
from ov2slam_tpu_torch.slam.manager import SlamSystem

import synthetic as syn
from torch_parity import n, t


def slice_params():
    d = syn.slam_params_dict()
    d["doepipolar"] = 0
    return d


@pytest.fixture(scope="module")
def jax_run():
    """JAX system after frame 0 (first keyframe) and frame 1 (tracking)."""
    fl, fr, gt = syn.render_sequence(n_frames=3, step=0.05)
    js = JSlam(JParams.from_dict(slice_params()))
    js.process_stereo(fl[0], fr[0], 0.0)
    # carried across before the next step, which donates the JAX state
    state0 = interop.fe_state(js.fe_state)
    lm0 = [np.asarray(a) for a in js.map.device_landmarks()]
    js.process_stereo(fl[1], fr[1], 0.05)
    return dict(js=js, fl=fl, fr=fr, state0_torch=state0, lm0=lm0)


def _pyr(img):
    return tuple(np.asarray(a) for a in jim.build_pyramid(jnp.asarray(img), 3))


def test_track_frame_matches_jax(jax_run):
    js, fl = jax_run["js"], jax_run["fl"]
    st = jax_run["state0_torch"]            # state after frame 0, as torch
    p0, p1 = _pyr(fl[0]), _pyr(fl[1])
    lm_pos, lm_is3d = jax_run["lm0"]
    R, tt = n(st.R_cw), n(st.t_cw)
    kps_np = {k: n(getattr(st.kps, k)) for k in st.kps._fields}
    kps_j = jfe.FrameKps(**{k: jnp.asarray(v.astype(np.int32) if k == "lmid" else v)
                            for k, v in kps_np.items()})
    rj = jfe.track_frame(
        tuple(map(jnp.asarray, p0)), tuple(map(jnp.asarray, p1)), kps_j,
        jnp.asarray(lm_pos), jnp.asarray(lm_is3d), js.cam_l, jnp.asarray(R),
        jnp.asarray(tt), jnp.asarray(R), jnp.asarray(tt),
        jnp.zeros(2, jnp.uint32), do_epipolar=False)
    rt = tfe.track_frame(
        tuple(map(t, p0)), tuple(map(t, p1)), st.kps, t(lm_pos), t(lm_is3d),
        interop.camera(js.cam_l), st.R_cw, st.t_cw, st.R_cw, st.t_cw)
    assert bool(rt.pose_ok) and bool(rj.pose_ok)
    np.testing.assert_allclose(n(rt.T_cw_R), n(rj.T_cw_R), atol=1e-4)
    np.testing.assert_allclose(n(rt.T_cw_t), n(rj.T_cw_t), atol=1e-4)
    vj, vt = n(rj.kps.valid), n(rt.kps.valid)
    assert vj.sum() > 100 and (vj == vt).mean() >= 0.99
    both = vj & vt
    np.testing.assert_allclose(n(rt.kps.px)[both], n(rj.kps.px)[both], atol=1e-3)
    assert abs(int(rt.n_inliers) - int(rj.n_inliers)) <= 2
    np.testing.assert_allclose(float(rt.parallax_med), float(rj.parallax_med),
                               atol=1e-2)


def test_frame_step_from_jax_state(jax_run):
    """Frame 1 from the JAX state after frame 0: both packages' full step."""
    js, fl = jax_run["js"], jax_run["fl"]
    st = jax_run["state0_torch"]
    # the JAX run already stepped frame 1 from the same state: replay it on
    # a fresh JAX system to read its stats vector
    js2 = JSlam(JParams.from_dict(slice_params()))
    js2.process_stereo(fl[0], jax_run["fr"][0], 0.0)
    lm_pos, lm_is3d = js2.map.device_landmarks()
    p = js2.params
    _, stats_j = jfe.frame_step(
        js2.fe_state, jnp.asarray(fl[1].astype(np.uint8)), lm_pos, lm_is3d,
        js2.cam_l, levels=p.nklt_pyr_lvl, use_clahe=False,
        clahe_clip=p.fclahe_val, nklt_win=p.nklt_win_size,
        nmax_iter=p.nmax_iter, fmax_px_precision=p.fmax_px_precision,
        fmax_fbklt_dist=p.fmax_fbklt_dist, klt_err=p.nklt_err,
        do_epipolar=False, fransac_err=p.fransac_err,
        robust_th2=p.robust_mono_th, n_ransac_hyps=jfe.ransac_hyps_of(p))
    new_t, stats_t = tfe.frame_step(
        st, t(fl[1].astype(np.uint8)), *interop.landmarks(*jax_run["lm0"]),
        interop.camera(js.cam_l), levels=3, nklt_win=9, nmax_iter=30)
    sj, s_t = np.asarray(stats_j), n(stats_t)
    assert sj[0] == s_t[0] == 1.0
    assert abs(sj[1] - s_t[1]) <= 4 and abs(sj[2] - s_t[2]) <= 4
    np.testing.assert_allclose(s_t[5:8], sj[5:8], atol=1e-3)      # position
    np.testing.assert_allclose(s_t[8:12], sj[8:12], atol=1e-4)    # rotation
    # the port's state advanced: velocity set, input state left untouched
    assert bool(new_t.has_vel) and not bool(st.has_vel)
    assert new_t.pyr[0].dtype == st.pyr[0].dtype


def test_kf_step_from_jax_state(jax_run):
    """A keyframe on frame 1 from the JAX state after tracking it."""
    js, fl, fr = jax_run["js"], jax_run["fl"], jax_run["fr"]
    p = js.params
    kps_np = {k: np.asarray(getattr(js.fe_state.kps, k))
              for k in js.fe_state.kps._fields}
    anc = js._assemble_anchor_data(js.cur_kfid)
    n_cells = (480 // p.nmaxdist) * (752 // p.nmaxdist)
    cand = (np.arange(n_cells) + 4000).astype(np.int32)
    lm_pos, lm_is3d = [np.asarray(a) for a in js.map.device_landmarks()]
    pl, pr = _pyr(fl[1]), _pyr(fr[1])
    T = js.T_cw
    qual, depth = np.float32(js.detector_quality), np.float32(js.median_depth)
    kw = dict(cellsize=p.nmaxdist, nlevels=3, win=9, max_iters=30,
              fb_dist=p.fmax_fbklt_dist, klt_err=p.nklt_err,
              epi_th_px=p.fepi_th, use_sad_prior=True)
    rt = tmapper.kf_step(
        tuple(map(t, pl)), tuple(map(t, pr)),
        interop.frame_kps(jfe.FrameKps(**kps_np)), t(lm_pos), t(lm_is3d),
        interop.camera(js.cam_l), interop.camera(js.cam_r), t(T[:3, :3]),
        t(T[:3, 3]), t(js.T_rl.R), t(js.T_rl.t), float(qual), t(cand),
        float(depth), t(anc[0]), t(anc[1]), t(anc[2]), t(anc[3]), t(anc[4]),
        **kw)
    rj = jmapper.kf_step(
        tuple(map(jnp.asarray, pl)), tuple(map(jnp.asarray, pr)),
        jfe.FrameKps(**{k: jnp.asarray(v) for k, v in kps_np.items()}),
        jnp.asarray(lm_pos), jnp.asarray(lm_is3d), js.cam_l, js.cam_r,
        jnp.asarray(T[:3, :3]), jnp.asarray(T[:3, 3]), js.T_rl.R, js.T_rl.t,
        jnp.asarray(qual), jnp.asarray(cand), jnp.asarray(depth),
        *(jnp.asarray(a) for a in anc[:5]), detector="singlescale", stereo=True,
        **kw)
    for name in ("valid", "lmid", "px"):
        np.testing.assert_array_equal(n(getattr(rt.kps, name)),
                                      np.asarray(getattr(rj.kps, name)))
    ok = np.asarray(rj.desc_ok)
    np.testing.assert_array_equal(n(rt.desc_ok), ok)
    np.testing.assert_array_equal(n(rt.desc)[ok], np.asarray(rj.desc)[ok].astype(np.int64))
    hj, ht = np.asarray(rj.kps.has_right), n(rt.kps.has_right)
    assert hj.sum() > 50 and (hj == ht).mean() >= 0.99
    both = hj & ht
    np.testing.assert_allclose(n(rt.kps.rpx)[both], np.asarray(rj.kps.rpx)[both],
                               atol=1e-3)
    tj, tt_ = np.asarray(rj.tri_ok), n(rt.tri_ok)
    assert (tj == tt_).mean() >= 0.99
    both = tj & tt_
    np.testing.assert_allclose(n(rt.tri_Xw)[both], np.asarray(rj.tri_Xw)[both],
                               rtol=1e-2, atol=1e-3)
    np.testing.assert_allclose(float(rt.med_depth), float(rj.med_depth), rtol=1e-2)
    assert (n(rt.kps.is3d) == np.asarray(rj.kps.is3d)).mean() >= 0.99
    assert (n(rt.tt_ok) == np.asarray(rj.tt_ok)).mean() >= 0.99


def test_sad_line_prior_matches_jax(jax_run):
    fl, fr = jax_run["fl"], jax_run["fr"]
    rng = np.random.default_rng(0)
    px = np.stack([rng.uniform(0, 752, 80), rng.uniform(0, 480, 80)],
                  -1).astype(np.float32)
    xj, sj = jmapper.sad_line_prior(jnp.asarray(fl[0]), jnp.asarray(fr[0]),
                                    jnp.asarray(px))
    xt, s_t = tmapper.sad_line_prior(t(fl[0]), t(fr[0]), t(px))
    np.testing.assert_array_equal(n(xt), np.asarray(xj))
    np.testing.assert_allclose(n(s_t), np.asarray(sj), rtol=1e-5, atol=1e-4)


UNSUPPORTED = {
    "mono": {"mono": 1, "stereo": 0},
    "use_clahe": {"use_clahe": 1},
    "doepipolar": {"doepipolar": 1},
    "dop3p": {"dop3p": 1},
    "btrack_keyframetoframe": {"btrack_keyframetoframe": 1},
    "force_realtime": {"force_realtime": 1},
    "async_ba": {"async_ba": 1},
    "buse_loop_closer": {"buse_loop_closer": 1},
    "bdo_stereo_rect": {"bdo_stereo_rect": 1, "Camera.k1l": -0.28},
    "bdo_undist": {"bdo_undist": 1, "Camera.k1l": -0.28},
    "use_fast": {"use_fast": 1},
    "use_shi_tomasi": {"use_shi_tomasi": 1},
    "use_dogleg": {"use_dogleg": 1},
    "n_devices": {"n_devices": 4},
    "do_full_ba": {"do_full_ba": 1},
}


@pytest.mark.parametrize("name", sorted(UNSUPPORTED))
def test_settings_outside_the_slice_raise(name):
    d = slice_params()
    d.update(UNSUPPORTED[name])
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        SlamSystem(SlamParams.from_dict(d), device="cpu")


def test_slice_settings_accepted():
    s = SlamSystem(SlamParams.from_dict(slice_params()), device="cpu")
    assert s.kp_cap == 192 and s._rows_aligned
    # born-rectified input with a distorted camera is still the slice
    d = slice_params()
    d["Camera.k1l"] = -0.28
    SlamSystem(SlamParams.from_dict(d), device="cpu")
