"""FAST-9 scores, cornerSubPix and the keyframe step with the FAST and GFTT
detectors, against the JAX package.

Tolerances: ``fast_score`` to 1e-4 (the same float32 differences and
minima; measured exact), ``corner_subpix`` to 1e-3 px (30 float32
Gauss-Newton steps over bilinear samples, summed in another order).
``kf_step`` is fed the same float32 pyramids from a JAX state: FAST grid
picks must be identical (the scores are), GFTT picks to 1e-3 px after
cornerSubPix.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from ov2slam_tpu.config import SlamParams as JParams
from ov2slam_tpu.ops import detect as jdet
from ov2slam_tpu.ops import image as jim
from ov2slam_tpu.slam import frontend as jfe
from ov2slam_tpu.slam import mapper as jmapper
from ov2slam_tpu.slam.manager import SlamSystem as JSlam
from ov2slam_tpu_torch import interop
from ov2slam_tpu_torch.ops import detect as tdet
from ov2slam_tpu_torch.slam import mapper as tmapper

import synthetic as syn
from torch_parity import n, t


@pytest.fixture(scope="module")
def frames():
    return syn.render_sequence(n_frames=2, step=0.05)


def _crop(img):
    return np.ascontiguousarray(img[100:260, 200:420]).astype(np.float32)


@pytest.mark.parametrize("threshold", [10.0, 25.0])
def test_fast_score_matches_jax(frames, threshold):
    rng = np.random.default_rng(0)
    img = _crop(frames[0][0]) + rng.normal(0, 4, (160, 220)).astype(np.float32)
    sj = np.asarray(jdet.fast_score(jnp.asarray(img), threshold))
    st = n(tdet.fast_score(t(img), threshold))
    assert (sj > 0).sum() > 50
    np.testing.assert_allclose(st, sj, atol=1e-4, rtol=0)


def test_corner_subpix_matches_jax(frames):
    img = _crop(frames[0][0])
    resp = jdet.min_eig_response(jnp.asarray(img))
    det = jdet.grid_select(resp, jnp.zeros((4, 2)), jnp.zeros(4, bool), 20,
                           jnp.asarray(np.float32(1e-4)))
    pts, valid = np.asarray(det.points), np.array(det.valid)
    valid[::7] = False            # frozen points stay in place
    qj = np.asarray(jdet.corner_subpix(jnp.asarray(img), jnp.asarray(pts),
                                       jnp.asarray(valid)))
    qt = n(tdet.corner_subpix(t(img), t(pts), t(valid)))
    assert valid.sum() > 30
    np.testing.assert_allclose(qt, qj, atol=1e-3, rtol=0)
    np.testing.assert_array_equal(qt[~valid], pts[~valid])
    assert np.abs(qt - pts)[valid].max() > 0.05        # the steps moved


@pytest.mark.parametrize("detector,quality", [("singlescale", 1e-3),
                                               ("fast", 10.0)])
def test_detect_keypoints_matches_jax(frames, detector, quality):
    """Grid detection masked by existing keypoints, both response maps."""
    img = np.ascontiguousarray(frames[0][0], np.float32)
    rng = np.random.default_rng(2)
    px = np.stack([rng.uniform(0, 752, 64), rng.uniform(0, 480, 64)],
                  -1).astype(np.float32)
    valid = rng.uniform(size=64) < 0.7
    kj = jfe.FrameKps.empty(64)._replace(px=jnp.asarray(px),
                                          valid=jnp.asarray(valid))
    dj = jmapper.detect_keypoints(jnp.asarray(img), kj, 45,
                                  jnp.asarray(np.float32(quality)),
                                  detector=detector, fast_th=10)
    dt = tmapper.detect_keypoints(t(img), interop.frame_kps(kj), 45,
                                  float(np.float32(quality)),
                                  detector=detector, fast_th=10)
    vj = np.asarray(dj.valid)
    assert vj.sum() > 30 and (~vj).sum() > 10
    np.testing.assert_array_equal(n(dt.valid), vj)
    np.testing.assert_array_equal(n(dt.points)[vj], np.asarray(dj.points)[vj])
    np.testing.assert_array_equal(n(dt.valid2), np.asarray(dj.valid2))


@pytest.fixture(scope="module")
def jax_state(frames):
    """The JAX system after its first keyframe (frame 0) and tracking
    frame 1."""
    fl, fr, _ = syn.render_sequence(n_frames=2, step=0.05)
    d = syn.slam_params_dict()
    d["doepipolar"] = 0
    js = JSlam(JParams.from_dict(d))
    js.process_stereo(fl[0], fr[0], 0.0)
    js.process_stereo(fl[1], fr[1], 0.05)
    return js, fl, fr


@pytest.mark.parametrize("detector", ["fast", "gftt"])
def test_kf_step_detectors_match_jax(jax_state, detector):
    js, fl, fr = jax_state
    p = js.params
    kps_np = {k: np.asarray(getattr(js.fe_state.kps, k))
              for k in js.fe_state.kps._fields}
    anc = js._assemble_anchor_data(js.cur_kfid)
    n_cells = (480 // p.nmaxdist) * (752 // p.nmaxdist)
    cand = (np.arange(n_cells) + 4000).astype(np.int32)
    lm_pos, lm_is3d = [np.asarray(a) for a in js.map.device_landmarks()]
    pl = tuple(np.asarray(a) for a in jim.build_pyramid(jnp.asarray(fl[1]), 3))
    pr = tuple(np.asarray(a) for a in jim.build_pyramid(jnp.asarray(fr[1]), 3))
    T = js.T_cw
    qual = np.float32(10.0 if detector == "fast" else js.detector_quality)
    depth = np.float32(js.median_depth)
    kw = dict(cellsize=p.nmaxdist, detector=detector, fast_th=10, nlevels=3,
              win=9, max_iters=30, fb_dist=p.fmax_fbklt_dist,
              klt_err=p.nklt_err, epi_th_px=p.fepi_th, use_sad_prior=True)
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
        *(jnp.asarray(a) for a in anc[:5]), stereo=True, **kw)
    vj = np.asarray(rj.kps.valid)
    np.testing.assert_array_equal(n(rt.kps.valid), vj)
    np.testing.assert_array_equal(n(rt.kps.lmid), np.asarray(rj.kps.lmid))
    new = vj & ~kps_np["valid"]
    assert new.sum() > 20, new.sum()
    if detector == "fast":
        np.testing.assert_array_equal(n(rt.kps.px), np.asarray(rj.kps.px))
    else:
        np.testing.assert_allclose(n(rt.kps.px)[vj], np.asarray(rj.kps.px)[vj],
                                   atol=1e-3, rtol=0)
        # cornerSubPix moved the new corners off the pixel grid
        assert np.abs(np.asarray(rj.kps.px)[new] % 1.0).max() > 0.01
    hj, ht = np.asarray(rj.kps.has_right), n(rt.kps.has_right)
    assert hj.sum() > 50 and (hj == ht).mean() >= 0.99
