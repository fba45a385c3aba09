"""Stereo rectification, the undistortion and rectification grids, the
bilinear and bicubic remaps and the rectified ROI, against the JAX package,
on the EuRoC preset's calibration (rotated extrinsic, radial-tangential
distortion).

Tolerances: rotations and intrinsics to 1e-5 (both packages run the same
float64 host math from float32 inputs), grids to 1e-3 px (float32, summed
in another order), remaps to 1e-3 gray levels, the ROI exactly.
"""

import os

import numpy as np
import jax.numpy as jnp
import pytest

from ov2slam_tpu.config import SlamParams as JParams
from ov2slam_tpu.core import camera as jcam
from ov2slam_tpu.core.lie import SE3 as JSE3
from ov2slam_tpu.ops import image as jim
from ov2slam_tpu.slam import manager as jmanager
from ov2slam_tpu.slam.manager import SlamSystem as JSlam
from ov2slam_tpu_torch import interop
from ov2slam_tpu_torch.config import SlamParams
from ov2slam_tpu_torch.core import camera as tcam
from ov2slam_tpu_torch.ops import image as tim
from ov2slam_tpu_torch.slam.manager import SlamSystem

from torch_parity import n, t

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EUROC = os.path.join(ROOT, "parameters_files", "accurate", "euroc",
                     "euroc_stereo.yaml")


@pytest.fixture(scope="module")
def rig():
    p = JParams.from_yaml(EUROC)
    cam_l = jcam.Camera.make(p.cam_left_model, p.fxl, p.fyl, p.cxl, p.cyl,
                             np.array([p.k1l, p.k2l, p.p1l, p.p2l], np.float32),
                             p.img_left_w, p.img_left_h)
    cam_r = jcam.Camera.make(p.cam_right_model, p.fxr, p.fyr, p.cxr, p.cyr,
                             np.array([p.k1r, p.k2r, p.p1r, p.p2r], np.float32),
                             p.img_right_w, p.img_right_h)
    T_lr = np.asarray(p.T_left_right, np.float32)
    R_rl = T_lr[:3, :3].T
    t_rl = -(R_rl @ T_lr[:3, 3])
    rj = jcam.stereo_rectify(cam_l, cam_r, JSE3(jnp.asarray(R_rl),
                                                jnp.asarray(t_rl)))
    rt = tcam.stereo_rectify(interop.camera(cam_l), interop.camera(cam_r),
                             R_rl, t_rl)
    return dict(cam_l=cam_l, cam_r=cam_r, rj=rj, rt=rt, R_rl=R_rl, t_rl=t_rl)


def test_stereo_rectify_matches_jax(rig):
    (R1j, R2j, Kj, fbj), (R1t, R2t, Kt, fbt) = rig["rj"], rig["rt"]
    for a, b in ((R1t, R1j), (R2t, R2j), (Kt, Kj)):
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=1e-7)
    assert abs(fbt - fbj) <= 1e-5 * abs(fbj)
    # rectified, the extrinsic is a pure x-baseline: the rectified
    # right-from-left rotation is the identity, the translation along x
    R_rect = R2t @ rig["R_rl"].astype(np.float64) @ R1t.T
    t_rect = R2t @ rig["t_rl"].astype(np.float64)
    assert np.abs(R_rect - np.eye(3)).max() < 1e-6
    assert np.abs(t_rect[1:]).max() < 1e-6 * np.abs(t_rect[0])


@pytest.mark.parametrize("which", ["rect_left", "rect_right", "undist"])
def test_grids_and_roi_match_jax(rig, which):
    R1, R2, K_new, _ = rig["rj"]
    if which == "undist":
        cam, kw_j, kw_t = rig["cam_l"], {}, {}
    else:
        cam = rig["cam_l"] if which == "rect_left" else rig["cam_r"]
        R = R1 if which == "rect_left" else R2
        kw_j = dict(R_rect=R, K_new=jnp.asarray(K_new, jnp.float32))
        kw_t = dict(R_rect=R, K_new=K_new)
    gj = np.asarray(jcam.compute_undist_rect_map(cam, **kw_j))
    gt = n(tcam.compute_undist_rect_map(interop.camera(cam), **kw_t))
    assert gt.shape == gj.shape == (480, 752, 2)
    np.testing.assert_allclose(gt, gj, atol=1e-3, rtol=0)
    cj = jmanager._with_rect_roi(cam, gj)
    ct = tcam.with_rect_roi(interop.camera(cam), gt)
    assert ((ct.roi_x0, ct.roi_y0, ct.roi_x1, ct.roi_y1)
            == tuple(float(v) for v in (cj.roi_x0, cj.roi_y0, cj.roi_x1, cj.roi_y1)))
    assert ct.roi_x1 - ct.roi_x0 > 500 and ct.roi_y1 - ct.roi_y0 > 300


@pytest.mark.parametrize("kind", ["bicubic", "bilinear"])
def test_remaps_match_jax(rig, kind):
    R1, _, K_new, _ = rig["rj"]
    grid = np.asarray(jcam.compute_undist_rect_map(
        rig["cam_l"], R_rect=R1, K_new=jnp.asarray(K_new, jnp.float32)))
    rng = np.random.default_rng(4)
    img = np.clip(rng.normal(128, 60, (480, 752)), 0, 255).astype(np.float32)
    fj = jim.remap_bicubic if kind == "bicubic" else jim.remap_bilinear
    ft = tim.remap_bicubic if kind == "bicubic" else tim.remap_bilinear
    oj = np.asarray(fj(jnp.asarray(img), jnp.asarray(grid)))
    ot = n(ft(t(img), t(grid)))
    np.testing.assert_allclose(ot, oj, atol=1e-3, rtol=0)
    # bicubic overshoots [0, 255]: both systems saturate it to uint8 alike
    np.testing.assert_array_equal(
        n(SlamSystem(SlamParams.from_yaml(EUROC).replace(buse_loop_closer=False),
                     device="cpu")._to_device_u8(t(ot))),
        np.asarray(jnp.asarray(oj).astype(jnp.uint8)))


@pytest.mark.parametrize("setting", ["bdo_stereo_rect", "bdo_undist"])
def test_system_setup_matches_jax(setting):
    """The systems' working cameras, extrinsic and row alignment after
    setup, on the JAX package's conditions."""
    d = {setting: 1, "buse_loop_closer": 0}
    pj = JParams.from_dict({**_preset_dict(), **d})
    pt = SlamParams.from_dict({**_preset_dict(), **d})
    js, ts = JSlam(pj), SlamSystem(pt, device="cpu")
    for cj, ct in ((js.cam_l, ts.cam_l), (js.cam_r, ts.cam_r)):
        for f in ("fx", "fy", "cx", "cy", "roi_x0", "roi_y0", "roi_x1", "roi_y1"):
            assert abs(getattr(ct, f) - float(getattr(cj, f))) <= 1e-4, f
        np.testing.assert_array_equal(np.asarray(ct.dist), np.asarray(cj.dist))
    np.testing.assert_allclose(n(ts.T_rl.R), np.asarray(js.T_rl.R), atol=1e-6)
    np.testing.assert_allclose(n(ts.T_rl.t), np.asarray(js.T_rl.t), atol=1e-6)
    assert ts._rows_aligned == js._rows_aligned
    assert len(ts.rect_maps) == len(js.rect_maps) == 2
    for gt, gj in zip(ts.rect_maps, js.rect_maps):
        np.testing.assert_allclose(n(gt), np.asarray(gj), atol=1e-3, rtol=0)


def _preset_dict():
    from ov2slam_tpu_torch.config import load_opencv_yaml
    return load_opencv_yaml(EUROC)


def test_rectification_conditions_follow_jax():
    """bdo_stereo_rect applies only in stereo and only with k1/k2 or an
    extrinsic rotation (p1/p2 alone do not rectify); bdo_undist on any of
    the eight coefficients; _rows_aligned = rectified or (pure baseline and
    zero k1/k2)."""
    import synthetic as syn
    base = syn.slam_params_dict()
    cases = [
        ({"bdo_stereo_rect": 1}, False, True),
        ({"bdo_stereo_rect": 1, "Camera.p1l": 1e-3}, False, True),
        ({"bdo_stereo_rect": 1, "Camera.k1l": -0.2}, True, True),
        ({"bdo_stereo_rect": 1, "Camera.k1l": -0.2, "mono": 1, "stereo": 0},
         False, False),
        ({"bdo_undist": 1, "Camera.p2r": 1e-3}, True, True),
        ({"Camera.k1l": -0.2}, False, False),
    ]
    for extra, remapped, aligned in cases:
        d = {**base, **extra}
        js = JSlam(JParams.from_dict(d))
        ts = SlamSystem(SlamParams.from_dict(d), device="cpu")
        assert (ts.rect_maps is not None) == (js.rect_maps is not None) == remapped, extra
        assert ts._rows_aligned == js._rows_aligned == aligned, extra
