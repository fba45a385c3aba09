"""Parity of the port's core (lie, smallalg, camera) with the JAX package.

Both sides run float32 with the same formulas, so differences come only from
libm and operation order: 1e-5 absolute on unit-scale quantities (rotations,
bearings), 1e-3 px on pixels (values ~1e3, a few f32 ulps).
"""

import numpy as np
import jax.numpy as jnp
import pytest

from ov2slam_tpu.core import camera as jcam
from ov2slam_tpu.core import lie as jlie
from ov2slam_tpu.core import smallalg as jsa
from ov2slam_tpu_torch import interop
from ov2slam_tpu_torch.core import camera as tcam
from ov2slam_tpu_torch.core import lie as tlie
from ov2slam_tpu_torch.core import smallalg as tsa

from torch_parity import n, t

ATOL = 1e-5


def _w(rng, k, scale=1.0):
    w = rng.normal(size=(k, 3)) * scale
    nrm = np.linalg.norm(w, axis=-1, keepdims=True)
    return (w / np.maximum(1.0, nrm / 2.9)).astype(np.float32)


def _xi(rng, k):
    return np.concatenate([rng.normal(size=(k, 3)), _w(rng, k)], -1).astype(np.float32)


@pytest.mark.parametrize("fn", ["so3_exp", "so3_left_jacobian", "hat"])
def test_so3_vector_fns(fn):
    w = _w(np.random.default_rng(0), 64)
    w[0] = 0.0
    w[1] = [1e-9, -1e-9, 1e-10]
    np.testing.assert_allclose(n(getattr(tlie, fn)(t(w))),
                               n(getattr(jlie, fn)(jnp.asarray(w))), atol=ATOL)


def test_so3_log_generic_small_and_near_pi():
    rng = np.random.default_rng(1)
    w = _w(rng, 64)
    w[0] = 0.0
    w[1] = [1e-7, 0, 0]
    w[2] = [np.pi - 1e-4, 0, 0]
    w[3] = np.array([1, 1, 0]) / np.sqrt(2) * (np.pi - 1e-3)
    R = np.asarray(jlie.so3_exp(jnp.asarray(w)))
    np.testing.assert_allclose(n(tlie.so3_log(t(R))),
                               n(jlie.so3_log(jnp.asarray(R))), atol=1e-4)


def test_se3_exp_log_compose_inverse_apply_adjoint():
    rng = np.random.default_rng(2)
    xa, xb = _xi(rng, 32), _xi(rng, 32)
    pts = rng.normal(size=(32, 3)).astype(np.float32)
    JA, JB = jlie.se3_exp(jnp.asarray(xa)), jlie.se3_exp(jnp.asarray(xb))
    TA, TB = tlie.se3_exp(t(xa)), tlie.se3_exp(t(xb))
    for tv, jv in ((TA.R, JA.R), (TA.t, JA.t)):
        np.testing.assert_allclose(n(tv), n(jv), atol=ATOL)
    np.testing.assert_allclose(n(tlie.se3_log(TA)), n(jlie.se3_log(JA)), atol=1e-4)
    for tv, jv in zip(tlie.se3_compose(TA, TB), jlie.se3_compose(JA, JB)):
        np.testing.assert_allclose(n(tv), n(jv), atol=ATOL)
    for tv, jv in zip(tlie.se3_inverse(TA), jlie.se3_inverse(JA)):
        np.testing.assert_allclose(n(tv), n(jv), atol=ATOL)
    np.testing.assert_allclose(n(tlie.se3_apply(TA, t(pts))),
                               n(jlie.se3_apply(JA, jnp.asarray(pts))), atol=ATOL)
    np.testing.assert_allclose(n(tlie.se3_adjoint(TA)), n(jlie.se3_adjoint(JA)),
                               atol=ATOL)
    for tv, jv in zip(tlie.se3_boxplus_left(TA, t(xb)),
                      jlie.se3_boxplus_left(JA, jnp.asarray(xb))):
        np.testing.assert_allclose(n(tv), n(jv), atol=ATOL)
    np.testing.assert_allclose(n(TA.matrix()), n(JA.matrix()), atol=ATOL)


def test_quaternions():
    rng = np.random.default_rng(3)
    w = _w(rng, 128, scale=2.0)
    w[0] = [np.pi - 1e-3, 0, 0]           # non-w-dominant branches
    w[1] = [0, np.pi - 1e-3, 0]
    w[2] = [0, 0, np.pi - 1e-3]
    R = np.asarray(jlie.so3_exp(jnp.asarray(w)))
    q_t, q_j = n(tlie.quat_from_mat(t(R))), n(jlie.quat_from_mat(jnp.asarray(R)))
    np.testing.assert_allclose(q_t, q_j, atol=ATOL)
    np.testing.assert_allclose(n(tlie.mat_from_quat(t(q_j))),
                               n(jlie.mat_from_quat(jnp.asarray(q_j))), atol=ATOL)


def test_inv3_and_solve_spd():
    rng = np.random.default_rng(4)
    A = rng.normal(size=(64, 3, 3)).astype(np.float32) + 3 * np.eye(3, dtype=np.float32)
    np.testing.assert_allclose(n(tsa.inv3(t(A))), n(jsa.inv3(jnp.asarray(A))),
                               rtol=1e-5, atol=1e-6)
    M = rng.normal(size=(32, 6, 6)).astype(np.float32)
    H = (M @ M.transpose(0, 2, 1) + 0.5 * np.eye(6)).astype(np.float32)
    g = rng.normal(size=(32, 6)).astype(np.float32)
    x_t = n(tsa.solve_spd(t(H), t(g)))
    np.testing.assert_allclose(x_t, n(jsa.solve_spd(jnp.asarray(H), jnp.asarray(g))),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(np.einsum("nij,nj->ni", H, x_t), g, atol=1e-3)


CAMS = {
    "pinhole_radtan": ("pinhole", 458.654, 457.296, 367.215, 248.375,
                       [-0.28340811, 0.07395907, 0.00019359, 1.76187114e-05]),
    "pinhole_zero": ("pinhole", 458.0, 458.0, 376.0, 240.0, [0, 0, 0, 0]),
    "fisheye": ("fisheye", 190.98, 190.98, 254.93, 256.90,
                [0.0034823, 0.00071509, -0.0020532, 0.00020293]),
}


@pytest.mark.parametrize("name", sorted(CAMS))
def test_camera_models(name):
    model, fx, fy, cx, cy, dist = CAMS[name]
    jc = jcam.Camera.make(model, fx, fy, cx, cy, np.asarray(dist, np.float32), 752, 480)
    tc = interop.camera(jc)
    assert tc == tcam.Camera.make(model, fx, fy, cx, cy, dist, 752, 480)
    rng = np.random.default_rng(5)
    X = np.stack([rng.uniform(-2, 2, 200), rng.uniform(-1.5, 1.5, 200),
                  rng.uniform(2, 8, 200)], -1).astype(np.float32)
    px = np.stack([rng.uniform(0, 752, 200), rng.uniform(0, 480, 200)],
                  -1).astype(np.float32)
    for f in ("project_cam_to_image", "project_cam_to_image_dist"):
        np.testing.assert_allclose(n(getattr(tcam, f)(tc, t(X))),
                                   n(getattr(jcam, f)(jc, jnp.asarray(X))), atol=1e-3)
    np.testing.assert_allclose(n(tcam.undistort_px(tc, t(px))),
                               n(jcam.undistort_px(jc, jnp.asarray(px))), atol=1e-3)
    np.testing.assert_allclose(n(tcam.bearing_from_px(tc, t(px))),
                               n(jcam.bearing_from_px(jc, jnp.asarray(px))), atol=ATOL)
    np.testing.assert_array_equal(n(tcam.in_image(tc, t(px), border=9)),
                                  n(jcam.in_image(jc, jnp.asarray(px), border=9)))


def test_trajectory_logger_and_ate_match_jax(tmp_path):
    from ov2slam_tpu.io import trajectories as jtraj
    from ov2slam_tpu_torch.io import trajectories as ttraj
    rng = np.random.default_rng(6)
    R = np.asarray(jlie.so3_exp(jnp.asarray(_w(rng, 12))), np.float64)
    logs = (jtraj.TrajectoryLogger(), ttraj.TrajectoryLogger())
    for i in range(12):
        T = np.eye(4)
        T[:3, :3], T[:3, 3] = R[i], rng.normal(size=3)
        for lg in logs:
            lg.add(0.05 * i, T, i % 4 == 0, i // 4, None if i < 4 else np.eye(4))
    for k, lg in enumerate(logs):
        lg.write_tum(str(tmp_path / f"tum{k}.txt"))
        lg.write_kitti(str(tmp_path / f"kitti{k}.txt"))
        lg.write_tum(str(tmp_path / f"kf{k}.txt"), kf_only=True)
    for name in ("tum", "kitti", "kf"):
        assert (tmp_path / f"{name}0.txt").read_text() == \
            (tmp_path / f"{name}1.txt").read_text()
    est, gt = rng.normal(size=(30, 3)), rng.normal(size=(30, 3))
    for scale in (False, True):
        assert ttraj.ate_rmse(est, gt, with_scale=scale) == \
            jtraj.ate_rmse(est, gt, with_scale=scale)


@pytest.mark.parametrize("preset", ["accurate/euroc/euroc_stereo.yaml",
                                    "fast/kitti/kitti_00-02.yaml"])
def test_slam_params_parse_like_jax(preset):
    import dataclasses
    import os
    from ov2slam_tpu.config import SlamParams as JParams
    from ov2slam_tpu_torch.config import SlamParams as TParams
    path = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                        "parameters_files", preset)
    a, b = JParams.from_yaml(path), TParams.from_yaml(path)
    assert [f.name for f in dataclasses.fields(a)] == \
        [f.name for f in dataclasses.fields(b)]
    for f in dataclasses.fields(a):
        np.testing.assert_array_equal(getattr(a, f.name), getattr(b, f.name))
    assert (a.kp_cap, a.nbmaxkps, a.fepi_th) == (b.kp_cap, b.nbmaxkps, b.fepi_th)
