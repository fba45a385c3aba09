"""Residual factors, PnP and bundle adjustment: the port against autodiff
(torch.func.jacrev) and against the JAX package on the same inputs.

Tolerances: analytic vs autodiff Jacobians as test_opt.py (2e-2 abs /
1e-3 rel — pixel Jacobians reach ~1e2 and f32 autodiff reorders products);
analytic Jacobians and residuals against JAX to 1e-4 relative (same
formulas, float32). PnP and BA run iterative LM in float32 in another
summation order: BA poses to 1e-4 (rad / m) and landmarks to 1e-3 m; PnP
rotations to 1e-4 and translations to 5e-4 m (measured up to 8.5e-5 m: its
normal equations sum 120 observations in float32); inlier masks equal.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from ov2slam_tpu.core import lie as jlie
from ov2slam_tpu.opt import ba as jba
from ov2slam_tpu.opt import pnp as jpnp
from ov2slam_tpu.opt import residuals as jres
from ov2slam_tpu_torch import interop
from ov2slam_tpu_torch.core import lie as tlie
from ov2slam_tpu_torch.opt import ba as tba
from ov2slam_tpu_torch.opt import pnp as tpnp
from ov2slam_tpu_torch.opt import residuals as tres

from test_opt import CAL, cam_scene, make_ba_problem, rnd_pose
from torch_parity import n, t

TCAL = interop.calib(CAL)


def _scene(seed, k=16):
    rng = np.random.default_rng(seed)
    T = rnd_pose(rng)
    Xc = cam_scene(rng, k)
    Xw = np.asarray(jlie.se3_apply(jlie.se3_inverse(T), jnp.asarray(Xc)))
    obs = (np.asarray(jres.project(CAL, jnp.asarray(Xc)))
           + rng.normal(0, 2, (k, 2))).astype(np.float32)
    return rng, T, interop.se3(T), Xw, obs


def _jac_pose(f, T):
    """d f(exp(xi) T) / d xi at 0 for f returning (k, 2)."""
    return torch.func.jacrev(lambda xi: f(tlie.se3_boxplus_left(T, xi)))(
        torch.zeros(6))


def test_reproj_se3_jacobian_vs_autodiff_and_jax():
    _, Tj, Tt, Xw, obs = _scene(0)
    r, J, pos = tres.reproj_se3(TCAL, Tt, t(Xw), t(obs))
    J_auto = _jac_pose(lambda T: tres.reproj_se3(TCAL, T, t(Xw), t(obs))[0], Tt)
    np.testing.assert_allclose(n(J), n(J_auto), atol=2e-2, rtol=1e-3)
    rj, Jj, posj = jres.reproj_se3(CAL, Tj, jnp.asarray(Xw), jnp.asarray(obs))
    np.testing.assert_allclose(n(r), n(rj), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(n(J), n(Jj), rtol=1e-4, atol=1e-3)
    np.testing.assert_array_equal(n(pos), n(posj))


def test_reproj_xyz_and_right_jacobians():
    rng, Tj, Tt, Xw, obs = _scene(1, 8)
    T_rl_j = jlie.SE3(jlie.so3_exp(jnp.asarray([0.01, -0.005, 0.002], jnp.float32)),
                      jnp.asarray([-0.11, 0.0, 0.0], jnp.float32))
    T_rl = interop.se3(T_rl_j)
    X = t(Xw)
    _, Jp, Jx, _ = tres.reproj_xyz(TCAL, Tt, X, t(obs))
    Jx_auto = torch.func.jacrev(lambda Y: tres.reproj_xyz(TCAL, Tt, Y, t(obs))[0])(X)
    np.testing.assert_allclose(n(Jx), n(Jx_auto)[np.arange(8), :, np.arange(8), :],
                               atol=2e-2, rtol=1e-3)
    rr, Jpr, Jxr, _ = tres.reproj_xyz_right(TCAL, T_rl, Tt, X, t(obs))
    J_auto = _jac_pose(lambda T: tres.reproj_xyz_right(TCAL, T_rl, T, X, t(obs))[0], Tt)
    np.testing.assert_allclose(n(Jpr), n(J_auto), atol=2e-2, rtol=1e-3)
    outj = jres.reproj_xyz_right(CAL, T_rl_j, Tj, jnp.asarray(Xw), jnp.asarray(obs))
    for a, b in zip((rr, Jpr, Jxr), outj[:3]):
        np.testing.assert_allclose(n(a), n(b), rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("right", [False, True])
def test_anch_invdepth_jacobians(right):
    rng = np.random.default_rng(3)
    T_anchor, T_obs = rnd_pose(rng), rnd_pose(rng)
    Xa = cam_scene(rng, 6)
    lam = (1.0 / Xa[:, 2]).astype(np.float32)
    b_a = (Xa / Xa[:, 2:]).astype(np.float32)
    T_wa = jlie.se3_inverse(T_anchor)
    obs = np.zeros((6, 2), np.float32)
    T_rl_j = (jlie.SE3(jnp.eye(3), jnp.asarray([-0.11, 0.0, 0.0], jnp.float32))
              if right else None)
    T_rl = interop.se3(T_rl_j) if right else None
    tw, to = interop.se3(T_wa), interop.se3(T_obs)
    out = tres.reproj_anch_invdepth(TCAL, tw, to, t(b_a), t(lam), t(obs), T_rl)
    Jl_auto = torch.func.jacrev(lambda l: tres.reproj_anch_invdepth(
        TCAL, tw, to, t(b_a), l, t(obs), T_rl)[0])(t(lam))
    np.testing.assert_allclose(n(out[3])[..., 0],
                               n(Jl_auto)[np.arange(6), :, np.arange(6)],
                               atol=2e-2, rtol=1e-3)
    Jo_auto = _jac_pose(lambda T: tres.reproj_anch_invdepth(
        TCAL, tw, T, t(b_a), t(lam), t(obs), T_rl)[0], to)
    np.testing.assert_allclose(n(out[1]), n(Jo_auto), atol=2e-2, rtol=1e-3)
    outj = jres.reproj_anch_invdepth(CAL, T_wa, T_obs, jnp.asarray(b_a),
                                     jnp.asarray(lam), jnp.asarray(obs), T_rl_j)
    for a, b in zip(out[:4], outj[:4]):
        np.testing.assert_allclose(n(a), n(b), rtol=1e-4, atol=1e-3)


def test_huber_weight():
    chi2 = np.linspace(0, 40, 101).astype(np.float32)
    np.testing.assert_allclose(n(tres.huber_weight(t(chi2), 5.9915)),
                               n(jres.huber_weight(jnp.asarray(chi2), 5.9915)),
                               atol=1e-6)


def _pnp_case(seed):
    rng = np.random.default_rng(seed)
    T_gt = rnd_pose(rng, wscale=0.8)
    Xc = cam_scene(rng, 120)
    Xw = np.asarray(jlie.se3_apply(jlie.se3_inverse(T_gt), jnp.asarray(Xc)))
    obs = np.array(jres.project(CAL, jnp.asarray(Xc)))
    obs += rng.normal(0, 0.4, obs.shape)
    out = rng.choice(120, 25, replace=False)
    obs[out] += rng.uniform(15, 60, (25, 2)) * np.sign(rng.normal(size=(25, 2)))
    T0 = jlie.se3_boxplus_left(T_gt, jnp.asarray(
        (rng.normal(size=6) * np.array([0.05] * 3 + [0.02] * 3)).astype(np.float32)))
    valid = rng.uniform(size=120) > 0.1
    return T_gt, T0, Xw.astype(np.float32), obs.astype(np.float32), valid


@pytest.mark.parametrize("seed", [5, 6])
def test_pnp_robust_then_l2_matches_jax(seed):
    T_gt, T0, Xw, obs, valid = _pnp_case(seed)
    rj = jpnp.pnp_robust_then_l2(CAL, T0, jnp.asarray(Xw), jnp.asarray(obs),
                                 jnp.asarray(valid))
    rt = tpnp.pnp_robust_then_l2(TCAL, interop.se3(T0), t(Xw), t(obs), t(valid))
    np.testing.assert_allclose(n(rt.T_cw.R), n(rj.T_cw.R), atol=1e-4)
    np.testing.assert_allclose(n(rt.T_cw.t), n(rj.T_cw.t), atol=5e-4)
    np.testing.assert_array_equal(n(rt.inliers), n(rj.inliers))
    assert int(rt.n_inliers) == int(rj.n_inliers)
    np.testing.assert_allclose(float(rt.cost), float(rj.cost), rtol=1e-3)
    dt = np.linalg.norm(n(rt.T_cw.t) - np.asarray(T_gt.t))
    assert dt < 1e-2
    # the robust stage alone (pnp_lm), from the same start
    lj = jpnp.pnp_lm(CAL, T0, jnp.asarray(Xw), jnp.asarray(obs), jnp.asarray(valid))
    lt = tpnp.pnp_lm(TCAL, interop.se3(T0), t(Xw), t(obs), t(valid))
    np.testing.assert_allclose(n(lt.T_cw.t), n(lj.T_cw.t), atol=5e-4)
    np.testing.assert_array_equal(n(lt.inliers), n(lj.inliers))


@pytest.mark.parametrize("invdepth,seed", [(True, 7), (False, 8)])
def test_solve_ba_matches_jax(invdepth, seed):
    prob, poses_gt, Xw_gt, n_kf, n_lm = make_ba_problem(
        np.random.default_rng(seed), invdepth=invdepth)
    kw = dict(invdepth=invdepth, max_iters=5, robust=True,
              th2_mono=5.9915, th2_stereo=7.8147, l2_refine=True)
    oj = jba.solve_ba(prob, **kw)
    ot = tba.solve_ba(interop.ba_problem(prob), **kw)
    np.testing.assert_allclose(n(ot.R), n(oj.R), atol=1e-4)
    np.testing.assert_allclose(n(ot.t), n(oj.t), atol=1e-4)
    np.testing.assert_allclose(n(ot.Xw)[:n_lm], n(oj.Xw)[:n_lm], atol=1e-3)
    np.testing.assert_array_equal(n(ot.obs_inlier), n(oj.obs_inlier))
    assert ot.n_iters == int(oj.n_iters)
    np.testing.assert_allclose(float(ot.cost0), float(oj.cost0), rtol=1e-4)
    np.testing.assert_allclose(float(ot.cost), float(oj.cost), rtol=1e-2,
                               atol=1e-3 * float(oj.cost0))
    assert float(ot.cost) < 0.1 * float(ot.cost0)
