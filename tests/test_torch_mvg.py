"""Parity of the port's multi-view geometry (``ops/mvg.py``: Sampson
distance, F from poses, 8-point, essential decomposition and Gauss-Newton
polish, the Ferrari quartic, Grunert P3P, pose GN and the P3P RANSAC) with
the JAX package, on the scenes of ``tests/test_mvg.py``.

Tolerances: elementwise float32 functions (Sampson, F) to 1e-5 relative;
the quartic's roots to 1e-3 of max(1, |root|) (both run complex64
Ferrari plus three Newton steps in another operation order);
``decompose_essential`` of the same E picks the same branch, rotation to
1e-5; the GN polishes (``refine_essential_pose``, 8 Sampson steps;
``refine_pose_gn``, 8 reprojection steps) to 1e-4 rad / 1e-4 (the
essential pose's translation direction on noisy data to 5e-3 rad, see
``test_refine_essential_pose``). P3P candidates are compared as sets:
``p3p_grunert`` validity equal on 98% of the 8 slots per sample and 95%
of either package's valid candidates (measured 97.7%; the rest sit at a
validity gate that flips) within 1e-2 of a valid candidate of the other (the Procrustes eigensolver's float32 floor, see
``test_torch_smallalg.py``, scaled by the scene's 6-9 m depth). The P3P
RANSAC gets the sample indices JAX draws exactly as ``mvg.py:612`` does:
inliers equal on 99% of points, pose to 1e-4 rad / 1e-3 m.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from ov2slam_tpu.core import lie as jlie
from ov2slam_tpu.ops import mvg as jmvg
from ov2slam_tpu_torch import interop
from ov2slam_tpu_torch.core.lie import SE3
from ov2slam_tpu_torch.ops import mvg as tmvg

import test_mvg as tm
from torch_parity import n, t


def _angle(R):
    return float(np.arccos(np.clip((np.trace(R) - 1.0) / 2.0, -1.0, 1.0)))


def _two_view(seed, n_pts=64, tscale=0.8, noise=0.0):
    RNG = np.random.default_rng(seed)
    X = tm.make_scene(RNG, n_pts)
    T_ab = tm.random_pose(RNG, tscale=tscale, wscale=0.3)
    Xb = np.asarray(jlie.se3_apply(jlie.se3_inverse(T_ab), jnp.asarray(X)))
    bv_a = tm.bearings_of(X).astype(np.float32)
    bv_b = tm.bearings_of(Xb).astype(np.float32)
    if noise:
        bv_b = bv_b + RNG.normal(0, noise / 450.0, bv_b.shape).astype(np.float32)
        bv_b /= np.linalg.norm(bv_b, axis=-1, keepdims=True)
    return T_ab, bv_a, bv_b


@pytest.mark.parametrize("case", ["stereo", "per_point"])
def test_triangulate_midpoint_matches_jax_bit_for_bit(case):
    """The midpoint triangulation against the JAX package's compiled one,
    as ``mapper.triangulate_stereo`` calls it (one transform, a 0.11 m
    baseline) and as ``mapper.triangulate_temporal`` vmaps it (a transform
    per point): equal points, bit for bit. Its determinant is about the
    squared ray angle, so a rounding of another order moves the stereo
    depths by up to 3 cm at 3-12 m."""
    RNG = np.random.default_rng(31)
    N = 512
    X = np.stack([RNG.uniform(-6, 6, N), RNG.uniform(-4, 4, N),
                  RNG.uniform(3, 12, N)], 1).astype(np.float32)
    if case == "stereo":
        R = np.eye(3, dtype=np.float32)
        tr = np.array([0.11, 0.0, 0.0], np.float32)
        bv_b = tm.bearings_of(X - tr).astype(np.float32)
        fn = jax.jit(lambda a, b: jmvg.triangulate_midpoint(
            jlie.SE3(jnp.asarray(R), jnp.asarray(tr)), a, b))
        Xj = np.asarray(fn(tm.bearings_of(X).astype(np.float32), bv_b))
    else:
        R = np.asarray(jax.vmap(jlie.so3_exp)(jnp.asarray(
            RNG.normal(0, 0.02, (N, 3)), jnp.float32)))
        tr = (RNG.normal(0, 0.05, (N, 3)) + [0.3, 0.0, 0.0]).astype(np.float32)
        bv_b = tm.bearings_of(np.einsum("nji,nj->ni", R, X - tr)).astype(np.float32)
        fn = jax.jit(jax.vmap(lambda r, tt, a, b: jmvg.triangulate_midpoint(
            jlie.SE3(r, tt), a, b)))
        Xj = np.asarray(fn(R, tr, tm.bearings_of(X).astype(np.float32), bv_b))
    bv_a = tm.bearings_of(X).astype(np.float32)
    Xt = n(tmvg.triangulate_midpoint(SE3(t(R), t(tr)), t(bv_a), t(bv_b)))
    np.testing.assert_array_equal(Xt, Xj)
    assert np.abs(Xt - X).max() < 0.1


def test_sampson_fundamental_eight_point():
    T_ab, bv_a, bv_b = _two_view(12)
    E = np.asarray(jmvg.essential_from_pose(T_ab))
    E_t = n(tmvg.essential_from_pose(interop.se3(T_ab)))
    np.testing.assert_allclose(E_t, E, atol=1e-6)
    rng = np.random.default_rng(0)
    noisy = (bv_b + rng.normal(0, 0.01, bv_b.shape)).astype(np.float32)
    dj = np.asarray(jmvg.sampson_dist(jnp.asarray(E), jnp.asarray(bv_a),
                                      jnp.asarray(noisy)))
    dt = n(tmvg.sampson_dist(t(E), t(bv_a), t(noisy)))
    np.testing.assert_allclose(dt, dj, rtol=1e-5, atol=1e-12)
    K = np.array([[450.0, 0, 376], [0, 450, 240], [0, 0, 1]], np.float32)
    np.testing.assert_allclose(
        n(tmvg.fundamental_from_poses(t(K), t(K), interop.se3(T_ab))),
        np.asarray(jmvg.fundamental_from_poses(jnp.asarray(K), jnp.asarray(K),
                                               T_ab)), rtol=1e-5, atol=1e-9)
    xa, xb = bv_a / bv_a[:, 2:], bv_b / bv_b[:, 2:]
    E8j = np.asarray(jmvg._eight_point(jnp.asarray(xa[:12]), jnp.asarray(xb[:12])))
    E8t = n(tmvg._eight_point(t(xa[:12]), t(xb[:12])))
    En = E / np.linalg.norm(E)
    for E8 in (E8j, E8t):        # noiseless general scene: both exact
        E8 = E8 / np.linalg.norm(E8)
        assert min(np.abs(E8 - En).max(), np.abs(E8 + En).max()) < 2e-3


def test_decompose_essential():
    T_ab, bv_a, bv_b = _two_view(13, n_pts=80, noise=0.3)
    E = np.asarray(jmvg.essential_from_pose(T_ab))
    mask = np.ones(80, bool)
    Tj = jmvg.decompose_essential(jnp.asarray(E), jnp.asarray(bv_a),
                                  jnp.asarray(bv_b), jnp.asarray(mask))
    Tt = tmvg.decompose_essential(t(E), t(bv_a), t(bv_b), t(mask))
    np.testing.assert_allclose(n(Tt.R), np.asarray(Tj.R), atol=1e-5)
    np.testing.assert_allclose(n(Tt.t), np.asarray(Tj.t), atol=1e-5)
    assert _angle(n(Tt.R).T @ np.asarray(T_ab.R)) < 1e-4


@pytest.mark.parametrize("noise", [0.0, 0.3])
def test_refine_essential_pose(noise):
    """GN from a perturbed start. Noiseless it converges sharply and both
    packages agree to 1e-4 (rad; t direction up to sign, which the Sampson
    cost does not see). At 0.3 px the t direction is the weak part of the
    cost: both packages' GN steps move it by ~1e-3 rad per step around
    the minimum (measured), so there t agrees to 5e-3 rad."""
    T_ab, bv_a, bv_b = _two_view(13, n_pts=80, noise=noise)
    R0 = np.asarray(jlie.so3_exp(jnp.asarray([0.01, -0.02, 0.015], jnp.float32))
                    ) @ np.asarray(T_ab.R)
    t0 = np.asarray(T_ab.t) + np.array([0.05, -0.03, 0.02], np.float32)
    t0 = (t0 / np.linalg.norm(t0)).astype(np.float32)
    xa, xb = bv_a / bv_a[:, 2:], bv_b / bv_b[:, 2:]
    w = np.ones(80, np.float32)
    Rj = jmvg.refine_essential_pose(jlie.SE3(jnp.asarray(R0), jnp.asarray(t0)),
                                    jnp.asarray(xa), jnp.asarray(xb), jnp.asarray(w))
    Rt = tmvg.refine_essential_pose(SE3(t(R0), t(t0)), t(xa), t(xb), t(w))
    assert _angle(n(Rt.R).T @ np.asarray(Rj.R)) < 1e-4
    cos = abs(float(n(Rt.t) @ np.asarray(Rj.t)))
    assert np.arccos(min(cos, 1.0)) < (1e-4 if noise == 0 else 5e-3)
    assert abs(np.linalg.norm(n(Rt.t)) - 1.0) < 1e-5
    assert _angle(n(Rt.R).T @ np.asarray(T_ab.R)) < (1e-4 if noise == 0 else 5e-3)


def test_solve_quartic():
    rng = np.random.default_rng(10)
    c = rng.normal(size=(5, 64)).astype(np.float32)
    rj = np.asarray(jmvg._solve_quartic(*map(jnp.asarray, c)))
    rt = n(tmvg._solve_quartic(*map(t, c)))
    assert rt.dtype == np.complex64 and rt.shape == (64, 4)
    # the same roots, in either slot order
    for a, b in ((rt, rj), (rj, rt)):
        d = np.abs(a[:, :, None] - b[:, None, :]).min(-1)
        assert (d <= 1e-3 * np.maximum(1.0, np.abs(a))).all(), d.max()


def _p3p_scene(seed, n_pts=150, n_out=45, noise_px=0.3):
    RNG = np.random.default_rng(seed)
    T_cw = tm.random_pose(RNG, tscale=1.0, wscale=0.8)
    Xc = tm.make_scene(RNG, n_pts).astype(np.float32)
    X = np.asarray(jlie.se3_apply(jlie.se3_inverse(T_cw), jnp.asarray(Xc))
                   ).astype(np.float32)
    bv = tm.bearings_of(Xc).astype(np.float32)
    out_idx = RNG.choice(n_pts, n_out, replace=False)
    bv[out_idx] = tm.bearings_of(tm.make_scene(RNG, n_out)).astype(np.float32)
    bv += RNG.normal(0, noise_px / 450.0, size=bv.shape).astype(np.float32)
    bv /= np.linalg.norm(bv, axis=-1, keepdims=True)
    return T_cw, X, bv


def test_p3p_grunert_candidate_sets():
    T_cw, X, bv = _p3p_scene(14, n_out=0, noise_px=0.0)
    idx = np.random.default_rng(1).integers(0, 150, (48, 3))
    Tj, okj = jax.vmap(jmvg.p3p_grunert)(jnp.asarray(X[idx]), jnp.asarray(bv[idx]))
    Tt, okt = tmvg.p3p_grunert(t(X[idx]), t(bv[idx]))
    okj, okt = np.asarray(okj), n(okt)
    assert okt.shape == (48, 8) and (okj == okt).mean() >= 0.98
    Pj = np.concatenate([np.asarray(Tj.R).reshape(48, 8, 9),
                         np.asarray(Tj.t)], -1)
    Pt = np.concatenate([n(Tt.R).reshape(48, 8, 9), n(Tt.t)], -1)
    for A, okA, B, okB in ((Pt, okt, Pj, okj), (Pj, okj, Pt, okt)):
        found = [np.abs(B[i][okB[i]] - A[i, k]).max(-1).min(initial=np.inf) < 1e-2
                 for i, k in zip(*np.nonzero(okA))]
        assert np.mean(found) >= 0.95, np.mean(found)
    # the truth is among the valid candidates of (nearly) every sample
    truth = np.concatenate([np.asarray(T_cw.R).ravel(), np.asarray(T_cw.t)])
    hit = [(okt[i] & (np.abs(Pt[i] - truth).max(-1) < 2e-2)).any()
           for i in range(48)]
    assert np.mean(hit) >= 0.9


def test_p3p_ransac_with_jax_indices_and_refine():
    T_cw, X, bv = _p3p_scene(15)
    valid = np.ones(150, bool)
    valid[:5] = False
    K = 64
    key = jax.random.PRNGKey(1)
    p = valid.astype(np.float32) / valid.sum()
    idx = np.asarray(jax.random.choice(key, 150, shape=(K, 3), p=jnp.asarray(p)))
    Tj, ij, nj, okj = jmvg.p3p_ransac(jnp.asarray(X), jnp.asarray(bv),
                                      jnp.asarray(valid), key,
                                      err_th_norm=3.0 / 450.0, n_hyps=K)
    Tt, it, nt, okt = tmvg.p3p_ransac(t(X), t(bv), t(valid), 3.0 / 450.0,
                                      idx=t(idx))
    assert bool(okt) and bool(okj)
    assert (n(it) == np.asarray(ij)).mean() >= 0.99 and not n(it)[~valid].any()
    assert abs(int(nt) - int(nj)) <= 2
    assert _angle(n(Tt.R).T @ np.asarray(Tj.R)) < 1e-4
    np.testing.assert_allclose(n(Tt.t), np.asarray(Tj.t), atol=1e-3)
    assert _angle(n(Tt.R).T @ np.asarray(T_cw.R)) < 0.02

    # refine_pose_gn from a perturbed start, weights = the inliers
    R0 = np.asarray(jlie.so3_exp(jnp.asarray([0.02, 0.01, -0.01], jnp.float32))
                    ) @ np.asarray(T_cw.R)
    t0 = (np.asarray(T_cw.t) + 0.05).astype(np.float32)
    w = np.asarray(ij).astype(np.float32)
    Gj = jmvg.refine_pose_gn(jnp.asarray(X), jnp.asarray(bv), jnp.asarray(w),
                             jlie.SE3(jnp.asarray(R0), jnp.asarray(t0)))
    Gt = tmvg.refine_pose_gn(t(X), t(bv), t(w), SE3(t(R0), t(t0)))
    assert _angle(n(Gt.R).T @ np.asarray(Gj.R)) < 1e-4
    np.testing.assert_allclose(n(Gt.t), np.asarray(Gj.t), atol=1e-4)
