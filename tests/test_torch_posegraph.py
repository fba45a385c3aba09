"""The pose graph of the port (``ov2slam_tpu_torch/opt/posegraph.py`` and the
relative-pose factor of ``opt/residuals.py``) against the JAX package on the
same seeded inputs.

Tolerances: the closed-form relative-pose residual and Jacobians to 1e-5
(float32, same formulas); the LM solves (dense float32 normal equations
summed in another order) to 1e-4 in rotation (rad) and translation (m).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from ov2slam_tpu.core import lie as jlie
from ov2slam_tpu.opt import posegraph as jpg
from ov2slam_tpu.opt import residuals as jres
from ov2slam_tpu_torch import interop
from ov2slam_tpu_torch.opt import posegraph as tpg
from ov2slam_tpu_torch.opt import residuals as tres

from test_posegraph import make_drifty_loop
from torch_parity import n, t

TOL = 1e-4


def _rot_err(Ra, Rb) -> np.ndarray:
    """Rotation angle (rad) between batches of rotations, from the skew
    part of Ra^T Rb (|sin|; the arccos of the trace resolves only ~1e-3 rad
    for float32 matrices that are orthonormal to 1e-6)."""
    M = np.swapaxes(np.asarray(Ra, np.float64), -1, -2) @ np.asarray(Rb, np.float64)
    S = 0.5 * (M - np.swapaxes(M, -1, -2))
    return np.linalg.norm(np.stack([S[..., 2, 1], S[..., 0, 2], S[..., 1, 0]], -1), axis=-1)


def _rand_pose(rng, scale):
    return jlie.se3_exp(jnp.asarray(rng.normal(size=6).astype(np.float32) * scale))


@pytest.mark.parametrize("scale", [0.0, 1e-3, 0.2])
def test_relpose_jacobians_match_jax(scale):
    rng = np.random.default_rng(int(scale * 1e3) + 1)
    Ta, Tb = _rand_pose(rng, 0.5), _rand_pose(rng, 0.5)
    # the measurement is the true relative pose, perturbed by `scale`
    meas = jlie.se3_compose(_rand_pose(rng, scale),
                            jlie.se3_compose(Ta, jlie.se3_inverse(Tb)))
    rj, Jaj, Jbj = jres.relpose_jacobians(Ta, Tb, meas)
    rt, Jat, Jbt = tres.relpose_jacobians(interop.se3(Ta), interop.se3(Tb),
                                          interop.se3(meas))
    for a, b in ((rt, rj), (Jat, Jaj), (Jbt, Jbj)):
        np.testing.assert_allclose(n(a), np.asarray(b), atol=1e-5, rtol=1e-5)


def _chain_problem(rng, n_nodes=8, pad=4):
    """A drifted n-node chain with a loop edge (n-1 -> 0) at the true
    relative pose, edges padded with zero weight."""
    poses_gt, poses_dr = make_drifty_loop(rng, n_nodes)
    ei, ej, mR, mt = [], [], [], []
    for i in range(1, n_nodes):
        T_rel = jlie.se3_compose(poses_dr[i], jlie.se3_inverse(poses_dr[i - 1]))
        ei.append(i)
        ej.append(i - 1)
        mR.append(np.asarray(T_rel.R))
        mt.append(np.asarray(T_rel.t))
    T_loop = jlie.se3_compose(poses_gt[-1], jlie.se3_inverse(poses_gt[0]))
    ei.append(n_nodes - 1)
    ej.append(0)
    mR.append(np.asarray(T_loop.R))
    mt.append(np.asarray(T_loop.t))
    w = [1.0] * len(ei) + [0.0] * pad
    ei += [0] * pad
    ej += [0] * pad
    mR += [np.eye(3, dtype=np.float32)] * pad
    mt += [np.zeros(3, np.float32)] * pad
    return jpg.PoseGraphProblem(
        R=jnp.asarray(np.stack([np.asarray(T.R) for T in poses_dr])),
        t=jnp.asarray(np.stack([np.asarray(T.t) for T in poses_dr])),
        pose_opt=jnp.asarray(np.arange(n_nodes) > 0),
        edge_i=jnp.asarray(np.asarray(ei, np.int32)),
        edge_j=jnp.asarray(np.asarray(ej, np.int32)),
        meas_R=jnp.asarray(np.stack(mR)), meas_t=jnp.asarray(np.stack(mt)),
        edge_weight=jnp.asarray(np.asarray(w, np.float32)))


@pytest.mark.parametrize("max_iters", [1, 10])
def test_solve_pose_graph_matches_jax(max_iters):
    prob = _chain_problem(np.random.default_rng(0))
    oj = jpg.solve_pose_graph(prob, max_iters=max_iters)
    ot = tpg.solve_pose_graph(interop.pose_graph_problem(prob),
                              max_iters=max_iters)
    assert float(ot.cost) < 0.5 * float(ot.cost0)
    np.testing.assert_allclose(float(ot.cost0), float(oj.cost0), rtol=1e-5)
    np.testing.assert_allclose(float(ot.cost), float(oj.cost), rtol=1e-3,
                               atol=1e-7)
    assert _rot_err(n(ot.R), np.asarray(oj.R)).max() <= TOL
    np.testing.assert_allclose(n(ot.t), np.asarray(oj.t), atol=TOL)
    # the gauge node stays put
    np.testing.assert_array_equal(n(ot.R)[0], np.asarray(prob.R)[0])


def test_batched_solve_equals_one_by_one():
    """The leading batch dimension solves each problem as alone."""
    probs = [interop.pose_graph_problem(_chain_problem(np.random.default_rng(s)))
             for s in (1, 2)]
    ob = tpg.solve_pose_graph(tpg.PoseGraphProblem(
        *(torch.stack([a, b]) for a, b in zip(*probs))), max_iters=10)
    for k, p in enumerate(probs):
        o1 = tpg.solve_pose_graph(p, max_iters=10)
        np.testing.assert_allclose(n(ob.R)[k], n(o1.R), atol=1e-5)
        np.testing.assert_allclose(n(ob.t)[k], n(o1.t), atol=1e-5)


def _arc(rng, n_frames=27, kf_every=8):
    """Ground-truth arc, drifted tracking poses and every kf_every-th frame
    index."""
    gt = [np.eye(4)]
    for _ in range(1, n_frames):
        th = 0.02
        step = np.eye(4)
        step[:3, :3] = [[np.cos(th), 0, np.sin(th)], [0, 1, 0],
                        [-np.sin(th), 0, np.cos(th)]]
        step[:3, 3] = [0.1, 0.0, 0.01]
        gt.append(gt[-1] @ step)
    gt = np.stack(gt)
    raw = [gt[0].copy()]
    for i in range(1, n_frames):
        d = np.eye(4)
        ax = rng.normal(0, 0.002, 3)
        K = np.array([[0, -ax[2], ax[1]], [ax[2], 0, -ax[0]], [-ax[1], ax[0], 0]])
        d[:3, :3] = np.eye(3) + K + 0.5 * (K @ K)
        d[:3, 3] = rng.normal(0, 0.01, 3)
        raw.append(raw[-1] @ np.linalg.inv(gt[i - 1]) @ gt[i] @ d)
    return gt, np.stack(raw), np.arange(0, n_frames, kf_every)


def test_relax_full_trajectory_matches_jax():
    """Three segments between four keyframes (frames 1, 9, 17, 25 of 27);
    frame 0 before the first KF and 26 after the last take the rigid
    rebuild."""
    gt, raw, kf_idx = _arc(np.random.default_rng(3))
    kf_idx = kf_idx[:4] + 1
    rj = jpg.relax_full_trajectory(raw, kf_idx, gt[kf_idx])
    rt = tpg.relax_full_trajectory(raw, kf_idx, gt[kf_idx])
    assert len(kf_idx) == 4 and rt.shape == raw.shape and np.isfinite(rt).all()
    np.testing.assert_allclose(rt[kf_idx], gt[kf_idx], atol=1e-5)
    assert _rot_err(rt[:, :3, :3], rj[:, :3, :3]).max() <= TOL
    np.testing.assert_allclose(rt[:, :3, 3], rj[:, :3, 3], atol=TOL)


def test_propagate_correction_matches_jax():
    rng = np.random.default_rng(1)
    poses_gt, poses_dr = make_drifty_loop(rng, 10)
    st = lambda ps, f: jnp.asarray(np.stack([np.asarray(getattr(T, f)) for T in ps]))  # noqa: E731
    args = (st(poses_dr, "R"), st(poses_dr, "t"), st(poses_gt, "R"), st(poses_gt, "t"))
    tail = _rand_pose(rng, 0.1)
    oj = jpg.propagate_correction(*args, 9, tail.R[None], tail.t[None])
    ot = tpg.propagate_correction(*(t(a) for a in args), 9, t(tail.R)[None],
                                  t(tail.t)[None])
    np.testing.assert_allclose(n(ot.R), np.asarray(oj.R), atol=1e-5)
    np.testing.assert_allclose(n(ot.t), np.asarray(oj.t), atol=1e-5)
