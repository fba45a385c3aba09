"""Parity of the port's Jacobi eigensolver and the SVD / Procrustes pieces
built on it (``core/smallalg.py``) with the JAX package.

Both run the same cyclic Jacobi (6 sweeps, half-angle rotations); the JAX
package applies each rotation as a one-hot matmul, the port as the
equivalent two-row / two-column update, so single roundings differ. The
half-angle formulas cannot resolve a rotation angle below ~sqrt(eps) in
float32 (1 - x/h rounds to 0), so both packages leave off-diagonal residue
of up to ~1e-4 of the matrix norm (measured: 1.2e-4 / 3.4e-4 / 9.2e-4 for
the JAX package at n = 3 / 4 / 9 on the inputs below). The tests hold the
port to that floor instead of to float32 rounding:
* each package's error against the exact answer (reconstruction
  V diag(w) V^T vs A, U diag(s) Vt vs E, rotations and projections vs the
  truth) is at most 2x the JAX package's own plus 1e-5 of the norm;
* eigenvalues and singular values agree to 5e-4 of the norm, eigenvectors
  and singular vectors to 3e-3 (measured up to 7.5e-4), orthogonality to
  1e-5.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from ov2slam_tpu.core import smallalg as js
from ov2slam_tpu_torch.core import smallalg as ts

from torch_parity import n, t


def _sym(rng, batch, k):
    """Symmetric (batch, k, k) float32 with eigenvalues spaced >= 0.5."""
    Q, _ = np.linalg.qr(rng.normal(size=(batch, k, k)))
    w = np.arange(k) * 1.0 + rng.uniform(0, 0.5, (batch, k)) - k / 2
    return ((Q * w[:, None, :]) @ Q.transpose(0, 2, 1)).astype(np.float32)


def _rot(rng, batch):
    Q, _ = np.linalg.qr(rng.normal(size=(batch, 3, 3)))
    Q[np.linalg.det(Q) < 0, :, 0] *= -1
    return Q.astype(np.float32)


def _as_accurate(err_t, err_j, scale):
    assert err_t <= 2.0 * err_j + 1e-5 * scale, (err_t, err_j)


@pytest.mark.parametrize("k", [3, 4, 9])
def test_eigh_jacobi(k):
    A = _sym(np.random.default_rng(k), 32, k)
    wj, Vj = (n(a) for a in js.eigh_jacobi(jnp.asarray(A)))
    wt, Vt = (n(a) for a in ts.eigh_jacobi(t(A)))
    scale = np.abs(A).max()
    np.testing.assert_allclose(wt, wj, atol=5e-4 * scale)
    assert (np.diff(wt, axis=-1) > 0).all()
    np.testing.assert_allclose(Vt, Vj, atol=3e-3)
    rec = lambda w, V: (V * w[:, None, :]) @ V.transpose(0, 2, 1)  # noqa: E731
    _as_accurate(np.abs(rec(wt, Vt) - A).max(), np.abs(rec(wj, Vj) - A).max(),
                 scale)
    np.testing.assert_allclose(Vt.transpose(0, 2, 1) @ Vt,
                               np.broadcast_to(np.eye(k), Vt.shape), atol=1e-5)
    np.testing.assert_allclose(n(ts.smallest_eigvec(t(A))),
                               n(js.smallest_eigvec(jnp.asarray(A))), atol=3e-3)


def test_svd3_and_essential_project():
    rng = np.random.default_rng(1)
    R = _rot(rng, 16)
    s = np.stack([np.full(16, 3.0), np.full(16, 2.0), np.full(16, 1.0)], -1)
    s = s + rng.uniform(0, 0.4, (16, 3))
    E = ((R * s[:, None, :]) @ _rot(rng, 16)).astype(np.float32)
    Uj, sj, Vj = (n(a) for a in js.svd3(jnp.asarray(E)))
    Ut, st, Vt = (n(a) for a in ts.svd3(t(E)))
    np.testing.assert_allclose(st, sj, atol=5e-4 * 3.4)
    _as_accurate(np.abs((Ut * st[:, None, :]) @ Vt - E).max(),
                 np.abs((Uj * sj[:, None, :]) @ Vj - E).max(), 3.4)
    np.testing.assert_allclose(Ut, Uj, atol=3e-3)
    np.testing.assert_allclose(Vt, Vj, atol=3e-3)
    # essential inputs (singular values (1, 1, 0)) project onto themselves
    Es = ((R * np.array([1.0, 1.0, 0.0])[None, None]) @ _rot(rng, 16)
          ).astype(np.float32)
    Pt, Pj = n(ts.essential_project(t(Es))), n(js.essential_project(jnp.asarray(Es)))
    _as_accurate(np.abs(Pt - Es).max(), np.abs(Pj - Es).max(), 1.0)
    np.testing.assert_allclose(Pt, Pj, atol=3e-3)


def test_procrustes_rotation():
    rng = np.random.default_rng(2)
    R = _rot(rng, 32)
    a = rng.normal(size=(32, 3, 8)).astype(np.float32)
    M = ((R @ a) @ a.transpose(0, 2, 1)).astype(np.float32)   # b = R a exactly
    Rt = n(ts.procrustes_rotation(t(M)))
    Rj = n(js.procrustes_rotation(jnp.asarray(M)))
    _as_accurate(np.abs(Rt - R).max(), np.abs(Rj - R).max(), 1.0)
    np.testing.assert_allclose(Rt, Rj, atol=3e-3)
    np.testing.assert_allclose(Rt @ Rt.transpose(0, 2, 1),
                               np.broadcast_to(np.eye(3), Rt.shape), atol=1e-5)
