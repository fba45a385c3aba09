"""Small fixed-size linear algebra (port of ``ov2slam_tpu/core/smallalg.py``).

``solve_spd`` (PnP normal equations, ``opt/pnp.py``) and ``inv3`` (SE(3) log,
XYZ-landmark Schur blocks in ``opt/ba.py``) are unrolled over their static
size exactly as in the JAX package, so a batch of tiny systems is a handful
of elementwise ops instead of a batched LAPACK call per system.

``eigh_jacobi`` is the JAX package's fixed-sweep cyclic Jacobi, ported as
written (ascending eigenvalues, half-angle rotations, 6 sweeps) and not
swapped for ``torch.linalg.eigh``: the 5-point solver takes a basis of a
4-dimensional eigenspace from it, and another eigensolver would return
another basis of the same space. The JAX package applies each rotation as a
one-hot (n, n) matmul to keep XLA's compile small; here it is the
equivalent two-row / two-column update (c * a + s * b per entry, the same
products the matmul sums with zeros).
"""

from __future__ import annotations

from typing import Tuple

import torch


def solve_spd(H: torch.Tensor, g: torch.Tensor, eps: float = 1e-12
              ) -> torch.Tensor:
    """Solve H x = g for SPD H of static size (..., n, n), g (..., n).

    Unrolled Cholesky + two triangular solves; the diagonal is guarded by
    eps so singular inputs give large-but-finite outputs."""
    n = H.shape[-1]
    L = [[None] * n for _ in range(n)]
    for i in range(n):
        for j in range(i + 1):
            s = H[..., i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            if i == j:
                L[i][j] = torch.sqrt(torch.clamp(s, min=eps))
            else:
                L[i][j] = s / L[j][j]
    y = [None] * n
    for i in range(n):
        s = g[..., i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y[i] = s / L[i][i]
    x = [None] * n
    for i in range(n - 1, -1, -1):
        s = y[i]
        for k in range(i + 1, n):
            s = s - L[k][i] * x[k]
        x[i] = s / L[i][i]
    return torch.stack(x, dim=-1)


def cholesky_spd(H: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Lower Cholesky factor (..., n, n) of SPD H by ``solve_spd``'s
    unrolled recurrence and diagonal guard, for callers that solve with one
    matrix many times (``cho_solve_spd``)."""
    n = H.shape[-1]
    L = [[torch.zeros_like(H[..., 0, 0])] * n for _ in range(n)]
    for i in range(n):
        for j in range(i + 1):
            s = H[..., i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            L[i][j] = (torch.sqrt(torch.clamp(s, min=eps)) if i == j
                       else s / L[j][j])
    return torch.stack([torch.stack(row, dim=-1) for row in L], dim=-2)


def cho_solve_spd(L: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Solve (L L^T) x = g for a lower Cholesky factor L (batched): two
    triangular solves, none of which checks for errors, so nothing waits
    for the card."""
    y = torch.linalg.solve_triangular(L, g[..., None], upper=False)
    return torch.linalg.solve_triangular(L.mT, y, upper=True)[..., 0]


def inv3(A: torch.Tensor, eps: float = 1e-30) -> torch.Tensor:
    """Closed-form inverse of (..., 3, 3) via the adjugate."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    A11 = e * i - f * h
    A12 = c * h - b * i
    A13 = b * f - c * e
    A21 = f * g - d * i
    A22 = a * i - c * g
    A23 = c * d - a * f
    A31 = d * h - e * g
    A32 = b * g - a * h
    A33 = a * e - b * d
    det = a * A11 + b * A21 + c * A31
    det = torch.where(torch.abs(det) < eps, torch.full_like(det, eps), det)
    inv = torch.stack([
        torch.stack([A11, A12, A13], dim=-1),
        torch.stack([A21, A22, A23], dim=-1),
        torch.stack([A31, A32, A33], dim=-1),
    ], dim=-2)
    return inv / det[..., None, None]


def _rotate_pair(X: torch.Tensor, p: int, q: int, c: torch.Tensor,
                 s: torch.Tensor, dim: int) -> torch.Tensor:
    """Rows (dim=-2) or columns (dim=-1) p, q of X <- [[c, s], [-s, c]]
    applied to them; c, s (...,). Returns a new tensor."""
    c, s = c[..., None], s[..., None]
    xp, xq = X.select(dim, p), X.select(dim, q)
    newp, newq = c * xp + s * xq, c * xq - s * xp
    X = X.clone()
    X.select(dim, p).copy_(newp)
    X.select(dim, q).copy_(newq)
    return X


_SWEEPS = 6


def eigh_jacobi(A: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Eigendecomposition of symmetric (..., n, n), n static and small.

    `_SWEEPS` fixed sweeps of cyclic Jacobi rotations. Returns (w, V) with w
    ASCENDING and A = V diag(w) V^T. The angle uses half-angle square roots,
    no trig. Each rotation A <- J A J^T, V <- V J^T with J the identity
    carrying [[c, s], [-s, c]] in the (p, q) plane."""
    n = A.shape[-1]
    V = torch.eye(n, dtype=A.dtype, device=A.device).expand(A.shape).clone()
    for _ in range(_SWEEPS):
        for p in range(n - 1):
            for q in range(p + 1, n):
                x = A[..., p, p] - A[..., q, q]
                y = 2.0 * A[..., p, q]
                h = torch.clamp(torch.sqrt(x * x + y * y), min=1e-30)
                c = torch.sqrt(torch.clamp((1.0 + x / h) * 0.5, min=0.0))
                s = torch.sign(y) * torch.sqrt(
                    torch.clamp((1.0 - x / h) * 0.5, min=0.0))
                small = torch.abs(y) < 1e-30
                c = torch.where(small, torch.ones_like(c), c)
                s = torch.where(small, torch.zeros_like(s), s)
                A = _rotate_pair(_rotate_pair(A, p, q, c, s, -2), p, q, c, s, -1)
                V = _rotate_pair(V, p, q, c, s, -1)
    w = torch.diagonal(A, dim1=-2, dim2=-1)
    order = torch.argsort(w, dim=-1, stable=True)
    w = torch.gather(w, -1, order)
    V = torch.gather(V, -1, order[..., None, :].expand(V.shape))
    return w, V


def _unit(v: torch.Tensor, eps: float = 1e-20) -> torch.Tensor:
    return v / torch.clamp(torch.linalg.norm(v, dim=-1, keepdim=True), min=eps)


def smallest_eigvec(A: torch.Tensor) -> torch.Tensor:
    """Unit eigenvector of the smallest eigenvalue of symmetric (..., n, n)."""
    _, V = eigh_jacobi(A)
    return _unit(V[..., :, 0])


def svd3(E: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """SVD of (..., 3, 3): (U, s, Vt) with s DESCENDING, E = U s Vt.

    Via eigh of E E^T (left basis), the right basis recovered as
    v_i = E^T u_i / s_i and the third right vector from the cross product,
    so rank-2 inputs (essential matrices) stay well-defined."""
    G = E @ E.transpose(-1, -2)
    w, U = eigh_jacobi(G)
    w = torch.flip(w, dims=[-1])
    U = torch.flip(U, dims=[-1])
    s = torch.sqrt(torch.clamp(w, min=0.0))
    Et = E.transpose(-1, -2)
    v0 = _unit(torch.einsum("...ij,...j->...i", Et, U[..., :, 0]))
    v1 = torch.einsum("...ij,...j->...i", Et, U[..., :, 1])
    v1 = _unit(v1 - torch.sum(v1 * v0, dim=-1, keepdim=True) * v0)
    v2 = torch.linalg.cross(v0, v1, dim=-1)
    w2 = torch.einsum("...ij,...j->...i", Et, U[..., :, 2])
    flip = torch.sum(v2 * w2, dim=-1, keepdim=True) < 0
    v2 = torch.where(flip, -v2, v2)
    return U, s, torch.stack([v0, v1, v2], dim=-2)


def essential_project(E: torch.Tensor) -> torch.Tensor:
    """Project (..., 3, 3) onto the essential manifold: singular values
    -> (1, 1, 0)."""
    U, _, Vt = svd3(E)
    return (U[..., :, 0:1] * Vt[..., 0:1, :]
            + U[..., :, 1:2] * Vt[..., 1:2, :])


def procrustes_rotation(M: torch.Tensor) -> torch.Tensor:
    """The proper rotation R maximizing trace(R^T M) for (..., 3, 3) M, by
    the quaternion (Davenport) method: R's quaternion is the eigenvector of
    the largest eigenvalue of the symmetric 4x4 K-matrix."""
    m00, m01, m02 = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    m10, m11, m12 = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    m20, m21, m22 = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    K = torch.stack([
        torch.stack([m00 + m11 + m22, m21 - m12, m02 - m20, m10 - m01], -1),
        torch.stack([m21 - m12, m00 - m11 - m22, m01 + m10, m02 + m20], -1),
        torch.stack([m02 - m20, m01 + m10, -m00 + m11 - m22, m12 + m21], -1),
        torch.stack([m10 - m01, m02 + m20, m12 + m21, -m00 - m11 + m22], -1),
    ], dim=-2)
    _, V = eigh_jacobi(K)
    q = _unit(V[..., :, -1])
    qw, qx, qy, qz = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack([
        torch.stack([1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - qw * qz),
                     2 * (qx * qz + qw * qy)], -1),
        torch.stack([2 * (qx * qy + qw * qz), 1 - 2 * (qx * qx + qz * qz),
                     2 * (qy * qz - qw * qx)], -1),
        torch.stack([2 * (qx * qz - qw * qy), 2 * (qy * qz + qw * qx),
                     1 - 2 * (qx * qx + qy * qy)], -1),
    ], dim=-2)
