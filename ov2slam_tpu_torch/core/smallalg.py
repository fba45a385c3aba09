"""Small fixed-size linear algebra (port of the parts of
``ov2slam_tpu/core/smallalg.py`` the slice uses).

``solve_spd`` (PnP normal equations, ``opt/pnp.py``) and ``inv3`` (SE(3) log,
XYZ-landmark Schur blocks in ``opt/ba.py``) are unrolled over their static
size exactly as in the JAX package, so a batch of tiny systems is a handful
of elementwise ops instead of a batched LAPACK call per system.
"""

from __future__ import annotations

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
