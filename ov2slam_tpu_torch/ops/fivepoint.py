"""Batched Nister 5-point essential-matrix solver (port of
``ov2slam_tpu/ops/fivepoint.py``).

Replaces the reference's OpenGV NISTER relative-pose backend
(src/multi_view_geometry.cpp:594-698). Nister's polynomial route without a
nonsymmetric eigensolver: the 4-dim nullspace of the 5 epipolar rows (Jacobi
eigh, refined twice against the data), the 10x20 cubic constraint system
expanded by generic polynomial arithmetic over static monomial tables, a
Gauss-Jordan reduction with one refinement step, and the real roots of
det B(z) by a 128-point grid scan in a = atan(z), 26 bisection steps and
tangent-root fills, plus 6 fixed seeds; every candidate gets 12
Gauss-Newton steps on the cubic constraints and must pass the essentiality
gate rel < 3e-4.

Every function takes any number of leading batch dimensions (the RANSAC's
hypotheses), where the JAX package vmaps a single-sample function. The
monomial products are sums over static index tables, applied as products
with constant 0/1 matrices (exact in float32, and deterministic on the
card, unlike an atomic scatter-add).
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from ov2slam_tpu_torch.core import smallalg

# ---------------------------------------------------------------------------
# static monomial tables for polynomials in (x, y, z)
# ---------------------------------------------------------------------------
# deg-1 basis: [x, y, z, 1]
_E1 = [(1, 0, 0), (0, 1, 0), (0, 0, 1), (0, 0, 0)]


def _monomials(max_deg: int):
    out = []
    for d in range(max_deg, -1, -1):
        for i in range(d, -1, -1):
            for j in range(d - i, -1, -1):
                out.append((i, j, d - i - j))
    return out


_E2 = _monomials(2)       # 10 monomials
_E3 = _monomials(3)       # 20 monomials
_IDX2 = {m: i for i, m in enumerate(_E2)}
_IDX3 = {m: i for i, m in enumerate(_E3)}


def _product_table(lhs, rhs, idx) -> np.ndarray:
    """(len(lhs) * len(rhs), len(idx)) 0/1 matrix sending the flattened
    outer product of two coefficient vectors to the product's monomials."""
    out = np.zeros((len(lhs) * len(rhs), len(idx)), np.float32)
    for i, a in enumerate(lhs):
        for j, b in enumerate(rhs):
            out[i * len(rhs) + j, idx[(a[0] + b[0], a[1] + b[1], a[2] + b[2])]] = 1.0
    return out


_MUL11 = _product_table(_E1, _E1, _IDX2)      # (16, 10)
_MUL21 = _product_table(_E2, _E1, _IDX3)      # (40, 20)


# Nister's monomial ordering for the Gauss-Jordan step: the leading 10
# columns carry every monomial of degree >= 2 in (x, y) or mixed with z; the
# trailing 10 are x*z^a, y*z^a, z^a.
_LEAD = [(3, 0, 0), (0, 3, 0), (2, 1, 0), (1, 2, 0), (2, 0, 1), (2, 0, 0),
         (0, 2, 1), (0, 2, 0), (1, 1, 1), (1, 1, 0)]
_TRAIL = [(1, 0, 2), (1, 0, 1), (1, 0, 0), (0, 1, 2), (0, 1, 1), (0, 1, 0),
          (0, 0, 3), (0, 0, 2), (0, 0, 1), (0, 0, 0)]
_COL_ORDER = np.asarray([_IDX3[m] for m in _LEAD + _TRAIL])

# rows of the reduced system, by leading monomial position in _LEAD:
_ROW_E, _ROW_F = 4, 5          # x^2 z, x^2
_ROW_G, _ROW_H = 6, 7          # y^2 z, y^2
_ROW_I, _ROW_J = 8, 9          # xyz,   xy

_N_GRID = 128
_MAX_ROOTS = 10

# every constant table the solver uses, by name
_TABLES = {
    "mul11": _MUL11,
    "mul21": _MUL21,
    "exp3": np.asarray(_E3, np.float32),
    "col_order": _COL_ORDER,
    # the root scan's grid in a = atan(z), and the 6 extra seeds
    "grid": np.linspace(-np.pi / 2 + 1e-3, np.pi / 2 - 1e-3, _N_GRID),
    "seeds": np.linspace(-np.pi / 2 * 0.85, np.pi / 2 * 0.85, 6),
}


@functools.lru_cache(maxsize=None)
def _table(name: str, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """A constant table on (dtype, device), copied there once: a copy from
    host memory waits for the card's stream, and the solver uses its tables
    about 80 times per call."""
    return torch.as_tensor(_TABLES[name], dtype=dtype, device=device)


def _pmul(a: torch.Tensor, b: torch.Tensor, table: str) -> torch.Tensor:
    prod = a[..., :, None] * b[..., None, :]
    flat = prod.reshape(*prod.shape[:-2], -1)
    return flat @ _table(table, a.dtype, a.device)


def _pmul11(a, b):
    """(..., 4) x (..., 4) deg-1 polys -> (..., 10) deg-2 poly."""
    return _pmul(a, b, "mul11")


def _pmul21(a, b):
    """(..., 10) deg-2 x (..., 4) deg-1 -> (..., 20) deg-3 poly."""
    return _pmul(a, b, "mul21")


def _constraint_rows(Ebasis: torch.Tensor) -> torch.Tensor:
    """Ebasis (..., 4, 3, 3) nullspace basis (E = x*E0 + y*E1 + z*E2 + E3)
    -> (..., 10, 20) cubic constraint coefficients over the deg-3 basis."""
    P = torch.movedim(Ebasis, -3, -1)                   # (..., 3, 3, 4)

    def m11(i1, j1, i2, j2):
        return _pmul11(P[..., i1, j1, :], P[..., i2, j2, :])

    rows = []
    # det(E) = 0 (cofactor expansion along the first row)
    c00 = m11(1, 1, 2, 2) - m11(1, 2, 2, 1)
    c01 = m11(1, 2, 2, 0) - m11(1, 0, 2, 2)
    c02 = m11(1, 0, 2, 1) - m11(1, 1, 2, 0)
    rows.append(_pmul21(c00, P[..., 0, 0, :]) + _pmul21(c01, P[..., 0, 1, :])
                + _pmul21(c02, P[..., 0, 2, :]))
    # trace constraint 2 E E^T E - tr(E E^T) E = 0 (9 cubic equations)
    G = [[m11(i, 0, j, 0) + m11(i, 1, j, 1) + m11(i, 2, j, 2)
          for j in range(3)] for i in range(3)]
    tr = G[0][0] + G[1][1] + G[2][2]
    for i in range(3):
        for j in range(3):
            acc = (_pmul21(G[i][0], P[..., 0, j, :])
                   + _pmul21(G[i][1], P[..., 1, j, :])
                   + _pmul21(G[i][2], P[..., 2, j, :]))
            rows.append(2.0 * acc - _pmul21(tr, P[..., i, j, :]))
    return torch.stack(rows, dim=-2)


# ---------------------------------------------------------------------------
# degree-10 polynomial real roots: grid sign changes + bisection
# ---------------------------------------------------------------------------

def _scan_real_roots(q_of, dtype, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """Real roots of q(a) on a in (-pi/2, pi/2); z = tan(a_root).

    q_of maps angles (..., S) to values (..., S) (det B(tan a) * cos(a)^12).
    Grid-scan, bisect each sign change in a-space; slots beyond the sign
    changes take the grid points of locally minimal |q| (candidate tangent
    roots), which the caller's polish and essentiality gate arbitrate.
    Returns (z_roots, valid), shape (..., 10)."""
    a = _table("grid", dtype, device)
    qv = q_of(a)                                          # (..., S)
    sgn = torch.sign(qv)
    changed = sgn[..., :-1] * sgn[..., 1:] < 0            # (..., S-1)
    absq = torch.abs(qv)
    is_lmin = ((absq[..., 1:-1] <= absq[..., :-2])
               & (absq[..., 1:-1] <= absq[..., 2:]))      # (..., S-2)
    near_change = changed[..., :-1] | changed[..., 1:]
    inf = torch.full_like(absq[..., 1:-1], float("inf"))
    lmin_score = torch.where(is_lmin & ~near_change, absq[..., 1:-1], inf)
    lmin_order = torch.argsort(lmin_score, dim=-1, stable=True)
    # sign-change intervals first, in index order (stable)
    order = torch.argsort((~changed).to(torch.int32), dim=-1,
                          stable=True)[..., :_MAX_ROOTS]
    valid = torch.gather(changed, -1, order)
    # rank k invalid slot <- rank k tangent candidate
    inv_rank = torch.cumsum((~valid).to(torch.int64), dim=-1) - 1
    ci = torch.clamp(inv_rank, 0, lmin_order.shape[-1] - 1)
    fill = torch.gather(lmin_order, -1, ci)
    fill_ok = torch.gather(lmin_score, -1, ci) < float("inf")
    is_fill = ~valid & fill_ok
    order = torch.where(valid, order, torch.where(fill_ok, fill, order))
    valid = valid | fill_ok
    up = torch.clamp(order + 1, max=_N_GRID - 1)
    lo = torch.where(is_fill, a[up], a[order])
    hi = a[up]
    qlo = torch.gather(qv, -1, order)
    for _ in range(26):
        mid = 0.5 * (lo + hi)
        qm = q_of(mid)
        go_hi = (qm * qlo) > 0                            # root in [mid, hi]
        lo, hi, qlo = (torch.where(go_hi, mid, lo), torch.where(go_hi, hi, mid),
                       torch.where(go_hi, qm, qlo))
    return torch.tan(0.5 * (lo + hi)), valid


def _horner(p: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """Polynomial (..., D) in ascending powers at z (..., S)."""
    acc = torch.zeros_like(z)
    for k in range(p.shape[-1] - 1, -1, -1):
        acc = acc * z + p[..., k:k + 1]
    return acc


def _mono3_and_grad(v: torch.Tensor):
    """Degree-3 monomials (..., 20) of v = (x, y, z) (..., 3) and their
    gradients (..., 20, 3), from the static exponent table (0^0 = 1)."""
    exps = _table("exp3", v.dtype, v.device)
    ex, ey, ez = exps[:, 0], exps[:, 1], exps[:, 2]
    vx, vy, vz = v[..., 0:1], v[..., 1:2], v[..., 2:3]

    def powi(base, e):
        out = torch.ones_like(base) * torch.ones_like(e)
        for k in (1, 2, 3):
            out = torch.where(e >= k, out * base, out)
        return out

    px_, py_, pz_ = powi(vx, ex), powi(vy, ey), powi(vz, ez)
    zero = torch.zeros((), dtype=v.dtype, device=v.device)
    dpx = torch.where(ex > 0, ex * powi(vx, ex - 1), zero) * py_ * pz_
    dpy = torch.where(ey > 0, ey * powi(vy, ey - 1), zero) * px_ * pz_
    dpz = torch.where(ez > 0, ez * powi(vz, ez - 1), zero) * px_ * py_
    return px_ * py_ * pz_, torch.stack([dpx, dpy, dpz], dim=-1)


def _solve(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Batched A X = B that neither raises nor syncs with the host on a
    singular A (a sample that repeats a point): like jnp.linalg.solve, the
    result is then non-finite and the essentiality gate rejects it."""
    return torch.linalg.solve_ex(A, B, check_errors=False).result


def five_point_essential(x_a: torch.Tensor, x_b: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Essential matrices from 5 normalized correspondences.

    x_a, x_b: (..., 5, 3) homogeneous normalized coords (z=1) with
    x_a^T E x_b = 0. Returns (Es (..., 10, 3, 3), valid (..., 10)): up to 10
    real solutions, the valid ones first by constraint residual."""
    dt, dev = x_a.dtype, x_a.device
    xa, ya = x_a[..., 0], x_a[..., 1]
    xb, yb = x_b[..., 0], x_b[..., 1]
    Q = torch.stack([xa * xb, xa * yb, xa, ya * xb, ya * yb, ya,
                     xb, yb, torch.ones_like(xa)], dim=-1)          # (..., 5, 9)
    Qt = Q.transpose(-1, -2)
    # 4-dim nullspace: the 4 smallest eigenvectors of Q^T Q, then two Newton
    # steps against Q itself (V <- V - Q^+ (Q V), Q^+ = Q^T (Q Q^T)^-1) and
    # Gram-Schmidt re-orthonormalization
    _, Vfull = smallalg.eigh_jacobi(Qt @ Q)
    V = Vfull[..., :, :4]                                           # (..., 9, 4)
    QQt = Q @ Qt + 1e-12 * torch.eye(5, dtype=dt, device=dev)
    for _ in range(2):
        V = V - Qt @ _solve(QQt, Q @ V)
        cols = []
        for c in range(4):
            v = V[..., :, c]
            for u in cols:
                v = v - torch.sum(u * v, dim=-1, keepdim=True) * u
            cols.append(v / torch.clamp(torch.linalg.norm(v, dim=-1, keepdim=True),
                                        min=1e-12))
        V = torch.stack(cols, dim=-1)
    basis = V.transpose(-1, -2).reshape(V.shape[:-2] + (4, 3, 3))

    M0 = _constraint_rows(basis)                                    # (..., 10, 20)
    M = torch.index_select(M0, -1, _table("col_order", torch.int64, dev))
    M = M / torch.clamp(torch.amax(torch.abs(M), dim=-1, keepdim=True), min=1e-12)
    A10 = M[..., :10] + 1e-12 * torch.eye(10, dtype=dt, device=dev)
    C10 = M[..., 10:]
    # Gauss-Jordan with one step of iterative refinement
    Bmat = _solve(A10, C10)
    Bmat = Bmat + _solve(A10, C10 - A10 @ Bmat)

    # rows e - z*f, g - z*h, i - z*j; trailing columns
    # [x z^2, x z, x, y z^2, y z, y, z^3, z^2, z, 1]
    def row_pair(r_hi, r_lo):
        e, f = Bmat[..., r_hi, :], Bmat[..., r_lo, :]
        bx = torch.stack([e[..., 2], e[..., 1] - f[..., 2], e[..., 0] - f[..., 1],
                          -f[..., 0]], dim=-1)
        by = torch.stack([e[..., 5], e[..., 4] - f[..., 5], e[..., 3] - f[..., 4],
                          -f[..., 3]], dim=-1)
        bc = torch.stack([e[..., 9], e[..., 8] - f[..., 9], e[..., 7] - f[..., 8],
                          e[..., 6] - f[..., 7], -f[..., 6]], dim=-1)
        # normalize the B(z) row (a positive scale keeps det's signs)
        s = torch.clamp(torch.amax(torch.stack([
            torch.amax(torch.abs(bx), dim=-1), torch.amax(torch.abs(by), dim=-1),
            torch.amax(torch.abs(bc), dim=-1)], dim=-1), dim=-1), min=1e-20)
        s = s[..., None]
        return bx / s, by / s, bc / s

    kx, ky, kc = row_pair(_ROW_E, _ROW_F)
    lx, ly, lc = row_pair(_ROW_G, _ROW_H)
    mx, my, mc = row_pair(_ROW_I, _ROW_J)

    # det B evaluated directly per probe point (an expanded degree-10
    # coefficient vector loses roots to f32 cancellation), bounded via
    # z = tan(a) with cos(a)^4 row scaling
    def detB_at(aa):
        z, c = torch.tan(aa), torch.cos(aa)
        c4 = (c * c) ** 2

        def ev(p):
            return _horner(p, z) * c4

        e11, e12, e13 = ev(kx), ev(ky), ev(kc)
        e21, e22, e23 = ev(lx), ev(ly), ev(lc)
        e31, e32, e33 = ev(mx), ev(my), ev(mc)
        return (e11 * (e22 * e33 - e23 * e32)
                - e12 * (e21 * e33 - e23 * e31)
                + e13 * (e21 * e32 - e22 * e31))

    z_roots, valid = _scan_real_roots(detB_at, dt, dev)             # (..., 10)
    # extra multi-start seeds on a fixed z-grid for samples whose f32
    # coefficient cascade left the scan with few brackets
    z_extra = torch.tan(_table("seeds", dt, dev))
    z_roots = torch.cat([z_roots, z_extra.expand(z_roots.shape[:-1] + (6,))], -1)
    valid = torch.cat([valid, torch.ones(valid.shape[:-1] + (6,), dtype=torch.bool,
                                         device=dev)], -1)

    # x, y per root: least squares over the three rows of B(z) [x y 1]^T = 0
    a11, a12, b1 = _horner(kx, z_roots), _horner(ky, z_roots), -_horner(kc, z_roots)
    a21, a22, b2 = _horner(lx, z_roots), _horner(ly, z_roots), -_horner(lc, z_roots)
    a31, a32, b3 = _horner(mx, z_roots), _horner(my, z_roots), -_horner(mc, z_roots)
    h11 = a11 * a11 + a21 * a21 + a31 * a31
    h12 = a11 * a12 + a21 * a22 + a31 * a32
    h22 = a12 * a12 + a22 * a22 + a32 * a32
    g1 = a11 * b1 + a21 * b2 + a31 * b3
    g2 = a12 * b1 + a22 * b2 + a32 * b3
    det = h11 * h22 - h12 * h12
    det = torch.where(torch.abs(det) < 1e-20, torch.full_like(det, 1e-20), det)
    x_sol = (h22 * g1 - h12 * g2) / det
    y_sol = (h11 * g2 - h12 * g1) / det

    # Gauss-Newton polish of (x, y, z) on the unscaled cubic constraints
    # r(v) = M0 @ mono3(v) (every candidate already satisfies the 5 data
    # equations; what f32 loses is essentiality)
    M0u = M0[..., None, :, :]                                       # (..., 1, 10, 20)
    eye3 = torch.eye(3, dtype=dt, device=dev)
    v = torch.stack([x_sol, y_sol, z_roots], dim=-1)                # (..., 16, 3)
    for _ in range(12):
        m, dm = _mono3_and_grad(v)
        r = (M0u @ m[..., None])[..., 0]                            # (..., 16, 10)
        J = M0u @ dm                                                # (..., 16, 10, 3)
        H = J.transpose(-1, -2) @ J + 1e-10 * eye3
        g = (J.transpose(-1, -2) @ r[..., None])[..., 0]
        v = v - smallalg.solve_spd(H, g)
    x_sol, y_sol, z_fin = v[..., 0], v[..., 1], v[..., 2]

    bx = lambda k: basis[..., None, k, :, :]                        # noqa: E731
    Es = (x_sol[..., None, None] * bx(0) + y_sol[..., None, None] * bx(1)
          + z_fin[..., None, None] * bx(2) + bx(3))
    nrm = torch.sqrt(torch.sum(Es * Es, dim=(-2, -1), keepdim=True))
    Es = Es / torch.clamp(nrm, min=1e-12)
    # final validity is essentiality of the polished result: relative
    # constraint residual, scale-invariant (r is cubic in E's coefficients)
    m_fin, _ = _mono3_and_grad(v)
    r_fin = (M0u @ m_fin[..., None])[..., 0]
    row_scale = torch.linalg.norm(M0, dim=-1)[..., None, :]
    vmag = torch.clamp(torch.linalg.norm(v, dim=-1), min=1.0)
    rel = torch.linalg.norm(r_fin / row_scale, dim=-1) / vmag ** 3
    valid = (valid & torch.isfinite(z_fin) & (nrm[..., 0, 0] > 1e-9)
             & (rel < 3e-4))
    key = torch.where(valid, rel, torch.full_like(rel, float("inf")))
    order = torch.argsort(key, dim=-1, stable=True)[..., :_MAX_ROOTS]
    Es = torch.gather(Es, -3, order[..., None, None].expand(
        order.shape + (3, 3)))
    return Es, torch.gather(valid, -1, order)
