"""Multi-view geometry: triangulation, epipolar distances, the batched
essential-matrix and P3P RANSACs (port of ``ov2slam_tpu/ops/mvg.py``).

Replaces the reference's MultiViewGeometry (multi_view_geometry.cpp:53-837)
and its OpenGV backend (Kneip P3P, Nister 5-point, triangulate2, RANSAC).
RANSAC is a fixed batch of K hypotheses from a batched minimal solver, all
scored against all N correspondences at once ((K, N) error matrix), then a
re-fit and a Gauss-Newton polish of the winner. No step reads the device
back to the host: the winner is picked with ``device.select``, and the
constant tables are made on the device once.

Sampling: ``jax.random.choice(key, N, (K, s), p=valid / sum)`` draws with
replacement from the valid entries; the port draws the same distribution
with ``torch.multinomial`` from a ``torch.Generator`` (``draw_samples``).
Both RANSACs take that (K, s) index tensor, so a test can hand both
packages the same draw.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ov2slam_tpu_torch.core import lie, smallalg
from ov2slam_tpu_torch.core.lie import SE3
from ov2slam_tpu_torch.device import select
from ov2slam_tpu_torch.ops import fivepoint


def _fma(x: torch.Tensor, y: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """x * y + z rounded once to float32, a fused multiply-add: float64
    holds the product of two float32 values exactly."""
    return torch.addcmul(z.double(), x.double(), y.double()).float()


def _dot3(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """sum_k u_k v_k over the last axis (3) as a chain of fused
    multiply-adds from u_0 v_0."""
    acc = u[..., 0] * v[..., 0]
    acc = _fma(u[..., 1], v[..., 1], acc)
    return _fma(u[..., 2], v[..., 2], acc)


def triangulate_midpoint(T_ab: SE3, bv_a: torch.Tensor, bv_b: torch.Tensor
                         ) -> torch.Tensor:
    """Midpoint triangulation in frame a (opengv triangulate2 semantics,
    reference: multi_view_geometry.cpp:53-136). T_ab is the b-to-a
    transform; bv_a/bv_b (..., 3) unit bearings. Returns (..., 3) in a.

    The 2x2 normal equations cancel: their determinant is about the
    squared ray angle (2e-4 for a 0.11 m baseline at 8 m), so one float32
    rounding in it moves a depth by up to 0.3%. The function therefore
    rounds as the JAX package's compiled one does on the CPU, where XLA
    fuses each multiply into the add or subtract that takes it: dot
    products as chains of fused multiply-adds, the determinant and both
    numerators with one product fused, the output as two fused steps.
    From the same inputs the two packages then give the same points, bit
    for bit (``tests/test_torch_mvg.py``).

    Each fused step goes through float64, so a call takes several times
    the device operations of a float64 solve of the whole system (one cast
    in, one out). That solve would put the points nearer the truth, and the
    CPU parity tests pass with it; but it moves the trajectories on the card
    by as much as any last-bit change does (ROADMAP C/R6), and on an
    NVIDIA H100 it put ``accurate_stereo_nolc`` past the ATE bound the
    smoke holds it to (``PERF.md`` §6). The port keeps the reference's
    rounding until the reference's own triangulation changes (ROADMAP
    C/P1)."""
    r1 = bv_a
    r2 = torch.stack([_dot3(T_ab.R[..., i, :], bv_b) for i in range(3)], -1)
    o2 = T_ab.t
    a = _dot3(r1, r1)
    b = -_dot3(r1, r2)
    c = _dot3(r2, r2)
    e1 = _dot3(r1, o2)
    e2 = -_dot3(r2, o2)
    det = _fma(a, c, -(b * b))
    det = torch.where(torch.abs(det) < 1e-12, torch.full_like(det, 1e-12), det)
    d1 = _fma(c, e1, -(b * e2)) / det
    d2 = _fma(-b, e1, a * e2) / det
    return 0.5 * _fma(r1, d1[..., None], _fma(r2, d2[..., None], o2))


def essential_from_pose(T_ab: SE3) -> torch.Tensor:
    """E such that bv_a^T E bv_b = 0, from the b-to-a transform."""
    t = T_ab.t
    tn = t / torch.clamp(torch.linalg.norm(t, dim=-1, keepdim=True), min=1e-12)
    return lie.hat(tn) @ T_ab.R


def fundamental_from_poses(K_a: torch.Tensor, K_b: torch.Tensor, T_ab: SE3
                           ) -> torch.Tensor:
    """F for raw pixels: px_a^T F px_b = 0 (multi_view_geometry.hpp:118-125)."""
    E = lie.hat(T_ab.t) @ T_ab.R
    return torch.linalg.inv(K_a).T @ E @ torch.linalg.inv(K_b)


def epipolar_line_dist(E: torch.Tensor, x_a: torch.Tensor, x_b: torch.Tensor
                       ) -> torch.Tensor:
    """Distance of x_a to the epipolar line E x_b (normalized coords)."""
    l = torch.einsum("ij,...j->...i", E, x_b)
    num = torch.abs(torch.sum(x_a * l, dim=-1))
    den = torch.sqrt(l[..., 0] ** 2 + l[..., 1] ** 2)
    return num / torch.clamp(den, min=1e-12)


def sampson_dist(E: torch.Tensor, x_a: torch.Tensor, x_b: torch.Tensor
                 ) -> torch.Tensor:
    """Squared first-order geometric (Sampson) distance on normalized coords
    (MultiViewGeometry::computeSampsonDistance). E (..., 3, 3) broadcasts
    against points (N, 3): E (K, 3, 3) gives (K, N)."""
    Ex_b = torch.einsum("...ij,nj->...ni", E, x_b)
    Etx_a = torch.einsum("...ji,nj->...ni", E, x_a)
    num = torch.sum(x_a * Ex_b, dim=-1)
    den = (Ex_b[..., 0] ** 2 + Ex_b[..., 1] ** 2 + Etx_a[..., 0] ** 2
           + Etx_a[..., 1] ** 2)
    return num * num / torch.clamp(den, min=1e-12)


def _epipolar_rows(xa, ya, xb, yb, w):
    """Rows [xa xb, xa yb, xa, ya xb, ya yb, ya, xb, yb, 1] (w-weighted
    constant terms) of x_a^T E x_b = 0 for row-major vec(E)."""
    return torch.stack([xa * xb, xa * yb, xa * w, ya * xb, ya * yb, ya * w,
                        xb * w, yb * w, w], dim=-1)


def _eight_point(x_a: torch.Tensor, x_b: torch.Tensor) -> torch.Tensor:
    """Essential from >= 8 normalized correspondences (..., M, 3) each ->
    (..., 3, 3): the null vector of A^T A by Jacobi eigh, projected onto the
    essential manifold."""
    A = _epipolar_rows(x_a[..., 0], x_a[..., 1], x_b[..., 0], x_b[..., 1],
                       torch.ones_like(x_a[..., 0]))
    E = smallalg.smallest_eigvec(A.transpose(-1, -2) @ A)
    return smallalg.essential_project(E.reshape(E.shape[:-1] + (3, 3)))


def _pose_candidates(E: torch.Tensor):
    """The four (R, t) of E (..., 3, 3): ((..., 4, 3, 3), (..., 4, 3)) in the
    order (R1, t), (R1, -t), (R2, t), (R2, -t)."""
    u, _, vt = smallalg.svd3(E)
    d = torch.linalg.det(u) * torch.linalg.det(vt)
    vt = vt * torch.where(d < 0, -1.0, 1.0)[..., None, None]
    # u W and u W^T for W = [[0, -1, 0], [1, 0, 0], [0, 0, 1]]: the columns
    # the product with W's 0/1 entries gives, exactly
    u0, u1, u2 = u[..., :, 0], u[..., :, 1], u[..., :, 2]
    R1 = torch.stack([u1, -u0, u2], dim=-1) @ vt
    R2 = torch.stack([-u1, u0, u2], dim=-1) @ vt
    t = u[..., :, 2]
    return (torch.stack([R1, R1, R2, R2], dim=-3),
            torch.stack([t, -t, t, -t], dim=-2))


def _chirality_counts(Rs, ts, x_a, x_b, mask):
    """Points in front of both cameras for candidate poses Rs (..., 3, 3),
    ts (..., 3) against (N, 3) points; mask (..., N). Returns (...,)."""
    T = SE3(Rs[..., None, :, :], ts[..., None, :])
    X_a = triangulate_midpoint(T, x_a, x_b)
    X_b = torch.einsum("...ji,...j->...i", T.R, X_a - T.t)
    return torch.sum((X_a[..., 2] > 0) & (X_b[..., 2] > 0) & mask, dim=-1)


def decompose_essential(E: torch.Tensor, x_a: torch.Tensor, x_b: torch.Tensor,
                        mask: torch.Tensor) -> SE3:
    """The (R, t) with the most points in front of both cameras
    (cv::recoverPose semantics). Returns T_ab with |t| = 1."""
    Rs, ts = _pose_candidates(E)
    k = torch.argmax(_chirality_counts(Rs, ts, x_a, x_b, mask))
    return SE3(select(Rs, k), select(ts, k))


def refine_essential_pose(T: SE3, x_a: torch.Tensor, x_b: torch.Tensor,
                          w: torch.Tensor, iters: int = 8) -> SE3:
    """Gauss-Newton on weighted Sampson residuals of a relative pose (the
    gold-standard polish after RANSAC; the reference relies on OpenGV's
    refine flag, multi_view_geometry.cpp:214-216). T is b-to-a; |t| is
    renormalized each step. The Jacobian is forward-mode
    (``torch.func.jacfwd``, as the JAX package's ``jax.jacfwd``)."""

    def sampson_resid(R, t):
        tn = t / torch.clamp(torch.linalg.norm(t), min=1e-12)
        E = lie.hat(tn) @ R
        Ex_b = x_b @ E.T
        Etx_a = x_a @ E
        num = torch.sum(x_a * Ex_b, dim=-1)
        den = (Ex_b[:, 0] ** 2 + Ex_b[:, 1] ** 2
               + Etx_a[:, 0] ** 2 + Etx_a[:, 1] ** 2)
        return num / torch.sqrt(torch.clamp(den, min=1e-18)) * w

    def resid_first_order(xi, R, t):
        # exp(xi) o T to first order in xi = [v, w]: (I + [w]x) R and
        # t + v + [w]x t, whose derivative at xi = 0 is that of the exact
        # update (torch.func's forward mode promotes the exact form's
        # small-angle branches to float64)
        W = lie.hat(xi[3:])
        return sampson_resid(R + W @ R, t + xi[:3] + W @ t)

    jac = torch.func.jacfwd(resid_first_order)
    R, t = T.R, T.t
    z = torch.zeros(6, dtype=x_a.dtype, device=x_a.device)
    eye6 = torch.eye(6, dtype=x_a.dtype, device=x_a.device)
    for _ in range(iters):
        r = sampson_resid(R, t)
        J = jac(z, R, t)                                  # (N, 6)
        H = J.T @ J + 1e-9 * eye6
        g = J.T @ r
        Tn = lie.se3_boxplus_left(SE3(R, t), -smallalg.solve_spd(H, g))
        R, t = Tn.R, Tn.t / torch.clamp(torch.linalg.norm(Tn.t), min=1e-12)
    return SE3(R, t)


class RansacResult(NamedTuple):
    model: torch.Tensor       # best model params
    inliers: torch.Tensor     # (N,) bool
    n_inliers: torch.Tensor   # scalar
    success: torch.Tensor     # scalar bool


def draw_samples(valid: torch.Tensor, n_hyps: int, size: int,
                 gen: Optional[torch.Generator] = None) -> torch.Tensor:
    """(n_hyps, size) int64 indices drawn with replacement from the valid
    entries (the distribution of ``jax.random.choice(key, N, (n_hyps,
    size), p=valid / sum)``). With no valid entry every index is equally
    likely: the callers' scoring masks by ``valid``, so such a draw only
    yields a failed result, as the JAX package's does."""
    p = valid.to(torch.float32)
    p = torch.where(torch.any(valid), p, torch.ones_like(p))
    idx = torch.multinomial(p, n_hyps * size, replacement=True, generator=gen)
    return idx.view(n_hyps, size)


def essential_ransac(
    bv_a: torch.Tensor,       # (N, 3) unit bearings in frame a
    bv_b: torch.Tensor,       # (N, 3)
    valid: torch.Tensor,      # (N,) bool
    err_th: float,            # Sampson threshold on normalized coords
    idx: torch.Tensor,        # (K, 5 or 8) sample indices (draw_samples)
    solver: str = "nister",
    lmeds: bool = False,
) -> RansacResult:
    """Batched essential-matrix RANSAC (reference: 5-pt Nister RANSAC,
    multi_view_geometry.cpp:600-771): K minimal-solver hypotheses, joint
    (K*, N) Sampson scoring, best-model inlier re-fit and manifold polish.

    solver="nister" runs the 5-point solver (up to 10 models per sample,
    safe on planar scenes); "8pt" the linear 8-point solver. lmeds=True
    scores by the median squared Sampson error (use_lmeds,
    multi_view_geometry.cpp:144-380); the inlier set still uses err_th.
    One hypothesis per row of idx."""
    dt = bv_a.dtype
    x_a = bv_a / torch.clamp(torch.abs(bv_a[..., 2:3]), min=1e-9)
    x_b = bv_b / torch.clamp(torch.abs(bv_b[..., 2:3]), min=1e-9)
    if solver == "nister":
        Es, oks = fivepoint.five_point_essential(x_a[idx], x_b[idx])
        Es, oks = Es.reshape(-1, 3, 3), oks.reshape(-1)
    else:
        Es = _eight_point(x_a[idx], x_b[idx])
        oks = torch.ones(Es.shape[0], dtype=torch.bool, device=Es.device)

    errs = sampson_dist(Es, x_a, x_b)                                # (K*, N)
    inl = (errs < err_th * err_th) & valid[None, :] & oks[:, None]
    counts = torch.sum(inl, dim=1)
    if lmeds:
        # median of the squared errors over the valid correspondences
        # (invalid ones padded with +inf sort to the tail)
        n_valid = torch.sum(valid)
        srt = torch.sort(torch.where(valid[None, :], errs,
                                     torch.full_like(errs, float("inf"))),
                         dim=1).values
        med = select(srt.T, torch.clamp(n_valid // 2, min=1))
        med = torch.where(oks, med, torch.full_like(med, float("inf")))
        k = torch.argmin(med)
    else:
        # most inliers, then the lowest mean inlier error (bounded < 1)
        mean_err = (torch.sum(torch.where(inl, errs, torch.zeros_like(errs)), dim=1)
                    / torch.clamp(counts, min=1))
        val = counts.to(dt) - mean_err / (1.0 + mean_err)
        val = torch.where(oks, val, torch.full_like(val, float("-inf")))
        # among near-tie top models pick by (chirality count, smaller
        # rotation angle): the twisted pair and the planar two-fold
        # ambiguity (see the JAX package). jax.lax.top_k prefers the lower
        # index on ties, as a stable descending sort does.
        top_val, top_idx = torch.sort(val, descending=True, stable=True)
        top_val, top_idx = top_val[:8], top_idx[:8]
        Rs, ts = _pose_candidates(Es[top_idx])                      # (8, 4, ...)
        cs = _chirality_counts(Rs, ts, x_a, x_b, inl[top_idx][:, None, :])
        b = torch.argmax(cs, dim=1)
        Rbest = torch.where((b < 2)[:, None, None], Rs[:, 0], Rs[:, 2])
        tr = Rbest[:, 0, 0] + Rbest[:, 1, 1] + Rbest[:, 2, 2]
        ang = torch.arccos(torch.clamp((tr - 1.0) * 0.5, -1.0, 1.0))
        chir = torch.amax(cs, dim=1)
        near = top_val >= top_val[0] - 1.0
        score = chir.to(dt) * 100.0 - ang + top_val * 1e-4
        j = torch.argmax(torch.where(near, score,
                                     torch.full_like(score, float("-inf"))))
        k = select(top_idx, j)
    best_inl = select(inl, k)
    E_k, n_k = select(Es, k), select(counts, k)

    # linear re-fit on the best inlier set (masked rows are zero rows)
    w = best_inl.to(dt)
    A = _epipolar_rows(x_a[:, 0] * w, x_a[:, 1] * w, x_b[:, 0] * w,
                       x_b[:, 1] * w, w)
    E_best = smallalg.essential_project(
        smallalg.smallest_eigvec(A.T @ A).reshape(3, 3))
    inl_best = (sampson_dist(E_best, x_a, x_b) < err_th * err_th) & valid
    n_in = torch.sum(inl_best)

    # manifold polish of the winner's chirality-correct pose
    T_gn = decompose_essential(E_k, x_a, x_b, best_inl)
    T_gn = refine_essential_pose(T_gn, x_a, x_b, w)
    E_gn = lie.hat(T_gn.t) @ T_gn.R
    inl_gn = (sampson_dist(E_gn, x_a, x_b) < err_th * err_th) & valid
    n_gn = torch.sum(inl_gn)

    # the polish wins at equal count; the linear re-fit only by strictly
    # adding inliers (on planar scenes the degenerate 8-pt family scores
    # every point an inlier)
    use_gn = n_gn >= n_k
    E_mid = torch.where(use_gn, E_gn, E_k)
    inl_mid = torch.where(use_gn, inl_gn, best_inl)
    n_mid = torch.where(use_gn, n_gn, n_k)
    use_refit = n_in > n_mid
    n_fin = torch.maximum(n_in, n_mid)
    return RansacResult(torch.where(use_refit, E_best, E_mid),
                        torch.where(use_refit, inl_best, inl_mid),
                        n_fin, n_fin >= 8)


# ---------------------------------------------------------------------------
# P3P (Grunert) + PnP RANSAC
# ---------------------------------------------------------------------------

def _solve_quartic(c4, c3, c2, c1, c0):
    """Closed-form (Ferrari) roots of c4 x^4 + ... + c0 = 0 in complex64,
    with three complex Newton steps. Returns (..., 4) complex roots."""
    c4 = torch.where(torch.abs(c4) < 1e-12, torch.full_like(c4, 1e-12), c4)
    a, b, c, d = c3 / c4, c2 / c4, c1 / c4, c0 / c4
    # depressed quartic y^4 + p y^2 + q y + r, x = y - a/4
    p = b - 3.0 * a * a / 8.0
    q = c - a * b / 2.0 + a * a * a / 8.0
    r = d - a * c / 4.0 + a * a * b / 16.0 - 3.0 * a ** 4 / 256.0
    cplx = lambda v: v.to(torch.complex64)                # noqa: E731
    p_, q_, r_ = cplx(p), cplx(q), cplx(r)

    # resolvent cubic m^3 + p m^2 + (p^2/4 - r) m - q^2/8 = 0: one root
    b2 = p_
    b1 = p_ * p_ / 4.0 - r_
    b0 = -q_ * q_ / 8.0
    pp = b1 - b2 * b2 / 3.0
    qq = 2.0 * b2 ** 3 / 27.0 - b2 * b1 / 3.0 + b0
    disc = (qq / 2.0) ** 2 + (pp / 3.0) ** 3
    sq = torch.sqrt(disc)
    # the cube-root branch of larger magnitude (no cancellation)
    u3a, u3b = -qq / 2.0 + sq, -qq / 2.0 - sq
    u3 = torch.where(torch.abs(u3a) >= torch.abs(u3b), u3a, u3b)
    u = u3 ** (1.0 / 3.0)
    u = torch.where(torch.abs(u) < 1e-12, torch.full_like(u, 1e-12), u)
    m = u - pp / (3.0 * u) - b2 / 3.0

    m = torch.where(torch.abs(m) < 1e-10, m + 1e-10, m)
    sqrt2m = torch.sqrt(2.0 * m)
    t1 = -(2.0 * p_ + 2.0 * m)
    t2 = 2.0 * q_ / sqrt2m
    s1, s2 = torch.sqrt(t1 - t2), torch.sqrt(t1 + t2)
    roots = torch.stack([(sqrt2m + s1) / 2.0, (sqrt2m - s1) / 2.0,
                         (-sqrt2m + s2) / 2.0, (-sqrt2m - s2) / 2.0], dim=-1)
    roots = roots - cplx(a / 4.0)[..., None]

    # complex Newton polish against the original quartic
    k4, k3, k2, k1, k0 = (cplx(v)[..., None] for v in (c4, c3, c2, c1, c0))
    for _ in range(3):
        f = (((k4 * roots + k3) * roots + k2) * roots + k1) * roots + k0
        df = ((4.0 * k4 * roots + 3.0 * k3) * roots + 2.0 * k2) * roots + k1
        df = torch.where(torch.abs(df) < 1e-12, torch.full_like(df, 1e-12), df)
        roots = roots - f / df
    return roots


def p3p_grunert(X: torch.Tensor, bv: torch.Tensor) -> Tuple[SE3, torch.Tensor]:
    """P3P: world points X (..., 3, 3), unit bearings bv (..., 3, 3) -> up
    to 8 candidate world-to-cam poses (4 quartic roots x 2 depth signs) as
    SE3 (..., 8) with validity (..., 8). Depth-ratio quartic by resultant
    elimination of the law-of-cosines constraints (the problem OpenGV's
    KneipP3P solves, multi_view_geometry.cpp:144-380)."""
    dt = X.dtype
    # normalize scene scale for f32 conditioning (depths scale linearly)
    centroid = torch.mean(X, dim=-2, keepdim=True)
    scl = torch.clamp(torch.sqrt(torch.mean(torch.sum((X - centroid) ** 2, dim=-1),
                                            dim=-1)), min=1e-9)
    X = X / scl[..., None, None]
    A, B, C = X[..., 0, :], X[..., 1, :], X[..., 2, :]
    a2 = torch.sum((B - C) ** 2, dim=-1)
    b2 = torch.sum((C - A) ** 2, dim=-1)
    c2 = torch.sum((A - B) ** 2, dim=-1)
    p = torch.sum(bv[..., 1, :] * bv[..., 2, :], dim=-1)
    q = torch.sum(bv[..., 2, :] * bv[..., 0, :], dim=-1)
    r = torch.sum(bv[..., 0, :] * bv[..., 1, :], dim=-1)

    G4 = a2 * (-a2 + 2 * b2 + 2 * c2) + 4 * b2 * c2 * p ** 2 + b2 * (-b2 - 2 * c2) - c2 ** 2
    G3 = p * (-8 * b2 * c2 * p * r + q * (-4 * a2 * c2 - 4 * b2 * c2 + 4 * c2 ** 2)) \
        + r * (a2 * (4 * a2 - 8 * b2 - 4 * c2) + b2 * (4 * b2 + 4 * c2))
    G2 = a2 * (-2 * a2 + 4 * b2) - 2 * b2 ** 2 + 2 * c2 ** 2 \
        + p * (p * (4 * b2 * c2 - 4 * c2 ** 2) + q * r * (8 * a2 * c2 + 8 * b2 * c2)) \
        + q ** 2 * (4 * a2 * c2 - 4 * c2 ** 2) \
        + r ** 2 * (a2 * (-4 * a2 + 8 * b2) - 4 * b2 ** 2)
    G1 = -8 * a2 * c2 * q ** 2 * r + p * q * (-4 * a2 * c2 - 4 * b2 * c2 + 4 * c2 ** 2) \
        + r * (a2 * (4 * a2 - 8 * b2 + 4 * c2) + b2 * (4 * b2 - 4 * c2))
    G0 = 4 * a2 * c2 * q ** 2 + a2 * (-a2 + 2 * b2 - 2 * c2) + b2 * (-b2 + 2 * c2) - c2 ** 2

    scale = torch.maximum(torch.abs(G4), torch.clamp(torch.abs(G0), min=1e-12))
    G4n, G3n, G2n, G1n, G0n = (G / scale for G in (G4, G3, G2, G1, G0))
    roots = _solve_quartic(G4n, G3n, G2n, G1n, G0n)
    real = torch.abs(roots.imag) < 1e-3 * torch.clamp(torch.abs(roots.real), min=1.0)
    u = roots.real                                        # (..., 4)
    G4n, G3n, G2n, G1n, G0n = (G[..., None] for G in (G4n, G3n, G2n, G1n, G0n))
    for _ in range(3):
        f = (((G4n * u + G3n) * u + G2n) * u + G1n) * u + G0n
        df = ((4.0 * G4n * u + 3.0 * G3n) * u + 2.0 * G2n) * u + G1n
        u = u - f / torch.where(torch.abs(df) < 1e-9, torch.full_like(df, 1e-9), df)

    p, q, r, a2, b2, c2 = (v[..., None] for v in (p, q, r, a2, b2, c2))
    den = 1.0 + u * u - 2.0 * u * r
    s1 = torch.sqrt(c2 / torch.clamp(den, min=1e-12))
    s2 = u * s1
    # v = s3/s1 from 1 + v^2 - 2 v q = b2/s1^2
    disc = q * q - (1.0 - b2 / torch.clamp(s1 * s1, min=1e-12))
    sqd = torch.sqrt(torch.clamp(disc, min=0.0))
    ok_root = real & (den > 1e-12) & (disc >= 0) & (s1 > 0) & (s2 > 0)
    s1a, s2a = torch.cat([s1, s1], -1), torch.cat([s2, s2], -1)
    s3a = torch.cat([(q + sqd) * s1, (q - sqd) * s1], -1)
    ok_all = torch.cat([ok_root, ok_root], -1)            # (..., 8)

    # Gauss-Newton polish of the depths on the three constraints
    eye3 = torch.eye(3, dtype=dt, device=X.device)
    for _ in range(4):
        f1 = s1a * s1a + s2a * s2a - 2.0 * s1a * s2a * r - c2
        f2 = s2a * s2a + s3a * s3a - 2.0 * s2a * s3a * p - a2
        f3 = s1a * s1a + s3a * s3a - 2.0 * s1a * s3a * q - b2
        z = torch.zeros_like(s1a)
        J = torch.stack([
            torch.stack([2 * s1a - 2 * s2a * r, 2 * s2a - 2 * s1a * r, z], -1),
            torch.stack([z, 2 * s2a - 2 * s3a * p, 2 * s3a - 2 * s2a * p], -1),
            torch.stack([2 * s1a - 2 * s3a * q, z, 2 * s3a - 2 * s1a * q], -1),
        ], -2)
        F = torch.stack([f1, f2, f3], -1)[..., None]
        Jt = J.transpose(-1, -2)
        step = smallalg.solve_spd(Jt @ J + 1e-9 * eye3, (Jt @ F)[..., 0])
        s1a, s2a, s3a = s1a - step[..., 0], s2a - step[..., 1], s3a - step[..., 2]

    e1 = torch.abs(s1a ** 2 + s2a ** 2 - 2 * s1a * s2a * r - c2)
    e2 = torch.abs(s2a ** 2 + s3a ** 2 - 2 * s2a * s3a * p - a2)
    e3 = torch.abs(s1a ** 2 + s3a ** 2 - 2 * s1a * s3a * q - b2)
    tol = 1e-3 * torch.maximum(a2, torch.maximum(b2, c2))
    ok_all = (ok_all & (s1a > 0) & (s2a > 0) & (s3a > 0)
              & (e1 < tol) & (e2 < tol) & (e3 < tol))

    # Procrustes per candidate: Pc = R X + t, quaternion method
    depths = torch.stack([s1a, s2a, s3a], dim=-1)         # (..., 8, 3)
    Pc = bv[..., None, :, :] * depths[..., None]          # (..., 8, 3, 3)
    Xs = X[..., None, :, :]
    cw = torch.mean(Xs, dim=-2)
    cc = torch.mean(Pc, dim=-2)
    M = (Pc - cc[..., None, :]).transpose(-1, -2) @ (Xs - cw[..., None, :])
    R = smallalg.procrustes_rotation(M)
    t = cc - torch.einsum("...ij,...j->...i", R, cw.expand(cc.shape))
    return SE3(R, t * scl[..., None, None]), ok_all


def refine_pose_gn(X: torch.Tensor, bv: torch.Tensor, weights: torch.Tensor,
                   T_init: SE3, iters: int = 8) -> SE3:
    """Gauss-Newton on normalized reprojection residuals of a world-to-cam
    pose, left-multiplicative SE(3) update; polishes RANSAC poses on their
    inlier sets."""
    obs = bv[:, :2] / torch.clamp(bv[:, 2:3], min=1e-9)
    eye6 = torch.eye(6, dtype=X.dtype, device=X.device)
    R, t = T_init.R, T_init.t
    for _ in range(iters):
        Xc = X @ R.T + t
        x, y, z = Xc[:, 0], Xc[:, 1], Xc[:, 2]
        iz = 1.0 / torch.where(torch.abs(z) < 1e-9, torch.full_like(z, 1e-9), z)
        r_u, r_v = x * iz - obs[:, 0], y * iz - obs[:, 1]
        w = weights * (z > 0.1)
        zeros = torch.zeros_like(x)
        du = torch.stack([iz, zeros, -x * iz * iz], dim=-1)
        dv = torch.stack([zeros, iz, -y * iz * iz], dim=-1)
        # dXc/dxi = [I | -hat(Xc)]
        Ju = torch.cat([du, torch.linalg.cross(Xc, du, dim=-1)], dim=-1)
        Jv = torch.cat([dv, torch.linalg.cross(Xc, dv, dim=-1)], dim=-1)
        Jw = torch.cat([Ju * w[:, None], Jv * w[:, None]], dim=0)
        rw = torch.cat([r_u * w, r_v * w], dim=0)
        dx = -smallalg.solve_spd(Jw.T @ Jw + 1e-8 * eye6, Jw.T @ rw)
        Tn = lie.se3_boxplus_left(SE3(R, t), dx)
        R, t = Tn.R, Tn.t
    return SE3(R, t)


def _p3p_inliers(R, t, X, bv, valid, err_th_norm):
    """Reprojection inliers (..., N) of poses R (..., 3, 3), t (..., 3)."""
    Xc = torch.einsum("...ij,nj->...ni", R, X) + t[..., None, :]
    z = Xc[..., 2]
    proj = Xc[..., :2] / torch.where(torch.abs(z) < 1e-9,
                                     torch.full_like(z, 1e-9), z)[..., None]
    obs = bv[:, :2] / torch.clamp(bv[:, 2:3], min=1e-9)
    err = torch.sum((proj - obs) ** 2, dim=-1)
    return (err < err_th_norm * err_th_norm) & (z > 0) & valid


def p3p_ransac(
    X: torch.Tensor,          # (N, 3) world points
    bv: torch.Tensor,         # (N, 3) unit bearings (current cam frame)
    valid: torch.Tensor,      # (N,) bool
    err_th_norm: float,       # reprojection threshold in normalized coords
    idx: torch.Tensor,        # (K, 3) sample indices (draw_samples)
) -> Tuple[SE3, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Batched P3P RANSAC -> world-to-cam pose (reference: p3pRansac,
    multi_view_geometry.cpp:144-460): every candidate of every sample scored
    on all correspondences, the winner polished by Gauss-Newton on its
    inliers. One hypothesis per row of idx.
    Returns (T_cw, inliers, n_inliers, success)."""
    Ts, oks = p3p_grunert(X[idx], bv[idx])                 # (K, 8)
    Rs, ts, oks = Ts.R.reshape(-1, 3, 3), Ts.t.reshape(-1, 3), oks.reshape(-1)
    inl = _p3p_inliers(Rs, ts, X, bv, valid, err_th_norm)  # (8K, N)
    counts = torch.sum(inl, dim=1) * oks.to(torch.int64)
    k = torch.argmax(counts)
    R_k, t_k, inl_k, n_k = (select(a, k) for a in (Rs, ts, inl, counts))
    T_ref = refine_pose_gn(X, bv, inl_k.to(X.dtype), SE3(R_k, t_k))
    inl_ref = _p3p_inliers(T_ref.R, T_ref.t, X, bv, valid, err_th_norm)
    n_ref = torch.sum(inl_ref)
    better = n_ref >= n_k
    n_fin = torch.maximum(n_ref, n_k)
    return (SE3(torch.where(better, T_ref.R, R_k),
                torch.where(better, T_ref.t, t_k)),
            torch.where(better, inl_ref, inl_k), n_fin, n_fin >= 5)
