"""SO(3)/SE(3) Lie-group operations on batched torch tensors (port of
``ov2slam_tpu/core/lie.py``).

Conventions are the JAX package's: a pose is ``(R, t)`` with ``x_out = R x +
t``; se(3) tangents are ``(..., 6)`` ordered ``[upsilon, omega]``; the
left-multiplicative update ``exp(xi) T`` is the reference's SE(3)
parameterization (se3left_parametrization.hpp:39-73). Small-angle branches
use Taylor expansions selected with ``torch.where`` so both branches stay
finite. Quaternions are (x, y, z, w), Hamilton.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

_EPS = 1e-8


class SE3(NamedTuple):
    """Rigid transform: ``x_out = R @ x + t``. Batched over leading dims."""

    R: torch.Tensor  # (..., 3, 3)
    t: torch.Tensor  # (..., 3)

    def matrix(self) -> torch.Tensor:
        """(..., 4, 4) homogeneous matrix."""
        Rt = torch.cat([self.R, self.t[..., :, None]], dim=-1)
        bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=Rt.dtype,
                              device=Rt.device).expand(Rt.shape[:-2] + (1, 4))
        return torch.cat([Rt, bottom], dim=-2)

    @staticmethod
    def from_matrix(T: torch.Tensor) -> "SE3":
        return SE3(T[..., :3, :3], T[..., :3, 3])

    @staticmethod
    def identity(batch_shape: Tuple[int, ...] = (), dtype=torch.float32,
                 device=None) -> "SE3":
        R = torch.eye(3, dtype=dtype, device=device).expand(
            tuple(batch_shape) + (3, 3)).clone()
        t = torch.zeros(tuple(batch_shape) + (3,), dtype=dtype, device=device)
        return SE3(R, t)


def _mv(A: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Batched matrix-vector product (..., i, j) x (..., j) -> (..., i)."""
    return torch.einsum("...ij,...j->...i", A, x)


# ---------------------------------------------------------------------------
# so(3)
# ---------------------------------------------------------------------------

def hat(w: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (..., 3, 3) skew-symmetric matrix."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    zero = torch.zeros_like(wx)
    return torch.stack([
        torch.stack([zero, -wz, wy], dim=-1),
        torch.stack([wz, zero, -wx], dim=-1),
        torch.stack([-wy, wx, zero], dim=-1),
    ], dim=-2)


def vee(W: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) skew -> (..., 3)."""
    return torch.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], dim=-1)


def _sinc_cos_coeffs(theta2: torch.Tensor):
    """(A, B, C) = (sin th/th, (1-cos th)/th^2, (th - sin th)/th^3) with
    Taylor fallbacks for small angles."""
    small = theta2 < 1e-8
    th2s = torch.where(small, torch.ones_like(theta2), theta2)
    ths = torch.sqrt(th2s)
    A = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(ths) / ths)
    B = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(ths)) / th2s)
    C = torch.where(small, 1.0 / 6.0 - theta2 / 120.0,
                    (ths - torch.sin(ths)) / (th2s * ths))
    return A, B, C


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues formula: (..., 3) axis-angle -> (..., 3, 3) rotation."""
    theta2 = torch.sum(w * w, dim=-1)
    A, B, _ = _sinc_cos_coeffs(theta2)
    W = hat(w)
    I = torch.eye(3, dtype=w.dtype, device=w.device)
    return I + A[..., None, None] * W + B[..., None, None] * (W @ W)


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) rotation -> (..., 3) axis-angle. Safe near 0 and pi."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_theta = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
    theta = torch.arccos(cos_theta)
    sin_theta = torch.sin(theta)
    near_pi = cos_theta < -1.0 + 1e-6
    near_0 = sin_theta < 1e-6
    generic = ~(near_pi | (near_0 & (cos_theta > 0)))
    skew = vee(R - R.transpose(-1, -2))

    safe_sin = torch.where(near_0, torch.ones_like(sin_theta), sin_theta)
    w_generic = (theta / (2.0 * safe_sin))[..., None] * skew
    w_small = 0.5 * (1.0 + theta[..., None] ** 2 / 6.0) * skew

    # near pi: the columns of R + I are proportional to the axis
    S = R + torch.eye(3, dtype=R.dtype, device=R.device)
    col_norms = torch.linalg.norm(S, dim=-2)
    k = torch.argmax(col_norms, dim=-1)
    idx = k[..., None, None].expand(S.shape[:-1] + (1,))
    n = torch.gather(S, -1, idx)[..., 0]
    n = n / torch.clamp(torch.linalg.norm(n, dim=-1, keepdim=True), min=_EPS)
    w_pi = theta[..., None] * n

    return torch.where(generic[..., None], w_generic,
                       torch.where(near_pi[..., None], w_pi, w_small))


def so3_left_jacobian(w: torch.Tensor) -> torch.Tensor:
    """Left Jacobian J_l of SO(3)."""
    theta2 = torch.sum(w * w, dim=-1)
    _, B, C = _sinc_cos_coeffs(theta2)
    W = hat(w)
    I = torch.eye(3, dtype=w.dtype, device=w.device)
    return I + B[..., None, None] * W + C[..., None, None] * (W @ W)


# ---------------------------------------------------------------------------
# SE(3)
# ---------------------------------------------------------------------------

def se3_exp(xi: torch.Tensor) -> SE3:
    """(..., 6) tangent [upsilon, omega] -> SE3."""
    v, w = xi[..., :3], xi[..., 3:]
    return SE3(so3_exp(w), _mv(so3_left_jacobian(w), v))


def se3_log(T: SE3) -> torch.Tensor:
    """SE3 -> (..., 6) tangent [upsilon, omega]."""
    from ov2slam_tpu_torch.core import smallalg
    w = so3_log(T.R)
    v = _mv(smallalg.inv3(so3_left_jacobian(w)), T.t)
    return torch.cat([v, w], dim=-1)


def se3_inverse(T: SE3) -> SE3:
    Rt = T.R.transpose(-1, -2)
    return SE3(Rt, -_mv(Rt, T.t))


def se3_compose(A: SE3, B: SE3) -> SE3:
    """A o B (apply B first)."""
    return SE3(A.R @ B.R, _mv(A.R, B.t) + A.t)


def se3_apply(T: SE3, x: torch.Tensor) -> torch.Tensor:
    """Transform points ``x`` (..., 3). Broadcasts pose over point batches."""
    return _mv(T.R, x) + T.t


def se3_boxplus_left(T: SE3, xi: torch.Tensor) -> SE3:
    """Left-multiplicative update exp(xi) o T."""
    return se3_compose(se3_exp(xi), T)


def se3_adjoint(T: SE3) -> torch.Tensor:
    """(..., 6, 6) adjoint: Ad_T [v; w] = [Rv + t x Rw; Rw]."""
    R = T.R
    top = torch.cat([R, hat(T.t) @ R], dim=-1)
    bot = torch.cat([torch.zeros_like(R), R], dim=-1)
    return torch.cat([top, bot], dim=-2)


def se3_relative(A: SE3, B: SE3) -> SE3:
    """A^-1 o B."""
    return se3_compose(se3_inverse(A), B)


# ---------------------------------------------------------------------------
# quaternions (x, y, z, w), Hamilton
# ---------------------------------------------------------------------------

def quat_from_mat(R: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) -> (..., 4) quaternion (x, y, z, w), branch-free Shepperd."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22
    # four candidate quaternions (w, x, y, z), one per dominant component
    qw = torch.stack([1.0 + tr, m21 - m12, m02 - m20, m10 - m01], dim=-1)
    qx = torch.stack([m21 - m12, 1.0 + m00 - m11 - m22, m01 + m10, m02 + m20], dim=-1)
    qy = torch.stack([m02 - m20, m01 + m10, 1.0 + m11 - m00 - m22, m12 + m21], dim=-1)
    qz = torch.stack([m10 - m01, m02 + m20, m12 + m21, 1.0 + m22 - m00 - m11], dim=-1)
    cands = torch.stack([tr, m00 - m11 - m22, m11 - m00 - m22,
                         m22 - m00 - m11], dim=-1)
    idx = torch.argmax(cands, dim=-1)[..., None]
    q = torch.where(idx == 0, qw, torch.where(idx == 1, qx,
                                              torch.where(idx == 2, qy, qz)))
    q = q / torch.clamp(torch.linalg.norm(q, dim=-1, keepdim=True), min=_EPS)
    q = torch.where(q[..., :1] < 0, -q, q)      # canonical sign: w >= 0
    return torch.cat([q[..., 1:], q[..., :1]], dim=-1)


def mat_from_quat(q: torch.Tensor) -> torch.Tensor:
    """(..., 4) quaternion (x, y, z, w) -> (..., 3, 3)."""
    q = q / torch.clamp(torch.linalg.norm(q, dim=-1, keepdim=True), min=_EPS)
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    return torch.stack([
        torch.stack([1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)], dim=-1),
        torch.stack([2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)], dim=-1),
        torch.stack([2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)], dim=-1),
    ], dim=-2)


def se3_normalize(T: SE3) -> SE3:
    """Re-orthonormalize R via a quaternion round trip."""
    return SE3(mat_from_quat(quat_from_mat(T.R)), T.t)
