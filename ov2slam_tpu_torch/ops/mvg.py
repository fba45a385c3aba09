"""Multi-view geometry (port of the parts of ``ov2slam_tpu/ops/mvg.py`` the
keyframe mapper uses: midpoint triangulation and the epipolar check).

The essential-matrix and P3P RANSACs are not ported yet (ROADMAP queue A).
"""

from __future__ import annotations

import torch

from ov2slam_tpu_torch.core import lie
from ov2slam_tpu_torch.core.lie import SE3


def triangulate_midpoint(T_ab: SE3, bv_a: torch.Tensor, bv_b: torch.Tensor
                         ) -> torch.Tensor:
    """Midpoint triangulation in frame a (opengv triangulate2 semantics,
    reference: multi_view_geometry.cpp:53-136). T_ab is the b-to-a
    transform; bv_a/bv_b (..., 3) unit bearings. Returns (..., 3) in a."""
    r1 = bv_a
    r2 = torch.einsum("...ij,...j->...i", T_ab.R, bv_b)
    o2 = T_ab.t
    a = torch.sum(r1 * r1, dim=-1)
    b = -torch.sum(r1 * r2, dim=-1)
    c = torch.sum(r2 * r2, dim=-1)
    e1 = torch.sum(r1 * o2, dim=-1)
    e2 = -torch.sum(r2 * o2, dim=-1)
    det = a * c - b * b
    det = torch.where(torch.abs(det) < 1e-12, torch.full_like(det, 1e-12), det)
    d1 = (c * e1 - b * e2) / det
    d2 = (a * e2 - b * e1) / det
    return 0.5 * (r1 * d1[..., None] + o2 + r2 * d2[..., None])


def essential_from_pose(T_ab: SE3) -> torch.Tensor:
    """E such that bv_a^T E bv_b = 0, from the b-to-a transform."""
    t = T_ab.t
    tn = t / torch.clamp(torch.linalg.norm(t), min=1e-12)
    return lie.hat(tn) @ T_ab.R


def epipolar_line_dist(E: torch.Tensor, x_a: torch.Tensor, x_b: torch.Tensor
                       ) -> torch.Tensor:
    """Distance of x_a to the epipolar line E x_b (normalized coords)."""
    l = torch.einsum("ij,...j->...i", E, x_b)
    num = torch.abs(torch.sum(x_a * l, dim=-1))
    den = torch.sqrt(l[..., 0] ** 2 + l[..., 1] ** 2)
    return num / torch.clamp(den, min=1e-12)
