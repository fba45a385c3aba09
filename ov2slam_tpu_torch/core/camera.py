"""Camera models: pinhole (radtan) and fisheye (equidistant) (port of
``ov2slam_tpu/core/camera.py``, without the rectification-map precompute).

The calibration is a frozen dataclass of Python floats: every per-point
function below is batched tensor math on whatever device the points live
on, and the scalars enter each op as float32 constants, as the JAX package's
f32 device scalars do.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

PINHOLE = 0
FISHEYE = 1


@dataclass(frozen=True)
class Camera:
    """Static per-camera calibration. ``dist`` is (k1, k2, p1, p2) for
    pinhole, (k1..k4) for fisheye; ``roi_*`` bound the valid image area."""

    model: int
    width: int
    height: int
    fx: float
    fy: float
    cx: float
    cy: float
    dist: Tuple[float, float, float, float] = (0.0, 0.0, 0.0, 0.0)
    roi_x0: float = 0.0
    roi_y0: float = 0.0
    roi_x1: float = 0.0
    roi_y1: float = 0.0

    @staticmethod
    def make(model: str, fx, fy, cx, cy, dist, width, height) -> "Camera":
        m = PINHOLE if model.lower().startswith("pinhole") else FISHEYE
        f32 = lambda v: float(np.float32(v))   # noqa: E731 — f32 calibration
        return Camera(
            model=m, width=int(width), height=int(height),
            fx=f32(fx), fy=f32(fy), cx=f32(cx), cy=f32(cy),
            dist=tuple(f32(v) for v in np.asarray(dist).reshape(-1)[:4]),
            roi_x0=0.0, roi_y0=0.0,
            roi_x1=float(width), roi_y1=float(height))


# ---------------------------------------------------------------------------
# distortion models (normalized coords -> distorted normalized coords)
# ---------------------------------------------------------------------------

def distort_radtan(p: torch.Tensor, dist) -> torch.Tensor:
    """Radial-tangential (OpenCV k1 k2 p1 p2). p: (..., 2) normalized."""
    k1, k2, p1, p2 = dist
    x, y = p[..., 0], p[..., 1]
    r2 = x * x + y * y
    radial = 1.0 + k1 * r2 + k2 * r2 * r2
    xd = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    yd = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    return torch.stack([xd, yd], dim=-1)


def distort_equi(p: torch.Tensor, dist) -> torch.Tensor:
    """Equidistant fisheye (OpenCV fisheye / Kalibr pinhole-equi, k1..k4)."""
    k1, k2, k3, k4 = dist
    x, y = p[..., 0], p[..., 1]
    r = torch.sqrt(torch.clamp(x * x + y * y, min=1e-18))
    theta = torch.arctan(r)
    th2 = theta * theta
    theta_d = theta * (1.0 + th2 * (k1 + th2 * (k2 + th2 * (k3 + th2 * k4))))
    scale = torch.where(r > 1e-8, theta_d / r, torch.ones_like(r))
    return p * scale[..., None]


def _distort(cam: Camera, p: torch.Tensor) -> torch.Tensor:
    if cam.model == FISHEYE:
        return distort_equi(p, cam.dist)
    return distort_radtan(p, cam.dist)


def _undistort_iter(cam: Camera, pd: torch.Tensor, iters: int = 10
                    ) -> torch.Tensor:
    """Invert the distortion: Newton on theta (fisheye) or Gauss-Newton on
    the 2D distortion map (radtan), a fixed number of unrolled iterations."""
    if cam.model == FISHEYE:
        k1, k2, k3, k4 = cam.dist
        rd = torch.linalg.norm(pd, dim=-1)
        theta = rd
        for _ in range(iters):
            th2 = theta * theta
            f = theta * (1.0 + th2 * (k1 + th2 * (k2 + th2 * (k3 + th2 * k4)))) - rd
            df = 1.0 + th2 * (3 * k1 + th2 * (5 * k2 + th2 * (7 * k3 + th2 * 9 * k4)))
            theta = theta - f / torch.clamp(df, min=1e-6)
        scale = torch.where(rd > 1e-8, torch.tan(theta) / rd, torch.ones_like(rd))
        return pd * scale[..., None]

    k1, k2, p1, p2 = cam.dist
    p = pd
    for _ in range(iters):
        x, y = p[..., 0], p[..., 1]
        r2 = x * x + y * y
        radial = 1.0 + k1 * r2 + k2 * r2 * r2
        dradial = k1 + 2.0 * k2 * r2
        fx_ = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x) - pd[..., 0]
        fy_ = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y - pd[..., 1]
        j00 = radial + x * dradial * 2.0 * x + 2.0 * p1 * y + 6.0 * p2 * x
        j01 = x * dradial * 2.0 * y + 2.0 * p1 * x + 2.0 * p2 * y
        j10 = y * dradial * 2.0 * x + 2.0 * p2 * y + 2.0 * p1 * x
        j11 = radial + y * dradial * 2.0 * y + 6.0 * p1 * y + 2.0 * p2 * x
        det = j00 * j11 - j01 * j10
        det = torch.where(torch.abs(det) < 1e-12, torch.full_like(det, 1e-12), det)
        dx = (j11 * fx_ - j01 * fy_) / det
        dy = (-j10 * fx_ + j00 * fy_) / det
        p = torch.stack([x - dx, y - dy], dim=-1)
    return p


# ---------------------------------------------------------------------------
# projection API (reference: camera_calibration.hpp:59-81)
# ---------------------------------------------------------------------------

def _inv_z(z: torch.Tensor) -> torch.Tensor:
    return 1.0 / torch.where(torch.abs(z) < 1e-9, torch.full_like(z, 1e-9), z)


def project_cam_to_image(cam: Camera, x3d: torch.Tensor) -> torch.Tensor:
    """Camera-frame 3D point -> *undistorted* pixel coords (..., 3)->(..., 2)."""
    invz = _inv_z(x3d[..., 2])
    u = cam.fx * x3d[..., 0] * invz + cam.cx
    v = cam.fy * x3d[..., 1] * invz + cam.cy
    return torch.stack([u, v], dim=-1)


def project_cam_to_image_dist(cam: Camera, x3d: torch.Tensor) -> torch.Tensor:
    """Camera-frame 3D point -> *distorted/raw* pixel coords."""
    invz = _inv_z(x3d[..., 2])
    pdn = _distort(cam, x3d[..., :2] * invz[..., None])
    return torch.stack([cam.fx * pdn[..., 0] + cam.cx,
                        cam.fy * pdn[..., 1] + cam.cy], dim=-1)


def undistort_px(cam: Camera, px: torch.Tensor, iters: int = 10) -> torch.Tensor:
    """Raw pixel coords -> undistorted pixel coords (same K)."""
    pn = torch.stack([(px[..., 0] - cam.cx) / cam.fx,
                      (px[..., 1] - cam.cy) / cam.fy], dim=-1)
    pu = _undistort_iter(cam, pn, iters)
    return torch.stack([pu[..., 0] * cam.fx + cam.cx,
                        pu[..., 1] * cam.fy + cam.cy], dim=-1)


def bearing_from_undist_px(cam: Camera, unpx: torch.Tensor) -> torch.Tensor:
    """Undistorted pixel -> unit bearing vector (reference: frame.cpp:246-262)."""
    x = (unpx[..., 0] - cam.cx) / cam.fx
    y = (unpx[..., 1] - cam.cy) / cam.fy
    b = torch.stack([x, y, torch.ones_like(x)], dim=-1)
    return b / torch.linalg.norm(b, dim=-1, keepdim=True)


def bearing_from_px(cam: Camera, px: torch.Tensor, iters: int = 10) -> torch.Tensor:
    return bearing_from_undist_px(cam, undistort_px(cam, px, iters))


def in_image(cam: Camera, px: torch.Tensor, border: float = 0.0) -> torch.Tensor:
    """Valid-ROI test (reference: camera_calibration.cpp:72-75 ROI masks)."""
    u, v = px[..., 0], px[..., 1]
    return ((u >= cam.roi_x0 + border) & (u < cam.roi_x1 - border)
            & (v >= cam.roi_y0 + border) & (v < cam.roi_y1 - border))
