"""Camera models: pinhole (radtan) and fisheye (equidistant), undistortion
and rectification maps, Bouguet stereo rectification (port of
``ov2slam_tpu/core/camera.py``).

The calibration is a frozen dataclass of Python floats: every per-point
function below is batched tensor math on whatever device the points live
on, and the scalars enter each op as float32 constants, as the JAX package's
f32 device scalars do.
"""

from __future__ import annotations

import dataclasses
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


# ---------------------------------------------------------------------------
# undistortion / rectification maps and stereo rectification (setup time)
# ---------------------------------------------------------------------------

def compute_undist_rect_map(cam: Camera, R_rect=None, K_new=None,
                            device=None) -> torch.Tensor:
    """Remap grid of the rectified (or undistorted) image: for each output
    pixel, its (x, y) source in the raw image (cv::initUndistortRectifyMap;
    camera_calibration.cpp:80-131). R_rect (3, 3) rotates raw-camera rays
    into the rectified frame; K_new (3, 3) are the output intrinsics (cam's
    own by default). Returns (cam.height, cam.width, 2) float32 on
    `device`."""
    H, W = cam.height, cam.width
    if K_new is None:
        fxn, fyn, cxn, cyn = cam.fx, cam.fy, cam.cx, cam.cy
    else:
        Kn = np.asarray(K_new, np.float32)
        fxn, fyn, cxn, cyn = (float(Kn[0, 0]), float(Kn[1, 1]),
                              float(Kn[0, 2]), float(Kn[1, 2]))
    us = torch.arange(W, dtype=torch.float32, device=device)
    vs = torch.arange(H, dtype=torch.float32, device=device)
    vv, uu = torch.meshgrid(vs, us, indexing="ij")               # (H, W)
    x = (uu - cxn) / fxn
    y = (vv - cyn) / fyn
    p = torch.stack([x, y, torch.ones_like(x)], dim=-1)           # (H, W, 3)
    if R_rect is not None:
        Rt = torch.as_tensor(np.asarray(R_rect, np.float32).T, device=device)
        p = torch.einsum("ij,hwj->hwi", Rt, p)
    pdn = _distort(cam, p[..., :2] / p[..., 2:3])
    return torch.stack([cam.fx * pdn[..., 0] + cam.cx,
                        cam.fy * pdn[..., 1] + cam.cy], dim=-1)


def _rodrigues_log(Rm: np.ndarray) -> np.ndarray:
    ct = np.clip((np.trace(Rm) - 1.0) * 0.5, -1.0, 1.0)
    th = np.arccos(ct)
    if th < 1e-10:
        return np.zeros(3)
    v = np.array([Rm[2, 1] - Rm[1, 2], Rm[0, 2] - Rm[2, 0], Rm[1, 0] - Rm[0, 1]])
    return th / (2.0 * np.sin(th)) * v


def _rodrigues_exp(w: np.ndarray) -> np.ndarray:
    th = np.linalg.norm(w)
    Wm = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])
    if th < 1e-10:
        return np.eye(3) + Wm
    return (np.eye(3) + np.sin(th) / th * Wm
            + (1.0 - np.cos(th)) / (th * th) * (Wm @ Wm))


def stereo_rectify(cam_l: Camera, cam_r: Camera, R_rl, t_rl):
    """Bouguet stereo rectification (what the reference takes from
    cv::stereoRectify; camera_calibration.cpp setUndistStereoMap,
    ov2slam.cpp:342-425), in float64 on the host. R_rl, t_rl: the
    right-from-left extrinsic (x_r = R x_l + t). Returns (R_rect_l,
    R_rect_r, K_new, fx * baseline): the two rectifying rotations, the
    shared intrinsics (mean fy, principal point at the image centre) and
    the baseline in pixels. The presets' `alpha` (cv::stereoRectify's free
    scaling) has no counterpart: the JAX package ignores it too."""
    R = np.asarray(R_rl, np.float64)
    t = np.asarray(t_rl, np.float64)
    # split the relative rotation evenly between the two cameras
    w = _rodrigues_log(R)
    R_half_r = _rodrigues_exp(-w / 2.0)
    R_half_l = _rodrigues_exp(w / 2.0)
    t_new = R_half_r @ t
    # rectifying basis: e1 along the baseline, pointing to +x
    e1 = t_new / np.linalg.norm(t_new)
    if abs(t_new[0]) >= abs(t_new[1]) and e1[0] < 0:
        e1 = -e1
    e2 = np.array([-e1[1], e1[0], 0.0])
    nrm = np.linalg.norm(e2)
    e2 = np.array([0.0, 1.0, 0.0]) if nrm < 1e-12 else e2 / nrm
    Rw = np.stack([e1, e2, np.cross(e1, e2)], axis=0)
    fx = 0.5 * (cam_l.fy + cam_r.fy)
    K_new = np.array([[fx, 0.0, cam_l.width / 2.0],
                      [0.0, fx, cam_l.height / 2.0],
                      [0.0, 0.0, 1.0]], np.float64)
    return Rw @ R_half_l, Rw @ R_half_r, K_new, fx * float(np.linalg.norm(t))


def camera_with_intrinsics(cam: Camera, K_new, zero_dist: bool = False
                           ) -> Camera:
    """The camera with replaced working intrinsics (the rectified or
    undistorted view), its distortion zeroed on request."""
    K = np.asarray(K_new)
    f32 = lambda v: float(np.float32(v))   # noqa: E731 — f32 calibration
    return dataclasses.replace(
        cam, fx=f32(K[0, 0]), fy=f32(K[1, 1]), cx=f32(K[0, 2]),
        cy=f32(K[1, 2]),
        dist=(0.0, 0.0, 0.0, 0.0) if zero_dist else cam.dist)


def with_rect_roi(cam: Camera, grid) -> Camera:
    """The camera with its ROI set to the inner rectangle of remap-grid
    sources that land inside the raw image (cv::stereoRectify validPixROI,
    the reference's ROI masks, camera_calibration.cpp:72-75). Host numpy
    over the (H, W, 2) grid, once at setup."""
    g = np.asarray(grid.cpu() if isinstance(grid, torch.Tensor) else grid)
    Hs = g.shape[0]
    v = ((g[..., 0] >= 0) & (g[..., 0] <= cam.width - 1)
         & (g[..., 1] >= 0) & (g[..., 1] <= cam.height - 1))
    rows = np.where(v.mean(axis=1) > 0.5)[0]
    if len(rows) == 0:
        return cam
    y0, y1 = int(rows[0]), int(rows[-1]) + 1
    sub = v[y0:y1]
    first = np.argmax(sub, axis=1)
    last = sub.shape[1] - 1 - np.argmax(sub[:, ::-1], axis=1)
    x0, x1 = int(first.max()), int(last.min()) + 1
    fully = v[:, x0:x1].all(axis=1) if x1 > x0 else np.zeros(Hs, bool)
    ys = np.where(fully)[0]
    if len(ys):
        y0, y1 = int(ys[0]), int(ys[-1]) + 1
    return dataclasses.replace(cam, roi_x0=float(x0), roi_y0=float(y0),
                               roi_x1=float(x1), roi_y1=float(y1))
