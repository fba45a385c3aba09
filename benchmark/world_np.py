"""A frozen NumPy copy of ``world.py``'s room and renderer, for the CPU
tests that hold the PyTorch renderer to it. The same arithmetic in float32
(the distortion inversion in float64), one frame at a time; the textures
are passed in (``world.textures_from_noise``'s output, or this module's
``textures_from_noise`` on the same noise).

Imports nothing of the program under test.
"""

from __future__ import annotations

import numpy as np

MIN_HIT = 0.05
UNDIST_ITERS = 50


def _cubic_taps(n_src: int, n_dst: int):
    scale = n_src / n_dst
    f = ((np.arange(n_dst, dtype=np.float64) + 0.5) * scale - 0.5).astype(np.float32)
    s = np.floor(f)
    x = (f - s).astype(np.float32)
    A = np.float32(-0.75)
    c0 = ((A * (x + 1) - 5 * A) * (x + 1) + 8 * A) * (x + 1) - 4 * A
    c1 = ((A + 2) * x - (A + 3)) * x * x + 1
    c2 = ((A + 2) * (1 - x) - (A + 3)) * (1 - x) * (1 - x) + 1
    c3 = 1 - c0 - c1 - c2
    idx = np.clip(s.astype(np.int64)[None, :] + np.arange(-1, 3)[:, None],
                  0, n_src - 1)
    return idx, np.stack([c0, c1, c2, c3]).astype(np.float32)


def resize_cubic(src: np.ndarray, size: int) -> np.ndarray:
    """(P, h, w) float32 -> (P, size, size), rows filtered first."""
    src = np.asarray(src, np.float32)
    ix, cx = _cubic_taps(src.shape[2], size)
    rows = sum(src[:, :, ix[k]] * cx[k][None, None, :] for k in range(4))
    iy, cy = _cubic_taps(src.shape[1], size)
    return sum(rows[:, iy[k]] * cy[k][None, :, None] for k in range(4)).astype(np.float32)


def textures_from_noise(coarse, fine, size: int) -> np.ndarray:
    return np.clip(resize_cubic(coarse, size) + resize_cubic(fine, size),
                   0.0, 255.0).astype(np.float32)


def camera_rays(W, H, fx, fy, cx, cy, k1=0.0, k2=0.0) -> np.ndarray:
    ys, xs = np.meshgrid(np.arange(H, dtype=np.float64),
                         np.arange(W, dtype=np.float64), indexing="ij")
    nx = (xs - cx) / fx
    ny = (ys - cy) / fy
    if k1 != 0.0 or k2 != 0.0:
        ux, uy = nx.copy(), ny.copy()
        for _ in range(UNDIST_ITERS):
            r2 = ux * ux + uy * uy
            f = 1.0 + r2 * (k1 + k2 * r2)
            ux = nx / f
            uy = ny / f
        nx, ny = ux, uy
    return np.stack([nx, ny, np.ones_like(nx)], -1).astype(np.float32)


def planes(half: float, height: float):
    A, Hh = half, height
    return [
        ((A, 0, 0), (-1, 0, 0), (0, 1, 0), (0, 0, 1), A, Hh),
        ((-A, 0, 0), (1, 0, 0), (0, -1, 0), (0, 0, 1), A, Hh),
        ((0, A, 0), (0, -1, 0), (-1, 0, 0), (0, 0, 1), A, Hh),
        ((0, -A, 0), (0, 1, 0), (1, 0, 0), (0, 0, 1), A, Hh),
        ((0, 0, -Hh), (0, 0, 1), (1, 0, 0), (0, 1, 0), A, A),
        ((0, 0, Hh), (0, 0, -1), (1, 0, 0), (0, -1, 0), A, A),
    ]


def render(tex: np.ndarray, half: float, height: float, rays: np.ndarray,
           T_wc: np.ndarray) -> np.ndarray:
    """(H, W) float32 view at T_wc (4, 4) of the room textured by tex
    (6, ts, ts)."""
    R = T_wc[:3, :3].astype(np.float32)
    o = T_wc[:3, 3].astype(np.float32)
    d = rays @ R.T
    H, W = d.shape[:2]
    img = np.zeros((H, W), np.float32)
    zbuf = np.full((H, W), np.inf, np.float32)
    ts = tex.shape[-1]
    for k, (p0, n, u, v, uh, vh) in enumerate(planes(half, height)):
        p0, n, u, v = (np.asarray(a, np.float32) for a in (p0, n, u, v))
        dn = d @ n
        t_hit = ((p0 - o) @ n) / np.where(np.abs(dn) < 1e-12, np.float32(1e-12), dn)
        lu = (o - p0) @ u + t_hit * (d @ u)
        lv = (o - p0) @ v + t_hit * (d @ v)
        ok = (t_hit > MIN_HIT) & (np.abs(lu) <= uh) & (np.abs(lv) <= vh) \
            & (t_hit < zbuf)
        ti = np.clip((lu / uh * 0.5 + 0.5) * (ts - 1), 0, ts - 1)
        tj = np.clip((lv / vh * 0.5 + 0.5) * (ts - 1), 0, ts - 1)
        i0 = ti.astype(np.int64)
        j0 = tj.astype(np.int64)
        i1 = np.minimum(i0 + 1, ts - 1)
        j1 = np.minimum(j0 + 1, ts - 1)
        fi = (ti - i0).astype(np.float32)
        fj = (tj - j0).astype(np.float32)
        t = tex[k]
        val = (t[j0, i0] * (1 - fi) * (1 - fj) + t[j0, i1] * fi * (1 - fj)
               + t[j1, i0] * (1 - fi) * fj + t[j1, i1] * fi * fj)
        img = np.where(ok, val, img)
        zbuf = np.where(ok, t_hit, zbuf)
    return img


def exposure(img: np.ndarray, i: int) -> np.ndarray:
    g = 1.0 + 0.25 * np.sin(2 * np.pi * i / 300.0)
    b = 10.0 * np.sin(2 * np.pi * i / 470.0)
    return np.clip(img * np.float32(g) + np.float32(b), 0, 255).astype(np.float32)


def loop_pose(i: int, radius: float, step_m: float, bob: float = 0.02) -> np.ndarray:
    """Frame i's camera-to-world pose (the loop, one frame at a time)."""
    th = i * step_m / radius
    fwd = np.array([-np.sin(th), np.cos(th), 0.0])
    down = np.array([0.0, 0.0, -1.0])
    right = np.cross(down, fwd)
    right /= np.linalg.norm(right)
    T = np.eye(4)
    T[:3, 0], T[:3, 1], T[:3, 2] = right, down, fwd
    T[:3, 3] = [radius * np.cos(th), radius * np.sin(th), bob * np.sin(i * 0.13)]
    return T
