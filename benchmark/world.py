"""The benchmark's frame generator: a textured room seen by a stereo rig
that circles inside it, rendered with PyTorch on the device.

A rewrite of the repository's hard synthetic world (a square room with
textured walls, floor and ceiling; the loop trajectory; Brown radial
distortion inside the ray model; a smooth exposure drift) for a renderer
that makes thousands of frames in a few seconds on the card. Everything is
made from the seed: the textures by one ``torch.Generator`` on the device,
the trajectory by closed form. ``world_np.py`` is a frozen NumPy copy of
the same arithmetic; the benchmark's CPU tests hold the two to each other.

The trajectory is parameterised by the distance travelled per frame, so a
traffic file states the camera's speed directly: frame ``i`` sits at the
angle ``i * step_m / radius`` of a circle of radius ``radius``, facing
along its tangent, bobbing ``bob * sin(0.13 i)`` metres up and down.

Imports nothing of the program under test.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

# ray / plane arithmetic (shared with world_np.py)
MIN_HIT = 0.05          # hits nearer than this along a ray are ignored
UNDIST_ITERS = 50       # fixed-point steps of the distortion inversion


class Rig(NamedTuple):
    """A stereo rig: pinhole intrinsics, Brown radial distortion (k1, k2)
    applied inside the ray model, and a pure x baseline (the right camera
    sits `baseline` metres along the left camera's x axis)."""
    W: int
    H: int
    fx: float
    fy: float
    cx: float
    cy: float
    baseline: float
    k1: float = 0.0
    k2: float = 0.0


def rig_of(d: dict) -> Rig:
    return Rig(int(d["W"]), int(d["H"]), float(d["fx"]), float(d["fy"]),
               float(d["cx"]), float(d["cy"]), float(d["baseline"]),
               float(d.get("k1", 0.0)), float(d.get("k2", 0.0)))


def loop_poses(n: int, radius: float, step_m: float, bob: float = 0.02,
               first: int = 0) -> np.ndarray:
    """(n, 4, 4) float64 camera-to-world poses of frames first .. first+n-1
    (camera x right, y down, z forward; world z up)."""
    i = np.arange(first, first + n, dtype=np.float64)
    th = i * step_m / radius
    T = np.zeros((n, 4, 4))
    fwd = np.stack([-np.sin(th), np.cos(th), np.zeros(n)], -1)
    down = np.array([0.0, 0.0, -1.0])
    right = np.cross(down, fwd)
    right /= np.linalg.norm(right, axis=-1, keepdims=True)
    T[:, :3, 0] = right
    T[:, :3, 1] = down
    T[:, :3, 2] = fwd
    T[:, :3, 3] = np.stack([radius * np.cos(th), radius * np.sin(th),
                            bob * np.sin(i * 0.13)], -1)
    T[:, 3, 3] = 1.0
    return T


def exposure_gain_bias(i) -> Tuple[np.ndarray, np.ndarray]:
    """The exposure drift of frame i: gain 1 +/- 25% over 300 frames, bias
    +/- 10 grey levels over 470 frames."""
    i = np.asarray(i, np.float64)
    return (1.0 + 0.25 * np.sin(2 * np.pi * i / 300.0),
            10.0 * np.sin(2 * np.pi * i / 470.0))


def planes(half: float, height: float):
    """The room's six planes: (point, inward normal, u axis, v axis,
    u half-extent, v half-extent), walls first, then floor and ceiling."""
    A, Hh = half, height
    return [
        ((A, 0, 0), (-1, 0, 0), (0, 1, 0), (0, 0, 1), A, Hh),
        ((-A, 0, 0), (1, 0, 0), (0, -1, 0), (0, 0, 1), A, Hh),
        ((0, A, 0), (0, -1, 0), (-1, 0, 0), (0, 0, 1), A, Hh),
        ((0, -A, 0), (0, 1, 0), (1, 0, 0), (0, 0, 1), A, Hh),
        ((0, 0, -Hh), (0, 0, 1), (1, 0, 0), (0, 1, 0), A, A),
        ((0, 0, Hh), (0, 0, -1), (1, 0, 0), (0, -1, 0), A, A),
    ]


def _cubic_taps(n_src: int, n_dst: int, device):
    """Keys cubic (a = -0.75) taps of an n_src -> n_dst resize at
    ((x + 0.5) * scale - 0.5), borders replicated: (4, n_dst) indices and
    weights."""
    scale = n_src / n_dst
    f = (torch.arange(n_dst, dtype=torch.float64, device=device) + 0.5) \
        * scale - 0.5
    f = f.to(torch.float32)
    s = torch.floor(f)
    x = f - s
    A = -0.75
    c0 = ((A * (x + 1) - 5 * A) * (x + 1) + 8 * A) * (x + 1) - 4 * A
    c1 = ((A + 2) * x - (A + 3)) * x * x + 1
    c2 = ((A + 2) * (1 - x) - (A + 3)) * (1 - x) * (1 - x) + 1
    c3 = 1 - c0 - c1 - c2
    idx = torch.clamp(s.long()[None, :] + torch.arange(-1, 3, device=device)[:, None],
                      0, n_src - 1)
    return idx, torch.stack([c0, c1, c2, c3])


def resize_cubic(src: torch.Tensor, size: int) -> torch.Tensor:
    """(P, h, w) float32 -> (P, size, size), rows filtered first."""
    ix, cx = _cubic_taps(src.shape[2], size, src.device)
    rows = sum(src[:, :, ix[k]] * cx[k][None, None, :] for k in range(4))
    iy, cy = _cubic_taps(src.shape[1], size, src.device)
    return sum(rows[:, iy[k]] * cy[k][None, :, None] for k in range(4))


def textures_from_noise(coarse: torch.Tensor, fine: torch.Tensor,
                        size: int) -> torch.Tensor:
    """(6, size, size) textures: a coarse pattern of grey levels 40-215
    plus a finer +/-25 one, each cubic-upsampled, clipped to 0-255."""
    return torch.clamp(resize_cubic(coarse, size) + resize_cubic(fine, size),
                       0.0, 255.0)


def make_noise(seed: int, size: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The textures' noise from the seed, drawn on `device`."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    coarse = 40.0 + 175.0 * torch.rand((6, size // 8, size // 8),
                                       generator=gen, device=device)
    fine = -25.0 + 50.0 * torch.rand((6, size // 2, size // 2),
                                     generator=gen, device=device)
    return coarse, fine


def camera_rays(rig: Rig, device) -> torch.Tensor:
    """(H, W, 3) camera-frame ray of every pixel: the pixel grid holds
    distorted coordinates, inverted to the ideal ray by fixed-point steps
    (in float64, then cast)."""
    ys, xs = torch.meshgrid(
        torch.arange(rig.H, dtype=torch.float64, device=device),
        torch.arange(rig.W, dtype=torch.float64, device=device), indexing="ij")
    nx = (xs - rig.cx) / rig.fx
    ny = (ys - rig.cy) / rig.fy
    if rig.k1 != 0.0 or rig.k2 != 0.0:
        ux, uy = nx.clone(), ny.clone()
        for _ in range(UNDIST_ITERS):
            r2 = ux * ux + uy * uy
            f = 1.0 + r2 * (rig.k1 + rig.k2 * r2)
            ux = nx / f
            uy = ny / f
        nx, ny = ux, uy
    return torch.stack([nx, ny, torch.ones_like(nx)], -1).to(torch.float32)


class RoomWorld:
    """The room (walls at x, y = +/-half, floor and ceiling at z = -/+height)
    and its textures, on `device`."""

    def __init__(self, seed: int, half: float = 8.0, height: float = 3.0,
                 tex_size: int = 2048, device="cpu", noise=None):
        self.half, self.height, self.device = half, height, torch.device(device)
        coarse, fine = noise if noise is not None else make_noise(
            seed, tex_size, self.device)
        self.tex = textures_from_noise(coarse, fine, tex_size).contiguous()
        self.planes = planes(half, height)

    def render(self, rays: torch.Tensor, T_wc: torch.Tensor) -> torch.Tensor:
        """(B, H, W) float32 grey levels of the views at T_wc (B, 4, 4)
        float32, rays from ``camera_rays``: each pixel samples, bilinearly,
        the texture of the nearest plane its ray hits."""
        R = T_wc[:, :3, :3]
        o = T_wc[:, :3, 3]
        d = torch.einsum("hwj,bij->bhwi", rays, R)            # (B, H, W, 3)
        B, H, W = d.shape[:3]
        img = torch.zeros((B, H, W), dtype=torch.float32, device=d.device)
        zbuf = torch.full((B, H, W), float("inf"), device=d.device)
        ts = self.tex.shape[-1]
        flat = self.tex.reshape(6, -1)
        for k, (p0, n, u, v, uh, vh) in enumerate(self.planes):
            p0, n, u, v = (torch.tensor(a, dtype=torch.float32).to(d.device)
                           for a in (p0, n, u, v))
            dn = d @ n
            t_hit = ((p0 - o) @ n)[:, None, None] / torch.where(
                torch.abs(dn) < 1e-12, torch.full_like(dn, 1e-12), dn)
            lu = ((o - p0) @ u)[:, None, None] + t_hit * (d @ u)
            lv = ((o - p0) @ v)[:, None, None] + t_hit * (d @ v)
            ok = ((t_hit > MIN_HIT) & (torch.abs(lu) <= uh)
                  & (torch.abs(lv) <= vh) & (t_hit < zbuf))
            ti = torch.clamp((lu / uh * 0.5 + 0.5) * (ts - 1), 0, ts - 1)
            tj = torch.clamp((lv / vh * 0.5 + 0.5) * (ts - 1), 0, ts - 1)
            i0 = ti.long()
            j0 = tj.long()
            i1 = torch.clamp(i0 + 1, max=ts - 1)
            j1 = torch.clamp(j0 + 1, max=ts - 1)
            fi = ti - i0
            fj = tj - j0
            tex = flat[k]
            val = (tex[j0 * ts + i0] * (1 - fi) * (1 - fj)
                   + tex[j0 * ts + i1] * fi * (1 - fj)
                   + tex[j1 * ts + i0] * (1 - fi) * fj
                   + tex[j1 * ts + i1] * fi * fj)
            img = torch.where(ok, val, img)
            zbuf = torch.where(ok, t_hit, zbuf)
        return img


def render_sequence(world: RoomWorld, rig: Rig, poses: np.ndarray,
                    first: int = 0, batch: int = 64,
                    exposure: bool = True) -> Tuple[np.ndarray, np.ndarray]:
    """Left and right uint8 frames (n, H, W) on the host of the poses
    (n, 4, 4) (frame indices first .. first+n-1, which set the exposure):
    rendered in float32 on the world's device, exposure applied, clipped
    to 0-255 and truncated to uint8 as an 8-bit camera's frames are."""
    dev = world.device
    n = poses.shape[0]
    rays = camera_rays(rig, dev)
    T_lr = np.eye(4)                   # the right camera in the left's frame
    T_lr[0, 3] = rig.baseline
    left = np.empty((n, rig.H, rig.W), np.uint8)
    right = np.empty((n, rig.H, rig.W), np.uint8)
    for s in range(0, n, batch):
        P = poses[s:s + batch]
        g, b = exposure_gain_bias(np.arange(first + s, first + s + len(P)))
        if not exposure:
            g, b = np.ones_like(g), np.zeros_like(b)
        g = torch.tensor(g, dtype=torch.float32, device=dev)[:, None, None]
        b = torch.tensor(b, dtype=torch.float32, device=dev)[:, None, None]
        for T, out in ((P, left), (P @ T_lr, right)):
            img = world.render(rays, torch.tensor(T, dtype=torch.float32,
                                                  device=dev))
            img = torch.clamp(img * g + b, 0.0, 255.0).to(torch.uint8)
            out[s:s + len(P)] = img.cpu().numpy()
    return left, right
