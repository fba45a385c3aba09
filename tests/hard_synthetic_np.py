"""OpenCV-free twin of ``tests/hard_synthetic.py``: the same hard synthetic
stereo world (textured room, loop trajectory, radial distortion, exposure
drift) rendered with numpy alone.

Its only OpenCV call, the texture resize (``cv2.resize(..., INTER_CUBIC)``),
is ``synthetic_np.resize_cubic``; everything else is ``hard_synthetic``'s
code. Used where OpenCV is not installed (``chip_smoke.py`` and
``scripts/torch_preset_tiers.py`` on the GPU machine);
``tests/test_torch_hard_synthetic_np.py`` holds its frames to
``hard_synthetic.py``'s.

The original module's description follows.

Hard synthetic stereo world: textured room, loop trajectory, radial
distortion, exposure drift.

A deliberately adversarial stand-in for EuRoC/KITTI-style evaluation in a
network-less environment (the reference validates on those datasets,
benchmark_scripts/euroc_bench.sh): multi-plane geometry (no planar-PnP
ambiguity), genuine loop closure (full circuit returns to the start view),
Brown-Conrady radial distortion exercising the undistortion/rectification
paths, and smooth exposure drift exercising photometric robustness (the
reference relies on CLAHE for this, ov2slam.cpp:335-352).

Rendering is ray-based: each output pixel's ray (through the distortion
model) is intersected with the room's wall planes; nearest hit samples that
wall's texture bilinearly. Everything is vectorized numpy; ~25 ms/frame.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from synthetic_np import resize_cubic


class CamSpec(NamedTuple):
    """Synthetic rig geometry: EuRoC-like by default, KITTI-like available
    for the wide-aspect high-resolution tier."""
    W: int
    H: int
    FX: float
    FY: float
    CX: float
    CY: float
    BASELINE: float


CAM_EUROC = CamSpec(752, 480, 458.0, 458.0, 376.0, 240.0, 0.11)
# KITTI seq-00 rig (parameters_files/accurate/kitti/kitti_00-02.yaml):
# 1241x376 @ fx 718.856, 0.537 m baseline
CAM_KITTI = CamSpec(1241, 376, 718.856, 718.856, 607.1928, 185.2157, 0.537)
# TartanAir rig (parameters_files/*/tartanair/*.yaml): 640x480 @ fx 320,
# distortion-free, 0.25 m baseline
CAM_TARTAN = CamSpec(640, 480, 320.0, 320.0, 320.0, 240.0, 0.25)

FX, FY, CX, CY = CAM_EUROC.FX, CAM_EUROC.FY, CAM_EUROC.CX, CAM_EUROC.CY
W, H = CAM_EUROC.W, CAM_EUROC.H
BASELINE = CAM_EUROC.BASELINE
K_MAT = np.array([[FX, 0, CX], [0, FY, CY], [0, 0, 1]], np.float64)


def params_dict(dist=(0.0, 0.0), use_clahe=1, cam: CamSpec = CAM_EUROC):
    k1, k2 = dist
    return {
        "Camera.model_left": "pinhole", "Camera.model_right": "pinhole",
        "Camera.left_nwidth": cam.W, "Camera.left_nheight": cam.H,
        "Camera.right_nwidth": cam.W, "Camera.right_nheight": cam.H,
        "Camera.fxl": cam.FX, "Camera.fyl": cam.FY,
        "Camera.cxl": cam.CX, "Camera.cyl": cam.CY,
        "Camera.k1l": k1, "Camera.k2l": k2, "Camera.p1l": 0.0, "Camera.p2l": 0.0,
        "Camera.fxr": cam.FX, "Camera.fyr": cam.FY,
        "Camera.cxr": cam.CX, "Camera.cyr": cam.CY,
        "Camera.k1r": k1, "Camera.k2r": k2, "Camera.p1r": 0.0, "Camera.p2r": 0.0,
        "T_left_right": np.array([
            [1, 0, 0, cam.BASELINE], [0, 1, 0, 0], [0, 0, 1, 0], [0, 0, 0, 1]],
            np.float64),
        "mono": 0, "stereo": 1, "slam_mode": 1, "buse_loop_closer": 0,
        "use_clahe": use_clahe, "nmaxdist": 45, "dmaxquality": 0.001,
        "nklt_pyr_lvl": 3, "nklt_win_size": 9,
        "finit_parallax": 20.0, "nmin_covscore": 15,
        "fkf_filtering_ratio": 0.95,
    }


class RoomWorld:
    """A square room (walls at x,y = +/-half) with per-wall textures, plus a
    floor and ceiling; the camera circles inside at radius r."""

    def __init__(self, half=8.0, height=3.0, seed=0, tex_size=2048):
        self.half = half
        self.height = height
        rng = np.random.default_rng(seed)

        def tex(s):
            t = rng.uniform(40, 215, size=(tex_size // 8, tex_size // 8))
            t = resize_cubic(t.astype(np.float32), tex_size)
            fine = rng.uniform(-25, 25, size=(tex_size // 2, tex_size // 2))
            t += resize_cubic(fine.astype(np.float32), tex_size)
            return np.clip(t, 0, 255)

        # planes: (point, normal, u-axis, v-axis, u-half, v-half, texture)
        A, Hh = half, height
        self.planes = [
            # four walls (normals point inward)
            (np.r_[A, 0, 0], np.r_[-1., 0, 0], np.r_[0, 1., 0], np.r_[0, 0, 1.], A, Hh, tex(0)),
            (np.r_[-A, 0, 0], np.r_[1., 0, 0], np.r_[0, -1., 0], np.r_[0, 0, 1.], A, Hh, tex(1)),
            (np.r_[0, A, 0], np.r_[0, -1., 0], np.r_[-1., 0, 0], np.r_[0, 0, 1.], A, Hh, tex(2)),
            (np.r_[0, -A, 0], np.r_[0, 1., 0], np.r_[1., 0, 0], np.r_[0, 0, 1.], A, Hh, tex(3)),
            # floor and ceiling (world z up)
            (np.r_[0, 0, -Hh], np.r_[0, 0, 1.], np.r_[1., 0, 0], np.r_[0, 1., 0], A, A, tex(4)),
            (np.r_[0, 0, Hh], np.r_[0, 0, -1.], np.r_[1., 0, 0], np.r_[0, -1., 0], A, A, tex(5)),
        ]

    _ray_cache = {}

    @classmethod
    def _rays(cls, dist, cam: CamSpec = CAM_EUROC):
        """Per-pixel camera-frame ray directions (pose-independent; the
        distortion inversion is the expensive part, so cache per dist)."""
        key = (tuple(dist), cam)
        hit = cls._ray_cache.get(key)
        if hit is not None:
            return hit
        ys, xs = np.meshgrid(np.arange(cam.H, dtype=np.float32),
                             np.arange(cam.W, dtype=np.float32), indexing="ij")
        nx = (xs - cam.CX) / cam.FX
        ny = (ys - cam.CY) / cam.FY
        k1, k2 = dist
        if k1 != 0.0 or k2 != 0.0:
            # pixel grid is DISTORTED coords; invert distortion to get the
            # ideal ray (fixed point, same scheme as core/camera.py Newton)
            ux, uy = nx.copy(), ny.copy()
            for _ in range(8):
                r2 = ux * ux + uy * uy
                f = 1.0 + r2 * (k1 + k2 * r2)
                ux = nx / f
                uy = ny / f
            nx, ny = ux, uy
        dirs_c = np.stack([nx, ny, np.ones_like(nx)], axis=-1)
        cls._ray_cache[key] = dirs_c
        return dirs_c

    def render(self, T_wc: np.ndarray, dist=(0.0, 0.0),
               cam: CamSpec = CAM_EUROC) -> np.ndarray:
        """Render the camera view at T_wc (camera-to-world). dist=(k1, k2)
        applies Brown radial distortion INSIDE the ray model, so the image
        is exactly what a distorted camera with those coefficients sees."""
        R_wc = T_wc[:3, :3].astype(np.float32)
        o = T_wc[:3, 3].astype(np.float32)
        # camera frame: x right, y down, z forward; world z up
        dirs_w = self._rays(dist, cam) @ R_wc.T

        img = np.zeros((cam.H, cam.W), np.float32)
        zbuf = np.full((cam.H, cam.W), np.inf, np.float32)
        for (p0, n, u, v, uh, vh, tex) in self.planes:
            p0 = p0.astype(np.float32)
            n = n.astype(np.float32)
            u = u.astype(np.float32)
            v = v.astype(np.float32)
            dn = dirs_w @ n
            t_hit = ((p0 - o) @ n) / np.where(np.abs(dn) < 1e-12, 1e-12, dn)
            lu = (o - p0) @ u + t_hit * (dirs_w @ u)
            lv = (o - p0) @ v + t_hit * (dirs_w @ v)
            ok = (t_hit > 0.05) & (np.abs(lu) <= uh) & (np.abs(lv) <= vh) \
                & (t_hit < zbuf)
            sel = np.nonzero(ok.ravel())[0]
            if len(sel) == 0:
                continue
            ts = tex.shape[0]
            ti = np.clip((lu.ravel()[sel] / uh * 0.5 + 0.5) * (ts - 1), 0, ts - 1)
            tj = np.clip((lv.ravel()[sel] / vh * 0.5 + 0.5) * (ts - 1), 0, ts - 1)
            i0 = ti.astype(np.int64)
            j0 = tj.astype(np.int64)
            i1 = np.minimum(i0 + 1, ts - 1)
            j1 = np.minimum(j0 + 1, ts - 1)
            fi = (ti - i0).astype(np.float32)
            fj = (tj - j0).astype(np.float32)
            val = (tex[j0, i0] * (1 - fi) * (1 - fj) + tex[j0, i1] * fi * (1 - fj)
                   + tex[j1, i0] * (1 - fi) * fj + tex[j1, i1] * fi * fj)
            img.ravel()[sel] = val
            zbuf.ravel()[sel] = t_hit.ravel()[sel]
        return img


def fig8_trajectory(n_frames: int, ax: float = 5.5, ay: float = 2.8,
                    periods: float = None, bob: float = 0.02):
    """Figure-8 (Lissajous x = ax sin t, y = ay sin 2t) inside the room,
    camera facing along the tangent: a MULTI-loop topology — each lobe is a
    distinct loop revisited every period, unlike loop_trajectory's single
    circuit (the KITTI-00 regime: multiple distinct loop closures,
    /root/reference README KITTI claims). Returns T_wc list."""
    if periods is None:
        periods = max(1.0, n_frames / 1000.0)
    poses = []
    for i in range(n_frames):
        th = 2 * np.pi * periods * i / n_frames
        pos = np.array([ax * np.sin(th), ay * np.sin(2 * th),
                        bob * np.sin(i * 0.13)])
        vel = np.array([ax * np.cos(th), 2 * ay * np.cos(2 * th), 0.0])
        fwd = vel / np.linalg.norm(vel)
        down = np.array([0.0, 0.0, -1.0])
        right = np.cross(down, fwd)
        right /= np.linalg.norm(right)
        T = np.eye(4)
        T[:3, 0] = right
        T[:3, 1] = down
        T[:3, 2] = fwd
        T[:3, 3] = pos
        poses.append(T)
    return poses


def loop_trajectory(n_frames: int, radius: float = 4.5, laps: float = 1.08,
                    bob: float = 0.02):
    """Camera circles the room interior, facing tangentially; `laps` > 1
    revisits the start => genuine loop closure. Returns T_wc list.

    Camera frame: x right, y down, z forward (vision convention); world z up.
    """
    poses = []
    for i in range(n_frames):
        th = 2 * np.pi * laps * i / n_frames
        pos = np.array([radius * np.cos(th), radius * np.sin(th),
                        bob * np.sin(i * 0.13)])
        fwd = np.array([-np.sin(th), np.cos(th), 0.0])     # tangent
        down = np.array([0.0, 0.0, -1.0])                  # camera y = world -z
        right = np.cross(down, fwd)
        right /= np.linalg.norm(right)
        T = np.eye(4)
        T[:3, 0] = right
        T[:3, 1] = down
        T[:3, 2] = fwd
        T[:3, 3] = pos
        poses.append(T)
    return poses


def exposure(img: np.ndarray, i: int) -> np.ndarray:
    """Smooth gain + bias drift (period ~300 frames, +/-25% gain)."""
    g = 1.0 + 0.25 * np.sin(2 * np.pi * i / 300.0)
    b = 10.0 * np.sin(2 * np.pi * i / 470.0)
    return np.clip(img * g + b, 0, 255).astype(np.float32)


def render_hard_sequence(n_frames=1000, seed=0, dist=(-0.28, 0.07),
                         with_exposure=True, cam: CamSpec = CAM_EUROC,
                         traj: str = "loop", frames=None):
    """Generator of (img_l, img_r, t, T_wc_gt): distorted, exposure-drifted
    stereo frames around the room loop. Yields lazily — 1000+ frames at
    752x480 would be ~2.9 GB if materialized. The lap count scales with
    length (1000 frames ~ 1 lap), so longer sequences revisit repeatedly.
    traj="fig8" switches to the multi-loop figure-8 topology. `frames`
    (indices into the n_frames) renders only those frames, in that order,
    so that worker processes can split one sequence."""
    world = RoomWorld(seed=seed)
    if traj == "fig8":
        poses = fig8_trajectory(n_frames)
    else:
        poses = loop_trajectory(n_frames, laps=1.08 * max(1.0, n_frames / 1000.0))
    T_rl = np.eye(4)
    T_rl[0, 3] = -cam.BASELINE
    T_lr = np.linalg.inv(T_rl)
    for i in (range(n_frames) if frames is None else frames):
        T_wc = poses[i]
        il = world.render(T_wc, dist, cam)
        ir = world.render(T_wc @ T_lr, dist, cam)
        if with_exposure:
            il = exposure(il, i)
            ir = exposure(ir, i)
        yield il, ir, i * 0.05, T_wc
