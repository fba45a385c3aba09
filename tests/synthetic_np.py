"""OpenCV-free twin of ``tests/synthetic.py``: the same synthetic stereo
sequence rendered with numpy alone.

``synthetic.py`` needs ``cv2`` for two calls; this module reimplements both
with OpenCV's arithmetic so the frames match:

* ``cv2.resize(..., INTER_CUBIC)`` — Keys cubic (a = -0.75) taps at
  ``(x + 0.5) * scale - 0.5``, borders replicated, rows filtered first;
* ``cv2.warpPerspective(..., INTER_LINEAR, BORDER_REPLICATE)`` — the inverse
  homography evaluated in float64 and bilinear weights at the exact source
  coordinate (OpenCV 5's warp kernels; OpenCV 4 rounded the coordinate to
  1/32 pixel), each tap clamped to the image.

Used where OpenCV is not installed (``chip_smoke.py`` on the GPU machine);
``tests/test_torch_synthetic_np.py`` holds its frames to ``synthetic.py``'s.
"""

import numpy as np

FX, FY, CX, CY = 458.0, 458.0, 376.0, 240.0
W, H = 752, 480
BASELINE = 0.11
K_MAT = np.array([[FX, 0, CX], [0, FY, CY], [0, 0, 1]], np.float64)


def slam_params_dict():
    """The synthetic rig's SlamParams dict (identical to synthetic.py's)."""
    return {
        "Camera.model_left": "pinhole", "Camera.model_right": "pinhole",
        "Camera.left_nwidth": W, "Camera.left_nheight": H,
        "Camera.right_nwidth": W, "Camera.right_nheight": H,
        "Camera.fxl": FX, "Camera.fyl": FY, "Camera.cxl": CX, "Camera.cyl": CY,
        "Camera.k1l": 0.0, "Camera.k2l": 0.0, "Camera.p1l": 0.0, "Camera.p2l": 0.0,
        "Camera.fxr": FX, "Camera.fyr": FY, "Camera.cxr": CX, "Camera.cyr": CY,
        "Camera.k1r": 0.0, "Camera.k2r": 0.0, "Camera.p1r": 0.0, "Camera.p2r": 0.0,
        "T_left_right": np.array([
            [1, 0, 0, BASELINE], [0, 1, 0, 0], [0, 0, 1, 0], [0, 0, 0, 1]],
            np.float64),
        "mono": 0, "stereo": 1, "slam_mode": 1, "buse_loop_closer": 0,
        "use_clahe": 0, "nmaxdist": 45, "dmaxquality": 0.001,
        "nklt_pyr_lvl": 3, "nklt_win_size": 9,
        "finit_parallax": 20.0, "nmin_covscore": 15,
        "fkf_filtering_ratio": 2.0,
        "prewarm": 0,
    }


def _cubic_taps(n_src: int, n_dst: int):
    """Per output index: 4 clamped source indices and their Keys weights."""
    scale = n_src / n_dst
    f = ((np.arange(n_dst) + 0.5) * scale - 0.5).astype(np.float32)
    s = np.floor(f).astype(np.int64)
    x = (f - s).astype(np.float32)
    A = np.float32(-0.75)
    c0 = ((A * (x + 1) - 5 * A) * (x + 1) + 8 * A) * (x + 1) - 4 * A
    c1 = ((A + 2) * x - (A + 3)) * x * x + 1
    c2 = ((A + 2) * (1 - x) - (A + 3)) * (1 - x) * (1 - x) + 1
    c3 = 1 - c0 - c1 - c2
    idx = np.clip(s[None, :] + np.arange(-1, 3)[:, None], 0, n_src - 1)
    return idx, np.stack([c0, c1, c2, c3]).astype(np.float32)


def resize_cubic(src: np.ndarray, size: int) -> np.ndarray:
    """cv2.resize(src, (size, size), interpolation=cv2.INTER_CUBIC) for a
    float32 image."""
    src = np.asarray(src, np.float32)
    ix, cx = _cubic_taps(src.shape[1], size)
    rows = sum(src[:, ix[k]] * cx[k][None, :] for k in range(4))
    iy, cy = _cubic_taps(src.shape[0], size)
    return sum(rows[iy[k]] * cy[k][:, None] for k in range(4)).astype(np.float32)


def warp_perspective(src: np.ndarray, Hm: np.ndarray, width: int, height: int
                     ) -> np.ndarray:
    """cv2.warpPerspective(src, Hm, (width, height), flags=INTER_LINEAR,
    borderMode=BORDER_REPLICATE) for a float32 image."""
    M = np.linalg.inv(np.asarray(Hm, np.float64))
    ys, xs = np.meshgrid(np.arange(height, dtype=np.float64),
                         np.arange(width, dtype=np.float64), indexing="ij")
    Wd = M[2, 0] * xs + M[2, 1] * ys + M[2, 2]
    Wd = 1.0 / np.where(Wd != 0, Wd, np.inf)
    X = (M[0, 0] * xs + M[0, 1] * ys + M[0, 2]) * Wd
    Y = (M[1, 0] * xs + M[1, 1] * ys + M[1, 2]) * Wd
    x0 = np.floor(X).astype(np.int64)
    y0 = np.floor(Y).astype(np.int64)
    fx = (X - x0).astype(np.float32)
    fy = (Y - y0).astype(np.float32)
    hs, ws = src.shape
    cx0, cx1 = np.clip(x0, 0, ws - 1), np.clip(x0 + 1, 0, ws - 1)
    cy0, cy1 = np.clip(y0, 0, hs - 1), np.clip(y0 + 1, 0, hs - 1)
    w00 = (1 - fy) * (1 - fx)
    w01 = (1 - fy) * fx
    w10 = fy * (1 - fx)
    w11 = fy * fx
    return (src[cy0, cx0] * w00 + src[cy0, cx1] * w01
            + src[cy1, cx0] * w10 + src[cy1, cx1] * w11).astype(np.float32)


def make_texture(seed=0, size=3000):
    rng = np.random.default_rng(seed)
    tex = rng.uniform(0, 255, size=(size // 10, size // 10)).astype(np.float32)
    tex = resize_cubic(tex, size)
    fine = rng.uniform(-20, 20, size=(size // 3, size // 3)).astype(np.float32)
    tex += resize_cubic(fine, size)
    return np.clip(tex, 0, 255)


def render_plane(tex, T_cw, plane_z=8.0, plane_halfwidth=12.0):
    """Render the world plane z=plane_z (x, y in [-hw, hw]) through T_cw."""
    R = T_cw[:3, :3]
    t = T_cw[:3, 3]
    Hm = K_MAT @ np.stack([R[:, 0], R[:, 1], R[:, 2] * plane_z + t], axis=1)
    size = tex.shape[0]
    S = np.array([
        [size / (2 * plane_halfwidth), 0, size / 2],
        [0, size / (2 * plane_halfwidth), size / 2],
        [0, 0, 1]], np.float64)
    return warp_perspective(tex, Hm @ np.linalg.inv(S), W, H)


def make_trajectory(n_frames=60, step=0.04, yaw_rate=0.002):
    """Camera-to-world ground truth: translate along x, slight yaw."""
    poses_wc = []
    for i in range(n_frames):
        yaw = yaw_rate * i
        c, s = np.cos(yaw), np.sin(yaw)
        T = np.eye(4)
        T[:3, :3] = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float64)
        T[:3, 3] = [step * i, 0.002 * np.sin(i * 0.3), 0.001 * i]
        poses_wc.append(T)
    return poses_wc


def render_view(tex1, tex2, T_cw, plane_z=8.0, plane2_z=5.0, plane2_hw=2.5):
    """Far wall (z=plane_z) plus a near square slab (z=plane2_z,
    |x|,|y| <= plane2_hw)."""
    img = render_plane(tex1, T_cw, plane_z)
    img2 = render_plane(tex2, T_cw, plane2_z, plane_halfwidth=8.0)
    R = T_cw[:3, :3]
    t = T_cw[:3, 3]
    Hm = K_MAT @ np.stack([R[:, 0], R[:, 1], R[:, 2] * plane2_z + t], axis=1)
    ys, xs = np.meshgrid(np.arange(H, dtype=np.float64),
                         np.arange(W, dtype=np.float64), indexing="ij")
    world = np.stack([xs, ys, np.ones_like(xs)], axis=-1) @ np.linalg.inv(Hm).T
    wx = world[..., 0] / world[..., 2]
    wy = world[..., 1] / world[..., 2]
    Xc_z = R[2, 0] * wx + R[2, 1] * wy + R[2, 2] * plane2_z + t[2]
    mask = (np.abs(wx) <= plane2_hw) & (np.abs(wy) <= plane2_hw) & (Xc_z > 0)
    return np.where(mask, img2, img).astype(np.float32)


def render_sequence(n_frames=60, seed=0, plane_z=8.0, step=0.04, yaw_rate=0.002,
                    frames=None):
    """Returns (frames_left, frames_right, gt poses camera-to-world); with
    `frames` (indices into the n_frames) only those frames, in that order,
    so that worker processes can split one sequence."""
    tex = make_texture(seed)
    tex2 = make_texture(seed + 100)
    poses_wc = make_trajectory(n_frames, step, yaw_rate)
    if frames is not None:
        poses_wc = [poses_wc[i] for i in frames]
    T_rl = np.eye(4)
    T_rl[0, 3] = -BASELINE
    out_l, out_r = [], []
    for T_wc in poses_wc:
        T_cw = np.linalg.inv(T_wc)
        out_l.append(render_view(tex, tex2, T_cw, plane_z))
        out_r.append(render_view(tex, tex2, T_rl @ T_cw, plane_z))
    return out_l, out_r, poses_wc
