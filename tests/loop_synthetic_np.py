"""OpenCV-free renderer of the out-and-back loop-closing world of
``tests/test_loopclosing.py`` (``render_out_and_back``), through
``tests/synthetic_np.py``: forward along +x, then exactly back, so frame
n_half + k revisits frame n_half - k. The wall is close (z = 2.5 m), so the
view spans only ~+/-2 m of it and distant frames see different places,
which makes the revisit a loop closure and not a local-map match.
"""

import functools

import numpy as np

import synthetic_np as syn

# the detector settings the loop-closing tests use for this short world
DETECTOR = dict(p_wait=10, min_consecutive=2, min_score=3.0)


@functools.lru_cache(maxsize=2)
def render_out_and_back(n_half=50, step=0.08, seed=0):
    """(left frames, right frames, camera-to-world poses) of 2 * n_half
    frames, as tuples (rendered once per process and shared, ~16 s)."""
    tex, tex2 = _textures(seed)
    poses = []
    for i in range(n_half):
        T = np.eye(4)
        T[:3, 3] = [step * i, 0, 0]
        poses.append(T)
    for i in range(n_half):
        T = np.eye(4)
        T[:3, 3] = [step * (n_half - 1 - i), 0.001, 0]  # tiny offset
        poses.append(T)
    T_rl = np.eye(4)
    T_rl[0, 3] = -syn.BASELINE
    out_l, out_r = [], []
    for T_wc in poses:
        T_cw = np.linalg.inv(T_wc)
        out_l.append(syn.render_view(tex, tex2, T_cw, plane_z=2.5,
                                     plane2_z=1.7, plane2_hw=0.6))
        out_r.append(syn.render_view(tex, tex2, T_rl @ T_cw, plane_z=2.5,
                                     plane2_z=1.7, plane2_hw=0.6))
    return tuple(out_l), tuple(out_r), tuple(poses)


@functools.lru_cache(maxsize=2)
def _textures(seed):
    """The wall's and the slab's textures (made once per process)."""
    return syn.make_texture(seed, size=6000), syn.make_texture(seed + 100)


def loop_params_dict(**overrides):
    """The synthetic rig with the loop closer on and local-map matching
    off (as the loop-closing tests run it)."""
    d = syn.slam_params_dict()
    d.update(buse_loop_closer=1, bdo_track_localmap=0)
    d.update(overrides)
    return d


def set_detector(slam):
    """Apply the short-world detector settings to a system's loop closer."""
    for k, v in DETECTOR.items():
        setattr(slam.loopcloser.detector, k, v)
