"""tests/synthetic_np.py (numpy only) against tests/synthetic.py (OpenCV).

Tolerance: 0.05 gray levels per pixel, 0.005 on the mean. The resize is
OpenCV's own arithmetic in another summation order (measured <= 0.006); the
warp computes the same exact bilinear sample (measured <= 0.013), far below
the 1/255 a uint8 frame resolves.
"""

import numpy as np
import pytest

import synthetic as syn
import synthetic_np as synp


@pytest.fixture(scope="module")
def textures():
    return syn.make_texture(0), synp.make_texture(0)


def test_texture_matches_opencv(textures):
    a, b = textures
    assert a.shape == b.shape
    assert np.abs(a - b).max() <= 0.05


@pytest.mark.parametrize("frame", [0, 7])
@pytest.mark.parametrize("side", ["left", "right"])
def test_views_match_opencv(textures, frame, side):
    tex_cv, _ = textures
    tex2 = syn.make_texture(100)
    T_wc = syn.make_trajectory(8, 0.03, 0.0015)[frame]
    T_cw = np.linalg.inv(T_wc)
    if side == "right":
        T_rl = np.eye(4)
        T_rl[0, 3] = -syn.BASELINE
        T_cw = T_rl @ T_cw
    a = syn.render_view(tex_cv, tex2, T_cw)
    b = synp.render_view(tex_cv, tex2, T_cw)
    d = np.abs(a - b)
    assert d.max() <= 0.05 and d.mean() <= 0.005, (d.max(), d.mean())


def test_same_rig_and_trajectory():
    a, b = syn.slam_params_dict(), synp.slam_params_dict()
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    for Ta, Tb in zip(syn.make_trajectory(10), synp.make_trajectory(10)):
        np.testing.assert_array_equal(Ta, Tb)
