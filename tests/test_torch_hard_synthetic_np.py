"""tests/hard_synthetic_np.py (numpy only) against tests/hard_synthetic.py
(OpenCV texture resize).

Tolerance: 0.05 gray levels per pixel, 0.005 on the mean, as
test_torch_synthetic_np.py holds the plane renderer: the resize is OpenCV's
own arithmetic in another summation order, the ray casting is the same
code. Measured <= 6.1e-5 on the frames below.
"""

import numpy as np
import pytest

import hard_synthetic as hs
import hard_synthetic_np as hsn


@pytest.mark.parametrize("dist", [(-0.28, 0.07), (0.0, 0.0)])
def test_frames_match_opencv(dist):
    """The first frames and a later one of the preset-tier sequence
    (n_frames=1000), left and right, with and without distortion."""
    a = hs.render_hard_sequence(n_frames=1000, dist=dist)
    b = hsn.render_hard_sequence(n_frames=1000, dist=dist)
    for i, (fa, fb) in enumerate(zip(a, b)):
        if i not in (0, 1, 9):
            continue
        for x, y in zip(fa[:2], fb[:2]):
            d = np.abs(x - y)
            assert d.max() <= 0.05 and d.mean() <= 0.005, (i, d.max(), d.mean())
        assert fa[2] == fb[2]
        np.testing.assert_array_equal(fa[3], fb[3])
        if i == 9:
            break


def test_same_rig_and_trajectories():
    for cam in (hs.CAM_EUROC, hs.CAM_KITTI, hs.CAM_TARTAN):
        a = hs.params_dict(dist=(-0.28, 0.07), cam=cam)
        b = hsn.params_dict(dist=(-0.28, 0.07), cam=cam)
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    for f in ("loop_trajectory", "fig8_trajectory"):
        for Ta, Tb in zip(getattr(hs, f)(50), getattr(hsn, f)(50)):
            np.testing.assert_array_equal(Ta, Tb)


def test_frame_selection_renders_the_same_frames():
    """render_hard_sequence(frames=...) (how the preset tiers' worker
    processes split the sequence) gives exactly those frames of the whole
    sequence, in the order asked."""
    full = hsn.render_hard_sequence(n_frames=1000)
    want = {i: f for i, f in zip(range(10), full)}
    got = list(hsn.render_hard_sequence(n_frames=1000, frames=[9, 1]))
    assert len(got) == 2
    for i, g in zip((9, 1), got):
        for x, y in zip(want[i][:2], g[:2]):
            np.testing.assert_array_equal(x, y)
        assert want[i][2] == g[2]
        np.testing.assert_array_equal(want[i][3], g[3])
