"""The benchmark's frame generator: its PyTorch renderer against the frozen
NumPy copy, and its ground-truth poses against the trajectory's.

    python -m pytest benchmark/test_bench_world.py -q
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import world  # noqa: E402
import world_np  # noqa: E402

# Both renderers work in float32 and differ in the order of a few sums, so a
# pixel's texture coordinate may differ in its last bit: after the uint8
# truncation a grey level may move by 1. More than that only where a ray
# grazes the edge between two planes, which a few pixels of a frame do.
MAX_STEP, SHARE_OVER_ONE = 1, 2e-4

RIGS = {
    "euroc": world.Rig(188, 120, 114.5, 114.5, 94.0, 60.0, 0.11, -0.28, 0.07),
    "kitti": world.Rig(310, 94, 179.7, 179.7, 151.8, 46.3, 0.537, -0.28, 0.07),
    "pinhole": world.Rig(160, 120, 80.0, 80.0, 80.0, 60.0, 0.25),
}


def _frames(rig, first=37, n=3, seed=2 ** 40 + 3, half=8.0, height=3.0):
    room = world.RoomWorld(seed, half, height, tex_size=256)
    poses = world.loop_poses(n, 4.5, 0.03, first=first)
    left, right = world.render_sequence(room, rig, poses, first=first, batch=2)
    tex = room.tex.numpy()
    rays = world_np.camera_rays(rig.W, rig.H, rig.fx, rig.fy, rig.cx, rig.cy,
                                rig.k1, rig.k2)
    T_lr = np.eye(4)
    T_lr[0, 3] = rig.baseline
    ref_l, ref_r = [], []
    for k in range(n):
        T = world_np.loop_pose(first + k, 4.5, 0.03)
        for T_, out in ((T, ref_l), (T @ T_lr, ref_r)):
            img = world_np.exposure(world_np.render(tex, half, height, rays, T_),
                                    first + k)
            out.append(img.astype(np.uint8))
    return left, right, np.stack(ref_l), np.stack(ref_r)


def test_renderer_matches_numpy_copy():
    torch.set_num_threads(2)
    for name, rig in RIGS.items():
        left, right, ref_l, ref_r = _frames(rig)
        for a, b in ((left, ref_l), (right, ref_r)):
            d = np.abs(a.astype(np.int16) - b.astype(np.int16))
            assert (d > MAX_STEP).mean() <= SHARE_OVER_ONE, (name, d.max())
            assert a.std() > 20, name        # a textured view, not a blank


def test_textures_match_numpy_copy():
    coarse, fine = world.make_noise(11, 128, "cpu")
    a = world.textures_from_noise(coarse, fine, 128).numpy()
    b = world_np.textures_from_noise(coarse.numpy(), fine.numpy(), 128)
    assert np.abs(a - b).max() < 1e-3


def test_textures_repeat_from_the_seed():
    a = world.make_noise(2 ** 31 + 5, 64, "cpu")
    b = world.make_noise(2 ** 31 + 5, 64, "cpu")
    c = world.make_noise(2 ** 31 + 6, 64, "cpu")
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], c[0])


def test_ground_truth_poses_follow_the_trajectory():
    radius, step = 7.0, 0.03
    P = world.loop_poses(50, radius, step, first=10)
    for k in (0, 17, 49):
        assert np.abs(P[k] - world_np.loop_pose(10 + k, radius, step)).max() < 1e-12
    R = P[:, :3, :3]
    assert np.abs(R @ R.transpose(0, 2, 1) - np.eye(3)).max() < 1e-12
    assert np.allclose(np.linalg.det(R), 1.0)
    # the camera looks along its path, and advances step_m per frame (the
    # chord of the circle)
    d = np.diff(P[:, :3, 3], axis=0)
    chord = 2 * radius * np.sin(step / radius / 2)
    assert np.abs(np.linalg.norm(d[:, :2], axis=1) - chord).max() < 1e-9
    fwd = P[:-1, :3, 2]
    assert (np.einsum("ij,ij->i", fwd[:, :2], d[:, :2]) > 0.99 * chord).all()


def test_sequence_poses_are_the_record():
    rig = RIGS["pinhole"]
    room = world.RoomWorld(3, tex_size=64)
    P = world.loop_poses(4, 4.5, 0.02)
    left, right = world.render_sequence(room, rig, P, batch=3)
    assert left.shape == (4, rig.H, rig.W) and left.dtype == np.uint8
    assert not np.array_equal(left, right)
