"""The stereo slice on the KITTI and TartanAir rigs through both packages:
the shapes the EuRoC rig never gives (1241x376: odd level widths 1241, 621,
311, 156; CLAHE tiles padded on the width; a 1241 px detection grid; the
KITTI preset's rectification), on the CPU.

Each rig's preset tier (``scripts/torch_preset_tiers.py``: ``kitti_stereo``,
the KITTI 00-02 preset with ``bdo_stereo_rect``; ``tartanair_stereo``, the
undistorted TartanAir rig), synchronous, loop closer and epipolar filter
off, over the first frames of its hard sequence. Tolerances: the pyramid
shapes equal; the first keyframe's keypoints, stereo matches and landmarks
equal (both packages store their pyramids in float16, ROADMAP C/P2); every
pose within 8e-5 m, tenfold the largest gap this CPU measured (KITTI
1.1e-6 m, TartanAir 8.0e-6 m).
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401
from ov2slam_tpu.config import SlamParams as JParams
from ov2slam_tpu.ops import image as jim
from ov2slam_tpu.slam.manager import SlamSystem as JSlam
from ov2slam_tpu_torch.config import SlamParams
from ov2slam_tpu_torch.ops import image as tim
from ov2slam_tpu_torch.slam.manager import SlamSystem

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "scripts"))
import torch_preset_tiers as tiers  # noqa: E402

N_FRAMES = 3
LEVELS = {"kitti_stereo": [(376, 1241), (188, 621), (94, 311), (47, 156)],
          "tartanair_stereo": [(480, 640), (240, 320), (120, 160), (60, 80)]}
COUNT_TOL, POSE_TOL = 0.0, 8e-5


def _run(system, frames):
    """Poses, pyramid shapes and the first keyframe's counts (keypoints,
    stereo matches, landmarks) of a system over the frames."""
    L, R, _ = frames
    poses, first = [], None
    for i in range(len(L)):
        T = system.process_stereo(L[i], R[i], i * tiers.FRAME_DT)
        poses.append(np.asarray(T, np.float64)[:3, 3])
        if first is None:
            kps = system.fe_state.kps
            first = (int(np.asarray(kps.valid).sum()),
                     int(np.asarray(kps.has_right).sum()),
                     int(system.map.n_3d()))
    shapes = [tuple(np.asarray(a).shape) for a in system.fe_state.pyr]
    return np.stack(poses), shapes, first


@pytest.fixture(scope="module", params=sorted(LEVELS))
def rig(request):
    name = request.param
    d = tiers.tier_dict(name)
    d.update(force_realtime=0, buse_loop_closer=0, doepipolar=0)
    frames = tiers.hard_frames(N_FRAMES, workers=1,
                               dataset=tiers.TIERS[name].dataset)
    jax_out = _run(JSlam(JParams.from_dict(d)), frames)
    torch_out = _run(SlamSystem(SlamParams.from_dict(d), device="cpu"), frames)
    return name, frames, jax_out, torch_out


def test_pyramid_shapes(rig):
    name, _, (_, j_shapes, _), (_, t_shapes, _) = rig
    assert t_shapes == j_shapes == LEVELS[name]


def test_first_keyframe_matches_jax(rig):
    name, _, (_, _, j_first), (_, _, t_first) = rig
    assert min(j_first) > 100, (name, j_first)
    for j, t in zip(j_first, t_first):
        assert abs(t - j) <= COUNT_TOL * j, (name, j_first, t_first)


def test_poses_match_jax(rig):
    name, frames, (j_poses, _, _), (t_poses, _, _) = rig
    assert np.isfinite(t_poses).all()
    np.testing.assert_allclose(t_poses, j_poses, atol=POSE_TOL)
    # the system moved with the camera (frames 0.03 m apart on the loop)
    gt = frames[2]
    assert np.linalg.norm(t_poses[-1] - t_poses[0]) > 0.5 * np.linalg.norm(
        gt[-1] - gt[0])


def test_clahe_of_an_odd_width_is_a_whole_plane(rig):
    """P9: CLAHE pads the image to whole tiles; its result must be the
    image's own (H, W), contiguous, as the KLT kernel reads its planes (a
    strided view of the padded result made the port raise at the first
    KLT call of every KITTI frame). Values as the JAX package's."""
    name, frames, _, _ = rig
    img = frames[0][0].astype(np.float32)
    out = tim.clahe(torch.from_numpy(img), 3.0)
    assert out.shape == img.shape and out.is_contiguous()
    np.testing.assert_allclose(out.numpy(), np.asarray(jim.clahe(img, 3.0)),
                               atol=1e-2)
