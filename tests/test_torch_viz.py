"""The port's exports (``ov2slam_tpu_torch/viz.py``) against the JAX
package's: the JAX system maps 6 synthetic frames; its map, carried into
the port's ``MapStore`` (``interop.map_store``), and its keypoint table
(``interop.frame_kps``) go through the port's writers. The PLY files must
be byte-equal to the JAX package's and the track overlay pixel-equal. The
port's own system exports a cloud with one vertex per 3D landmark.
"""

import types

import numpy as np
import pytest

from ov2slam_tpu import viz as jviz
from ov2slam_tpu.config import SlamParams as JParams
from ov2slam_tpu.slam.manager import SlamSystem as JSlam
from ov2slam_tpu_torch import interop
from ov2slam_tpu_torch import viz
from ov2slam_tpu_torch.config import SlamParams
from ov2slam_tpu_torch.slam.manager import SlamSystem

import synthetic_np as syn
import torch_parity  # noqa: F401  (caps torch threads)

N = 6


@pytest.fixture(scope="module")
def frames():
    return syn.render_sequence(n_frames=N)


@pytest.fixture(scope="module")
def jslam(frames):
    fl, fr, _ = frames
    slam = JSlam(JParams.from_dict(syn.slam_params_dict()))
    for i in range(N):
        slam.process_stereo(fl[i], fr[i], time=i * 0.05)
    return slam


def test_ply_equal_jax(jslam, tmp_path):
    (tmp_path / "jax").mkdir()
    (tmp_path / "torch").mkdir()
    jviz.export_map_ply(jslam, str(tmp_path / "jax"))
    port = types.SimpleNamespace(map=interop.map_store(jslam.map, device="cpu"))
    viz.export_map_ply(port, str(tmp_path / "torch"))
    for f in ("ov2slam_map_points.ply", "ov2slam_kf_traj.ply"):
        text = (tmp_path / "torch" / f).read_text()
        assert text == (tmp_path / "jax" / f).read_text(), f
    assert "property uchar red" in (tmp_path / "torch" / "ov2slam_kf_traj.ply").read_text()


def test_track_image_equal_jax(jslam, frames):
    pytest.importorskip("cv2")
    img = frames[0][N - 1]
    port = types.SimpleNamespace(kps=interop.frame_kps(jslam.kps, device="cpu"))
    out = viz.draw_track_image(img, port)
    assert out.shape == (480, 752, 3) and out.dtype == np.uint8
    assert np.array_equal(out, jviz.draw_track_image(img, jslam))


def test_port_system_exports(frames, tmp_path):
    fl, fr, _ = frames
    slam = SlamSystem(SlamParams.from_dict(syn.slam_params_dict()), device="cpu")
    for i in range(N):
        slam.process_stereo(fl[i], fr[i], time=i * 0.05)
    viz.export_map_ply(slam, str(tmp_path))
    ply = (tmp_path / "ov2slam_map_points.ply").read_text()
    assert ply.startswith("ply")
    assert int(ply.split("element vertex ")[1].split()[0]) == slam.map.n_3d() > 0
