"""The port's measuring surface on the CPU: ``scripts/torch_bench.py``
(bench.py's counterpart), the six hard-sequence tiers of
``scripts/hard_bench.py`` in ``scripts/torch_preset_tiers.py``, and the
streamed hard sequence they run on.

* ``torch_bench.main`` at 16 frames, 2 passes, frame by frame and in chunks
  of 8, set through bench.py's environment variables: one JSON line with
  bench.py's keys, the passes' fps best to worst, a finite ATE under 1 cm
  (the 120-frame bench reads ~3 mm in both packages).
* each new tier's ``tier_dict`` equals ``hard_bench.tier_configs()``'s entry
  without the ``__*__`` keys that ``hard_bench.run_config`` pops, and its
  frames, rig and trajectory are those keys' values.
* ``HardStream`` gives ``render_hard_sequence``'s frames bit for bit
  (uint8), and ``run_tier`` over a stream equals ``run_tier`` over the same
  frames as lists.
"""

import json
import sys
from pathlib import Path

import numpy as np
import pytest

import torch_parity  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "scripts"))
import hard_bench  # noqa: E402
import torch_bench  # noqa: E402
import torch_preset_tiers as tiers  # noqa: E402

NEW_TIERS = ("average_stereo", "kitti_stereo", "tartanair_stereo",
             "accurate_mono_lc", "accurate_stereo_2laps", "endurance_fig8")
# bench.py's JSON line (bench.py:94-110)
BENCH_KEYS = {"metric", "value", "unit", "vs_baseline", "extra"}
BENCH_EXTRA = {"n_frames", "fps_passes_best_to_worst", "fps_median",
               "ate_rmse_m", "n_keyframes", "n_landmarks_3d", "backend"}


@pytest.mark.parametrize("chunk", [0, 8])
def test_bench_prints_bench_py_line(chunk, monkeypatch, capsys):
    monkeypatch.setenv("BENCH_FRAMES", "16")
    monkeypatch.setenv("BENCH_PASSES", "2")
    monkeypatch.setenv("BENCH_CHUNK", str(chunk))
    monkeypatch.setenv("BENCH_ACCOUNTING", "1" if chunk == 0 else "0")
    out = torch_bench.main(["--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1 and json.loads(lines[0]) == out
    assert set(out) == BENCH_KEYS and BENCH_EXTRA <= set(out["extra"])
    ex = out["extra"]
    assert out["metric"] == "synthetic_stereo_slam_fps_752x480"
    assert ex["n_frames"] == 16 and ex["chunk"] == chunk and ex["backend"] == "cpu"
    fps = ex["fps_passes_best_to_worst"]
    assert len(fps) == 2 and fps == sorted(fps, reverse=True)
    assert out["value"] == fps[0] and out["vs_baseline"] == fps[0] / 20.0
    assert np.isfinite(ex["ate_rmse_m"]) and ex["ate_rmse_m"] < 0.01
    assert ex["n_keyframes"] >= 1 and ex["n_landmarks_3d"] > 100
    # the plain version ran
    assert ex["klt_track_launches"] == ex["klt_track_graph_launches"] == 0
    assert "accounting_error" not in ex
    if chunk == 0:
        assert ex["frame_step_eager_ms"] > 0
        assert ex["profiler_mean_ms"]["0.Full-Front_End"]["n"] == 16
        assert not any(k.endswith("device_ms") for k in ex)


@pytest.mark.parametrize("name", NEW_TIERS)
def test_tier_dict_is_hard_bench_config(name):
    cfg = hard_bench.tier_configs()[name]
    t = tiers.TIERS[name]
    # hard_bench runs a tier without __frames__ over its --frames (1000)
    assert cfg.pop("__frames__", tiers.HARD_N) == (t.frames or tiers.HARD_N)
    assert cfg.pop("__traj__", "loop") == t.traj
    assert cfg.pop("__stock_lc__", False) == t.stock_lc
    assert cfg.pop("__cam__") == t.dataset
    assert tuple(cfg.pop("__dist__")) == tiers.dist_of(t.dataset)
    assert cfg.pop("__preset__").startswith(f"parameters_files/{t.preset}/")
    d = tiers.tier_dict(name)
    assert set(d) == set(cfg)
    for k, v in cfg.items():
        np.testing.assert_array_equal(np.asarray(d[k]), np.asarray(v), err_msg=k)


def test_stream_equals_render_hard_sequence():
    import hard_synthetic_np as hs
    got = list(tiers.HardStream(5, 5 * tiers.HARD_N, traj="fig8", workers=2))
    ref = hs.render_hard_sequence(5 * tiers.HARD_N, traj="fig8", frames=range(5))
    assert len(got) == 5
    for (il, ir, pos), (rl, rr, _, T_wc) in zip(got, ref):
        assert il.dtype == ir.dtype == np.uint8
        np.testing.assert_array_equal(il, rl.astype(np.uint8))
        np.testing.assert_array_equal(ir, rr.astype(np.uint8))
        np.testing.assert_array_equal(pos, T_wc[:3, 3])


def test_stream_seed_textures_another_world():
    """``HardStream(seed=...)`` (``torch_preset_tiers.py --seed``) renders
    ``render_hard_sequence(seed=...)``: the same camera path through a
    world textured anew."""
    import hard_synthetic_np as hs
    got = list(tiers.HardStream(2, workers=1, seed=1))
    ref = hs.render_hard_sequence(tiers.HARD_N, seed=1, frames=range(2))
    base = list(tiers.HardStream(2, workers=1))
    for (il, ir, pos), (rl, rr, _, T_wc), (bl, _, bpos) in zip(got, ref, base):
        np.testing.assert_array_equal(il, rl.astype(np.uint8))
        np.testing.assert_array_equal(ir, rr.astype(np.uint8))
        np.testing.assert_array_equal(pos, T_wc[:3, 3])
        np.testing.assert_array_equal(pos, bpos)
        assert not np.array_equal(il, bl)


def test_run_tier_over_a_stream_equals_lists():
    """The same frames through run_tier as a stream and as lists, one
    system each on the CPU: equal trajectories."""
    from ov2slam_tpu_torch.config import SlamParams
    from ov2slam_tpu_torch.slam.manager import SlamSystem
    d = tiers.tier_dict("accurate_stereo_nolc")
    d.update(force_realtime=0, doepipolar=0)
    rows, poses = [], []
    for frames in (tiers.HardStream(4, workers=1), tiers.hard_frames(4, workers=1)):
        slam = SlamSystem(SlamParams.from_dict(d), device="cpu")
        rows.append(tiers.run_tier(slam, frames, mono=False))
        poses.append(np.stack(slam.logger.poses_wc))
    assert rows[0]["frames"] == rows[1]["frames"] == 4
    np.testing.assert_array_equal(poses[0], poses[1])
