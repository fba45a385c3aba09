"""The port's measuring tools on the CPU, at small sizes: the latency fields
of ``scripts/torch_preset_tiers.py``'s tier rows (``scripts/hard_bench.py``'s
``fps_steady``, ``frame_ms_p50/p90/p99``, ``warmup_s``, ``tracked_pct``,
split into keyframe and cruise calls as ``scripts/profile_tier.py`` splits
them), ``scripts/torch_profile_frame.py``, ``scripts/torch_profile_tier.py``,
``scripts/torch_diag_tier.py`` and ``scripts/torch_euroc_bench.py`` (on a
fabricated EuRoC tree with a ground-truth CSV). Each tool runs on the card
unless given ``--device cpu``; without a card and without the flag it
raises. Times on the CPU say nothing of the card's: these tests check the
fields, the counts and the control flow.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (caps torch threads)
import dataset_np as dnp
import synthetic_np as syn

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "scripts"))
import torch_diag_tier  # noqa: E402
import torch_euroc_bench  # noqa: E402
import torch_preset_tiers as tiers  # noqa: E402
import torch_profile_frame  # noqa: E402
import torch_profile_tier  # noqa: E402

W = tiers.WARMUP_FRAMES


@pytest.mark.parametrize("n", [20, W + 10])
def test_latency_fields_split_steady_keyframe_and_cruise_calls(n):
    """Percentiles over the calls after the warm-up (all of them in a run
    no longer than it), keyframe calls where the map's keyframe count
    grew during the call, fps_steady over the frames after the warm-up."""
    ms = np.arange(1.0, n + 1.0)
    kfs = np.repeat(np.arange(n // 5 + 1), 5)[:n]      # a keyframe every 5
    seconds, t_warm = 100.0, (60.0 if n > W else 0.0)
    row = tiers.latency_fields(ms, range(n), kfs, n, seconds, t_warm)
    steady = np.arange(n) >= W if n > W else np.ones(n, bool)
    kf = np.zeros(n, bool)
    kf[1:] = np.diff(kfs) > 0
    assert row["steady_calls"] == steady.sum()
    assert row["steady_kf_calls"] == (steady & kf).sum() > 0
    assert row["first_call_ms"] == 1.0 and row["warmup_s"] == t_warm
    assert row["fps_steady"] == pytest.approx(
        (n - W) / (seconds - t_warm) if n > W else n / seconds)
    for key, sel in (("frame_ms", steady), ("frame_ms_kf", steady & kf),
                     ("frame_ms_cruise", steady & ~kf)):
        for q in (50, 90, 99):
            assert row[f"{key}_p{q}"] == pytest.approx(
                np.percentile(ms[sel], q))
    assert row["frame_ms_max"] == ms[steady].max()


def test_tier_row_carries_latency_percentiles():
    """A 20-frame run of bench.py's surface, pipelined as bench.py runs it
    (``force_realtime`` 1), through run_tier."""
    fl, fr, gt = syn.render_sequence(n_frames=20, step=0.03, yaw_rate=0.0015)
    d = tiers.tier_dict("bench")
    d["force_realtime"] = 1
    slam = tiers.make_system("torch", d, "cpu")
    row = tiers.run_tier(slam, (fl, fr, np.stack([T[:3, 3] for T in gt])),
                         False)
    assert row["frames"] == row["steady_calls"] == 20 and row["call_frames"] == 1
    assert row["tracked_pct"] == 100.0 and row["warmup_s"] == 0.0
    assert row["pose_lag_frames"] == slam.params.pipeline_depth
    assert (0 < row["frame_ms_p50"] <= row["frame_ms_p90"]
            <= row["frame_ms_p99"] <= row["frame_ms_max"])
    assert row["first_call_ms"] > 0 and row["fps_steady"] > 0
    assert row["steady_kf_calls"] >= 1 and row["frame_ms_kf_p50"] > 0
    assert row["frame_ms_cruise_p50"] > 0


def test_with_sets_routes_each_knob():
    t, d, stream = tiers.with_sets(
        "kitti_stereo", ["frames=40", "traj=fig8", "workers=1", "seed=3",
                         "nmaxdist=50", "fransac_err=2.5"])
    assert t.frames == 40 and t.traj == "fig8" and t.dataset == "kitti"
    assert stream == {"workers": 1, "seed": 3}
    assert d["nmaxdist"] == 50 and d["fransac_err"] == 2.5
    assert d["Camera.left_nwidth"] == 1241
    frames = tiers.prefix_frames("kitti_stereo", t, 1000, **stream)
    assert len(frames) == 40 and frames.n_seq == 40 and frames.seed == 3


def test_profile_frame_on_cpu():
    fl, fr, gt = syn.render_sequence(n_frames=4, step=0.03, yaw_rate=0.0015)
    out = torch_profile_frame.main(["--frames", "4", "--device", "cpu"],
                                   frames=(fl, fr, gt))
    assert out["frames"] == 4 and out["frame_steps"] == 3
    assert out["backend"] == "cpu" and out["timer"] == "host clock, eager"
    m = out["per_frame_mean_ms"]
    assert set(m) == set(torch_profile_frame.STAGES)
    assert m["frame_step_graph"] is None and "chained" not in out
    assert all(m[k] > 0 for k in ("preprocess", "grad_pyrs", "fb_klt",
                                  "parallax_gate", "front", "pnp",
                                  "frame_step_eager"))
    assert m["essential_ransac"] >= 0 and 0 <= out["gate_open_share"] <= 1


def test_profile_tier_on_cpu():
    out = torch_profile_tier.main(["--tier", "fast_stereo", "--frames", "4",
                                   "--set", "workers=1", "--device", "cpu"])
    assert out["frames"] == 4 and out["tool"] == "torch_profile_tier"
    labels = {r["label"]: r for r in out["labels"]}
    assert labels["0.Full-Front_End"]["top_level"]
    assert labels["0.Full-Front_End"]["count"] == 4
    totals = [r["total_s"] for r in out["labels"]]
    assert totals == sorted(totals, reverse=True)
    assert 0 < out["top_level_s"] <= out["wall_s"]
    assert out["outside_labels_s"] == pytest.approx(
        out["wall_s"] - out["top_level_s"])
    assert out["frame_ms_p50"] <= out["frame_ms_p99"]


def test_diag_tier_on_cpu(tmp_path):
    out = torch_diag_tier.main([
        "--tier", "fast_stereo", "--frames", "12", "--set", "workers=1",
        "--set", "force_realtime=0", "--device", "cpu", "--out",
        str(tmp_path)])
    assert out["frames"] == 12 and out["init_frame"] == 0
    assert out["sets"] == ["workers=1", "force_realtime=0"]
    assert out["n_kf_events"] == out["keyframes"] >= 1 and out["n_resets"] == 0
    assert len(out["live_err_thirds"]) == 3
    assert out["ate"] < 0.05 and out["landmarks_3d"] > 50
    rows = np.load(tmp_path / "fast_stereo_per_frame.npy")
    assert rows.shape == (12, 5) and (rows[:, 0] == np.arange(12)).all()
    # the live error is the raw distance to the ground truth (the map's
    # origin is the first camera, the ground truth's is the world's), so
    # synchronous tracking keeps it near its first value
    assert np.ptp(rows[:, 1]) < 0.05
    assert out["live_err_thirds"][2]["max"] == pytest.approx(rows[8:, 1].max())


def test_euroc_bench_on_a_fabricated_tree(tmp_path):
    """Two repeats over a 12-frame EuRoC tree with ground truth: renamed
    trajectories, an ATE per run, the summary; a sequence without the
    ground-truth CSV gets no ATE."""
    fl, fr, gt = syn.render_sequence(n_frames=12, step=0.03, yaw_rate=0.0015)
    stamps = dnp.euroc_stamps(12)
    data = tmp_path / "data"
    dnp.write_euroc(str(data / "SEQ_A"), [f.astype(np.uint8) for f in fl],
                    [f.astype(np.uint8) for f in fr], stamps)
    dnp.write_euroc_groundtruth(str(data / "SEQ_A"), stamps,
                                [T[:3, 3] for T in gt])
    d = syn.slam_params_dict()
    d["T_left_right"] = np.asarray(d["T_left_right"], np.float64)
    dnp.write_opencv_yaml(str(tmp_path / "params.yaml"), d)
    out = tmp_path / "out"
    runs = torch_euroc_bench.main([
        "--data-root", str(data), "--preset", str(tmp_path / "params.yaml"),
        "--sequences", "SEQ_A", "--repeats", "2", "--out", str(out),
        "--device", "cpu"])
    assert [(r["sequence"], r["run"]) for r in runs] == [("SEQ_A", 0),
                                                         ("SEQ_A", 1)]
    for i, r in enumerate(runs):
        assert r["rows"] == r["frames"] == 12
        assert 0 < r["ate_rmse_m"] < 0.01, r
        assert (out / f"ov2slam_traj_SEQ_A_{i}.txt").exists()
        assert (out / f"ov2slam_kfs_traj_SEQ_A_{i}.txt").exists()
        assert not (out / f"SEQ_A_{i}" / "ov2slam_traj.txt").exists()
    assert runs[0]["ate_rmse_m"] == runs[1]["ate_rmse_m"]
    gt_t, gt_p = torch_euroc_bench.load_euroc_gt(str(data / "SEQ_A"))
    assert np.allclose(gt_t, np.asarray(stamps) * 1e-9)
    assert torch_euroc_bench.load_euroc_gt(str(tmp_path)) is None


@pytest.mark.parametrize("tool,argv", [
    (torch_profile_frame, []),
    (torch_profile_tier, []),
    (torch_diag_tier, ["--tier", "fast_stereo"]),
    (torch_euroc_bench, ["--data-root", ".", "--preset", "p.yaml"])],
    ids=["profile_frame", "profile_tier", "diag_tier", "euroc_bench"])
def test_tools_run_on_the_card_unless_told(tool, argv, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'|no CUDA device"):
        tool.main(argv)
