"""EuRoC benchmark runner for the PyTorch port: the counterpart of
``scripts/euroc_bench.py``, the reference's protocol
(``benchmark_scripts/euroc_bench.sh``: sequences x repeats, renamed
trajectory outputs for offline ATE evaluation) without ROS.

    python3 scripts/torch_euroc_bench.py --data-root DIR --preset YAML
        [--sequences MH_01_easy ...] [--repeats 5] [--out bench_out]
        [--max-frames N] [--device cuda|cpu]

Each run is ``python -m ov2slam_tpu_torch.run <preset> <seq> --dataset
euroc`` (``run.main`` in this process) into ``<out>/<seq>_<i>/``; then its
``ov2slam_traj.txt``, ``ov2slam_kfs_traj.txt`` and (with the loop closer)
``ov2slam_full_traj_wlc_opt.txt`` are moved to
``<out>/<name>_<seq>_<i>.txt``. Where the sequence has ground truth
(``mav0/state_groundtruth_estimate0/data.csv``) the run's ATE RMSE (m,
SE(3)-aligned) is taken over the trajectory rows with a ground-truth stamp
within 50 ms, as ``scripts/euroc_bench.py`` takes it. One JSON line per
run (sequence, repeat, ATE or null, rows, the renamed files, frames and
fps), then a summary line per sequence (mean and standard deviation of
the ATE over the runs) with the card's ``nvidia-smi`` name and power
limit. The card by default; ``--device cpu`` runs the port on the CPU.
"""

from __future__ import annotations

import argparse
import csv
import json
import os
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "scripts")]

RENAMED = ("ov2slam_traj.txt", "ov2slam_kfs_traj.txt",
           "ov2slam_full_traj_wlc_opt.txt")
SEQUENCES = ("MH_01_easy", "MH_02_easy", "MH_03_medium", "MH_04_difficult",
             "MH_05_difficult")


def load_euroc_gt(seq_dir: str):
    """(stamps s, positions (n, 3)) of the sequence's ground truth, or
    None without the file."""
    p = os.path.join(seq_dir, "mav0", "state_groundtruth_estimate0",
                     "data.csv")
    if not os.path.exists(p):
        return None
    ts, pos = [], []
    with open(p) as f:
        for row in csv.reader(f):
            if row[0].startswith("#"):
                continue
            ts.append(int(row[0]) * 1e-9)
            pos.append([float(v) for v in row[1:4]])
    return np.asarray(ts), np.asarray(pos)


def associate_ate(traj_path: str, gt):
    """ATE RMSE of a TUM trajectory against the ground truth at the
    nearest later-or-equal stamp within 50 ms; None with fewer than 10
    such rows."""
    from ov2slam_tpu_torch.io.trajectories import ate_rmse
    est = np.loadtxt(traj_path, ndmin=2)
    if len(est) < 10:
        return None
    gt_t, gt_p = gt
    idx = np.clip(np.searchsorted(gt_t, est[:, 0]), 0, len(gt_t) - 1)
    ok = np.abs(gt_t[idx] - est[:, 0]) < 0.05
    if ok.sum() < 10:
        return None
    return float(ate_rmse(est[ok, 1:4], gt_p[idx[ok]]))


def main(argv=None) -> list:
    """Run the protocol; returns the run lines."""
    import torch_bench
    from ov2slam_tpu_torch import device as device_mod
    from ov2slam_tpu_torch import run as run_mod
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--data-root", required=True)
    ap.add_argument("--preset", required=True)
    ap.add_argument("--sequences", nargs="+", default=list(SEQUENCES))
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--out", default="bench_out")
    ap.add_argument("--max-frames", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the first CUDA card)")
    args = ap.parse_args(argv)
    dev = device_mod.resolve_device(args.device)
    os.makedirs(args.out, exist_ok=True)
    runs = []
    for seq in args.sequences:
        seq_dir = os.path.join(args.data_root, seq)
        gt = load_euroc_gt(seq_dir)
        for i in range(args.repeats):
            run_dir = os.path.join(args.out, f"{seq}_{i}")
            argv_run = [args.preset, seq_dir, "--dataset", "euroc",
                        "--out", run_dir, "--device", str(dev)]
            if args.max_frames:
                argv_run += ["--max-frames", str(args.max_frames)]
            res = run_mod.main(argv_run)
            files = []
            for name in RENAMED:
                src = os.path.join(run_dir, name)
                if os.path.exists(src):
                    dst = os.path.join(args.out,
                                       name.replace(".txt", f"_{seq}_{i}.txt"))
                    os.replace(src, dst)
                    files.append(dst)
            traj = os.path.join(args.out, f"ov2slam_traj_{seq}_{i}.txt")
            row = dict(sequence=seq, run=i,
                       ate_rmse_m=associate_ate(traj, gt) if gt else None,
                       rows=len(np.loadtxt(traj, ndmin=2)), files=files,
                       frames=res["frames"],
                       fps=res["frames"] / max(res["seconds"], 1e-9))
            runs.append(row)
            print(json.dumps(row), flush=True)
    summary = {}
    for seq in args.sequences:
        ates = [r["ate_rmse_m"] for r in runs
                if r["sequence"] == seq and r["ate_rmse_m"] is not None]
        summary[seq] = dict(runs=len(ates),
                            ate_mean=float(np.mean(ates)) if ates else None,
                            ate_std=float(np.std(ates)) if ates else None)
    print(json.dumps(dict(tool="torch_euroc_bench", preset=args.preset,
                          repeats=args.repeats, summary=summary,
                          backend=torch_bench.backend_name(dev))), flush=True)
    return runs


if __name__ == "__main__":
    main()
