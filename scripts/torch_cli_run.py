"""Run a package's command-line entry point over a fabricated EuRoC
sequence and print its ATE: the cli phase of ``chip_smoke.py`` and its
reference.

    python3 scripts/torch_cli_run.py [--backend jax|torch] [--root DIR]
        [--device cuda|cpu] [--chunk N]

The sequence is the first ``CLI_FRAMES`` (120) frames of the hard sequence
(``scripts/torch_preset_tiers.py``: 752x480, the distorted EuRoC rig,
uint8), written as an EuRoC ASL tree (``tests/dataset_np.py``: PNG rows
filtered with every type in turn, ns stamps at 20 Hz from V1_01_easy's
first, the right camera 2 ms later, ``data.csv``). The preset is the
``accurate_stereo_nolc`` tier (``torch_preset_tiers.tier_dict``: the
shipped ``accurate`` EuRoC stereo file with the rig's camera and the loop
closer off) written as an OpenCV-dialect YAML that both packages read,
with ``force_realtime`` 0 (shipped: 1), so no frame drops and the ATE does
not depend on the clock. The CLI (``python -m ov2slam_tpu.run ...
--no-cache`` with ``--backend jax``, on the CPU; the port's with
``--device``) runs as a subprocess; the line printed holds its closing
line, the rows and the ATE (m, SE(3)-aligned) of its ``ov2slam_traj.txt``.
``--chunk N`` passes ``--chunk N`` to the CLI (``process_stereo_chunk``,
N stereo frames per call). ``chip_smoke.py`` records the JAX package's ATE
as ``REF_CLI_ATE`` and, with ``--chunk 8``, ``REF_CLI_CHUNK_ATE``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "tests"), str(ROOT / "scripts")]

TIER = "accurate_stereo_nolc"
CLI_FRAMES = 120
RIGHT_DELAY_NS = 2_000_000


def write_dataset(root: str, left, right):
    """The frames as an EuRoC ASL tree under `root`; returns the left
    stamps (ns)."""
    import dataset_np as dnp
    stamps = dnp.euroc_stamps(len(left))
    dnp.write_euroc(root, left, right, stamps,
                    [t + RIGHT_DELAY_NS for t in stamps])
    return stamps


def write_params(path: str, realtime: int, log_timings: int = 0):
    """The tier's preset as an OpenCV-dialect YAML."""
    import dataset_np as dnp
    import torch_preset_tiers as tiers
    d = tiers.tier_dict(TIER)
    d.update(force_realtime=realtime, log_timings=log_timings)
    dnp.write_opencv_yaml(path, d)


def trajectory_ate(path: str, stamps, gt: np.ndarray):
    """(rows, ATE m) of a TUM trajectory whose stamps are `stamps` (ns)
    from frame 0 at 20 Hz, against gt positions."""
    from ov2slam_tpu_torch.io.trajectories import ate_rmse
    rows = np.loadtxt(path, ndmin=2)
    idx = np.rint((rows[:, 0] - stamps[0] * 1e-9) / 0.05).astype(int)
    return len(rows), float(ate_rmse(rows[:, 1:4], gt[idx]))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--backend", choices=("jax", "torch"), default="jax")
    ap.add_argument("--root", help="where to write the sequence, preset and "
                                   "results (default: a temporary directory)")
    ap.add_argument("--device", default=None,
                    help="the port's --device (default: the first CUDA card)")
    ap.add_argument("--chunk", type=int, default=1,
                    help="the CLI's --chunk (stereo frames per call)")
    args = ap.parse_args()
    import torch_preset_tiers as tiers
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(args.root or tmp)
        L, R, gt = tiers.hard_frames(CLI_FRAMES)
        stamps = write_dataset(str(root / "seq"), L, R)
        write_params(str(root / "params.yaml"), realtime=0)
        out = root / f"out_{args.backend}"
        module = "ov2slam_tpu.run" if args.backend == "jax" else "ov2slam_tpu_torch.run"
        cmd = [sys.executable, "-m", module, str(root / "params.yaml"),
               str(root / "seq"), "--out", str(out)]
        if args.chunk > 1:
            cmd += ["--chunk", str(args.chunk)]
        if args.backend == "jax":
            cmd.append("--no-cache")
        elif args.device:
            cmd += ["--device", args.device]
        env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT))
        res = subprocess.run(cmd, capture_output=True, text=True, env=env)
        if res.returncode != 0:
            print(res.stderr[-3000:], file=sys.stderr)
            return res.returncode
        rows, ate = trajectory_ate(str(out / "ov2slam_traj.txt"), stamps, gt)
        print(json.dumps(dict(backend=args.backend, tier=TIER,
                              frames=CLI_FRAMES, chunk=args.chunk,
                              rows=rows, ate=ate,
                              cli=res.stdout.strip().splitlines()[0])))
    return 0


if __name__ == "__main__":
    sys.exit(main())
