"""Run a preset tier on the CPU several times, changing only the order in
which the bundle adjustment sums, and print where the runs part: how far
the order of the sums alone moves a tier's result.

    python3 scripts/torch_order_probe.py [--tier accurate_stereo_rect]
        [--backend torch|jax] [--threads 1,2,3,4,6] [--n-devices 0,2,4,8]

The tier is ``scripts/torch_preset_tiers.py``'s, over the first 120 frames
of the hard sequence (``TIER_FRAMES``), on the CPU. Two knobs change the
order of the sums:

* ``--threads`` (the port only): a torch thread count fixes the order in
  which ``index_add_`` and the reductions sum.
* ``--n-devices``: ``SlamSystem`` with ``n_devices = N > 1`` splits every
  local BA's observations into N contiguous shards and sums their normal
  equations shard by shard (the JAX package's ``psum`` over a virtual
  N-device CPU mesh; the port's ``parallel/sharded.py`` over N CPU
  shards). N = 0 is the single-device solve. With ``--backend jax`` this
  is the one knob: XLA's CPU sums do not follow a thread count.

One JSON line per setting: the ATE (m), the keyframes with the frames they
were taken at, the landmarks, and against the first setting's run the
first frame whose position differs by more than 1 mm and the largest
difference (m). With both lists given, each thread count runs every N.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "tests"), str(ROOT / "scripts")]

TIER_FRAMES = 120
PART_M = 1e-3
JAX_CPU_DEVICES = 8


def start_jax_cpu_mesh(n: int = JAX_CPU_DEVICES) -> None:
    """Give JAX n virtual CPU devices, before its backend starts (as
    ``tests/conftest.py`` does)."""
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + f" --xla_force_host_platform_device_count={n}").strip()
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", n)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tier", default="accurate_stereo_rect")
    ap.add_argument("--backend", choices=("torch", "jax"), default="torch")
    ap.add_argument("--threads", default=None,
                    help="torch thread counts (default 1,2,3,4,6 with "
                    "--n-devices 0, else the current count)")
    ap.add_argument("--n-devices", default="0")
    args = ap.parse_args()
    if args.backend == "jax":
        start_jax_cpu_mesh()
    import torch
    import torch_preset_tiers as tiers
    counts = [int(x) for x in args.n_devices.split(",")]
    if args.backend == "jax" or args.threads is None and counts != [0]:
        threads = [None]
    else:
        threads = [int(x) for x in (args.threads or "1,2,3,4,6").split(",")]
    base = tiers.tier_dict(args.tier)
    mono = bool(base.get("mono"))
    frames = tiers.hard_frames(TIER_FRAMES, workers=2)
    ref = None
    for nt in threads:
        if nt is not None:
            torch.set_num_threads(nt)
        for n_dev in counts:
            d = dict(base, n_devices=n_dev)
            slam = tiers.make_system(args.backend, d, "cpu")
            row = tiers.run_tier(slam, frames, mono)
            pos = np.stack([np.asarray(T)[:3, 3]
                            for T in slam.logger.poses_wc])
            ref = pos if ref is None else ref
            diff = np.linalg.norm(pos - ref, axis=1)
            parted = np.flatnonzero(diff > PART_M)
            kfs = sorted(int(round(float(kf.time) / tiers.FRAME_DT))
                         for kf in slam.map.keyframes.values())
            print(json.dumps(dict(
                tier=args.tier, backend=args.backend,
                threads=torch.get_num_threads() if args.backend == "torch"
                else None, n_devices=n_dev, ate=row["ate"], keyframes=kfs,
                landmarks=row["landmarks"],
                first_frame_apart=int(parted[0]) if len(parted) else None,
                max_apart=float(diff.max()))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
