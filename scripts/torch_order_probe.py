"""Run a preset tier of the port on the CPU at several torch thread counts
and print where the runs part: how far the order of the CPU's sums alone
moves a tier's result.

    python3 scripts/torch_order_probe.py [--tier accurate_stereo_rect]
        [--threads 1,2,3,4,6]

The tier is ``scripts/torch_preset_tiers.py``'s, over the first 120 frames
of the hard sequence (``TIER_FRAMES``), on the CPU, where a thread count
fixes the order in which ``index_add_`` and the reductions sum. One JSON
line per thread count: the ATE (m), the keyframes with the frames they
were taken at, the landmarks, and against the first thread count's run the
first frame whose position differs by more than 1 mm and the largest
difference (m).
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "tests"), str(ROOT / "scripts")]

TIER_FRAMES = 120
PART_M = 1e-3


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tier", default="accurate_stereo_rect")
    ap.add_argument("--threads", default="1,2,3,4,6")
    args = ap.parse_args()
    import torch
    import torch_preset_tiers as tiers
    d = tiers.tier_dict(args.tier)
    mono = bool(d.get("mono"))
    frames = tiers.hard_frames(TIER_FRAMES, workers=2)
    ref = None
    for nt in (int(x) for x in args.threads.split(",")):
        torch.set_num_threads(nt)
        slam = tiers.make_system("torch", d, "cpu")
        row = tiers.run_tier(slam, frames, mono)
        pos = np.stack([np.asarray(T)[:3, 3] for T in slam.logger.poses_wc])
        ref = pos if ref is None else ref
        diff = np.linalg.norm(pos - ref, axis=1)
        parted = np.flatnonzero(diff > PART_M)
        kfs = sorted(int(round(kf.time / tiers.FRAME_DT))
                     for kf in slam.map.keyframes.values())
        print(json.dumps(dict(
            tier=args.tier, threads=nt, ate=row["ate"], keyframes=kfs,
            landmarks=row["landmarks"],
            first_frame_apart=int(parted[0]) if len(parted) else None,
            max_apart=float(diff.max()))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
