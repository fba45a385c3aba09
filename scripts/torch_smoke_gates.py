"""Run some of chip_smoke.py's gated phases alone on the card.

A check of the accuracy gates in ~4 minutes instead of the whole smoke's
~17: the triangulation timing (the end of phase 5), the rig tiers (15 (b),
120 frames each), the stereo slice (7), the preset tiers named by
``--tiers`` (9, 120 frames each) and the sharded local BA check (14 (a))
on the slice's and ``accurate_stereo_nolc``'s last local BA problems. A
tier that fails its gate is printed as ``FAIL`` and the run goes on; the
exit code is 1 if any phase failed. It proves nothing the smoke does not:
the smoke stays the check of a tree.

    python3 scripts/torch_smoke_gates.py [--tiers accurate_stereo_nolc]
        [--no-rigs]
"""

import argparse
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tiers", default="accurate_stereo_nolc",
                    help="preset tiers of phase 9 to run (comma-separated; "
                         "accurate_stereo_nolc is always run: 14 (a) "
                         "needs its last local BA)")
    ap.add_argument("--no-rigs", action="store_true",
                    help="leave out the rig tiers")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_smoke_gates: no CUDA device", file=sys.stderr)
        return 2
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import chip_smoke as cs
    t0 = time.perf_counter()
    print(cs.smi_line(), flush=True)
    cs.device_mod.set_precision_policy()
    cs._build.build(["lk_iterate", "klt_track"])
    dev = torch.device("cuda", 0)
    failed = []

    def gated(what: str, fn, *a, **kw):
        try:
            fn(*a, **kw)
        except AssertionError as e:
            failed.append(what)
            print(f"FAIL {what}: {e}", flush=True)

    gated("triangulation", cs.phase_triangulation, dev)
    hard = cs.tiers.hard_frames(cs.TIER_FRAMES)
    if not args.no_rigs:
        rigs = {"euroc": hard, **{
            cs.tiers.TIERS[n].dataset: cs.tiers.hard_frames(
                cs.TIER_FRAMES, dataset=cs.tiers.TIERS[n].dataset)
            for n in cs.RIG_TIERS if cs.tiers.TIERS[n].dataset != "euroc"}}
        for name in cs.RIG_TIERS:
            gated(name, cs.phase_tiers, "rigs", dev, [name], rigs)
    captured = {}
    gated("slice", cs.phase_slice, dev,
          cs.tiers.synthetic_sequence(cs.N_FRAMES), captured)
    names = ["accurate_stereo_nolc"] + [
        n for n in args.tiers.split(",") if n and n != "accurate_stereo_nolc"]
    for name in names:
        gated(name, cs.phase_tiers, "presets", dev, [name], hard,
              captured=captured)
    if {"slice", "accurate_stereo_nolc"} <= captured.keys():
        gated("sharded (a)", cs.phase_sharded, dev, captured)
    print(f"[gates] {time.perf_counter() - t0:.1f} s; failed: "
          f"{failed or 'none'}", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
