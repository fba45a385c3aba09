"""Stage profile of one preset tier run through the PyTorch port: the
counterpart of ``scripts/profile_tier.py``.

    python3 scripts/torch_profile_tier.py [--tier accurate_stereo]
        [--frames 400] [--set knob=value ...] [--device cuda|cpu]
        [--out FILE]

It runs the first ``--frames`` frames of a tier of
``scripts/torch_preset_tiers.py`` (``TIERS``; its hard sequence streamed by
``HardStream``, the loop detector scaled as that script scales it) with
``log_timings`` on, and prints:

* the profiler's label table (``io/profiler.py``: host ms, no sync added;
  the labels that hold a wait for the card are named in that module)
  sorted by total time: count, mean and max ms, total seconds, share of
  the run's wall time, and whether the label was entered at the top
  level (inside no other label);
* the per-call latency percentiles of ``torch_preset_tiers.run_tier``
  (``fps_steady``, ``frame_ms_p50`` / ``p90`` / ``p99`` after
  ``WARMUP_FRAMES``, split into keyframe calls and cruise calls);
* the wall-clock reconciliation: the run's seconds (flush included)
  against the sum of the top-level labels' totals, and the rest, the host
  time outside every label.

``--set knob=value`` overrides a ``Tier`` field (``frames``, ``traj``,
``dataset``, ...), the stream's ``workers`` or a SlamParams key
(``torch_preset_tiers.with_sets``). The table is printed as text, then one
JSON line with the same numbers and the card's ``nvidia-smi`` name and
power limit. The card by default; ``--device cpu`` runs the port on the
CPU.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "tests"), str(ROOT / "scripts")]


@contextlib.contextmanager
def top_level_labels(prof, top: set):
    """Collect in `top` the labels `prof` opens while no other is open."""
    real, depth = prof.scope, [0]

    @contextlib.contextmanager
    def scope(label):
        if depth[0] == 0:
            top.add(label)
        depth[0] += 1
        try:
            with real(label):
                yield
        finally:
            depth[0] -= 1

    prof.scope = scope
    try:
        yield
    finally:
        del prof.scope


def label_table(prof, top: set, wall_s: float) -> list:
    """The profiler's labels, largest total first."""
    rows = [dict(label=label, count=st.n, mean_ms=st.mean, max_ms=st.vmax,
                 total_s=st.n * st.mean / 1e3,
                 pct_wall=100 * st.n * st.mean / 1e3 / wall_s,
                 top_level=label in top)
            for label, st in prof.timers.items()]
    return sorted(rows, key=lambda r: -r["total_s"])


def main(argv=None) -> dict:
    import torch
    import torch_bench
    import torch_preset_tiers as tiers
    from ov2slam_tpu_torch import device as device_mod
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tier", default="accurate_stereo")
    ap.add_argument("--frames", type=int, default=400)
    ap.add_argument("--set", action="append", default=[],
                    help="knob=value: a Tier field, workers, or a SlamParams key")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the first CUDA card)")
    ap.add_argument("--out", type=Path, help="also append the JSON line here")
    args = ap.parse_args(argv)
    dev = device_mod.resolve_device(args.device)
    if dev.type == "cuda":
        device_mod.set_precision_policy()
    sync = torch.cuda.synchronize if dev.type == "cuda" else None
    t, d, stream = tiers.with_sets(args.tier, args.set)
    d["log_timings"] = 1
    frames = tiers.prefix_frames(args.tier, t, args.frames, **stream)
    detector = (tiers.LC_DETECTOR if d.get("buse_loop_closer")
                and not (t and t.stock_lc) else None)
    slam = tiers.make_system("torch", d, str(dev), detector)
    slam.prof.reset()
    top = set()
    with top_level_labels(slam.prof, top):
        row = tiers.run_tier(slam, frames, bool(d.get("mono")), sync=sync)
    wall = row["seconds"]
    labels = label_table(slam.prof, top, wall)
    top_s = sum(r["total_s"] for r in labels if r["top_level"])
    slam.prof.reset()
    slam.prof.enabled = False

    print(f"== tier={args.tier} frames={row['frames']} wall={wall:.1f}s "
          f"fps={row['frames'] / wall:.2f} kfs={row['keyframes']} "
          f"lm3d={row['landmarks']} ==")
    print(f"steady fps={row['fps_steady']:.2f} p50={row['frame_ms_p50']:.1f} "
          f"p90={row['frame_ms_p90']:.1f} p99={row['frame_ms_p99']:.1f} "
          f"max={row['frame_ms_max']:.1f} ms; keyframe calls "
          f"({row['steady_kf_calls']}) p50={row['frame_ms_kf_p50']} | cruise "
          f"p50={row['frame_ms_cruise_p50']} p99={row['frame_ms_cruise_p99']}")
    print(f"{'label':<34}{'count':>7}{'mean_ms':>9}{'max_ms':>9}"
          f"{'total_s':>9}{'%wall':>7}  top")
    for r in labels:
        print(f"{r['label']:<34}{r['count']:>7}{r['mean_ms']:>9.2f}"
              f"{r['max_ms']:>9.2f}{r['total_s']:>9.2f}{r['pct_wall']:>6.1f}%"
              f"  {'*' if r['top_level'] else ''}")
    print(f"wall {wall:.2f} s = top-level labels {top_s:.2f} s + outside "
          f"every label {wall - top_s:.2f} s")
    out = dict(tool="torch_profile_tier", tier=args.tier, sets=args.set,
               backend=torch_bench.backend_name(dev), wall_s=wall,
               top_level_s=top_s, outside_labels_s=wall - top_s,
               labels=labels, **row)
    line = json.dumps(out)
    print(line, flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")
    return out


if __name__ == "__main__":
    main()
