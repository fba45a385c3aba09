"""Per-frame diagnostic run of one preset tier through the PyTorch port: the
counterpart of ``scripts/diag_tier.py``.

    python3 scripts/torch_diag_tier.py --tier NAME [--frames 1000]
        [--set knob=value ...] [--pyr-dtype float16|float32]
        [--device cuda|cpu] [--backend torch|jax] [--out DIR]

It runs the first ``--frames`` frames of a tier of
``scripts/torch_preset_tiers.py`` (its hard sequence streamed, the loop
detector scaled as that script scales it; ``--set`` as
``torch_preset_tiers.with_sets``) frame by frame and records, after every
``process_*`` call, the live pose's distance to the ground truth (the pose
the call returned: in the pipelined mode it lags ``pipeline_depth``
frames), the keyframe and 3D-landmark counts and whether the map is
initialized, and the events: each new keyframe (its id, the 3D landmarks
and keypoints at it), each ``reset()`` and each loop closure (query and
match keyframes, inliers, pose jump). It prints one JSON line: the tier,
frames, fps, the ATE of the logged trajectory, resets, keyframes,
landmarks, whether a loop closed, the frame the map initialized at, the
live error's median / p90 / max over each third of the run, the events
(every reset and loop, and the keyframes taken with fewer than 60 3D
landmarks) and the card's ``nvidia-smi`` name and power limit. ``--out
DIR`` also saves the per-frame rows as ``DIR/<tier>_per_frame.npy``
(frame, error, keyframes, landmarks, initialized). The card by default;
``--device cpu`` runs the port on the CPU. ``--backend jax`` runs the JAX
package instead, on the CPU, routed as ``torch_preset_tiers.py --backend
jax`` routes it (the same frames and seed, ``--pyr-dtype`` set on its front
end, the name its structure-only solver misses supplied by
``tests/torch_parity.py::r1_patched``), so the two packages' per-frame
errors compare row for row.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "tests"), str(ROOT / "scripts")]

FEW_3D = 60      # keyframes with fewer 3D landmarks are listed as events


def main(argv=None) -> dict:
    import torch
    import torch_preset_tiers as tiers
    from ov2slam_tpu_torch import device as device_mod
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tier", required=True)
    ap.add_argument("--frames", type=int, default=1000)
    ap.add_argument("--set", action="append", default=[],
                    help="knob=value: a Tier field, workers, seed, or a "
                         "SlamParams key")
    ap.add_argument("--pyr-dtype", choices=("float16", "float32"),
                    default="float16", help="the front end's pyramid "
                    "storage (float16 as shipped; float32 as a witness)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the first CUDA card)")
    ap.add_argument("--backend", choices=("torch", "jax"), default="torch",
                    help="the port, or the JAX package on the CPU")
    ap.add_argument("--out", type=Path,
                    help="save the per-frame rows as OUT/<tier>_per_frame.npy")
    args = ap.parse_args(argv)
    patch = contextlib.nullcontext()
    if args.backend == "jax":
        os.environ.setdefault("JAX_PLATFORMS", "cpu")
        import jax.numpy as jnp
        import ov2slam_tpu.slam.frontend as jfrontend
        import torch_parity
        jfrontend.PYR_DT = getattr(jnp, args.pyr_dtype)
        dev, patch = torch.device("cpu"), torch_parity.r1_patched()
    else:
        dev = device_mod.resolve_device(args.device)
        if dev.type == "cuda":
            device_mod.set_precision_policy()
        from ov2slam_tpu_torch.slam import frontend
        frontend.PYR_DT = getattr(torch, args.pyr_dtype)
    t, d, stream = tiers.with_sets(args.tier, args.set)
    frames = tiers.prefix_frames(args.tier, t, args.frames, **stream)
    detector = (tiers.LC_DETECTOR if d.get("buse_loop_closer")
                and not (t and t.stock_lc) else None)
    with patch:
        return run(args, dev, t, d, frames, detector)


def run(args, dev, t, d, frames, detector) -> dict:
    """Drive the tier frame by frame, print and return the JSON line."""
    import torch
    import torch_bench
    import torch_preset_tiers as tiers
    slam = tiers.make_system(args.backend, d, str(dev), detector)
    mono = bool(d.get("mono"))

    events = []
    reset = slam.reset

    def counting_reset():
        events.append(dict(frame=slam.frame_id, kind="RESET"))
        reset()

    slam.reset = counting_reset
    src = (iter(frames) if isinstance(frames, tiers.HardStream)
           else zip(*frames))
    kf_seen, n_loops, per_frame, gt = set(), 0, [], []
    t0 = time.perf_counter()
    for i, (il, ir, pos) in enumerate(src):
        if mono:
            T_wc = slam.process_mono(il, i * tiers.FRAME_DT)
        else:
            T_wc = slam.process_stereo(il, ir, i * tiers.FRAME_DT)
        gt.append(pos)
        err = float(np.linalg.norm(np.asarray(T_wc)[:3, 3] - pos))
        for k in sorted(set(slam.map.keyframes) - kf_seen):
            events.append(dict(frame=i, kind="KF", kfid=int(k),
                               n3d=int(slam.n3d_at_kf),
                               nkps=int(slam.n_kps_at_kf)))
        kf_seen |= set(slam.map.keyframes)
        for ev in slam.loop_events[n_loops:]:
            events.append(dict(frame=i, kind="LOOP", kf=int(ev.query_kf),
                               match=int(ev.match_kf), inl=int(ev.n_inliers),
                               jump=round(float(ev.pose_jump), 4)))
        n_loops = len(slam.loop_events)
        per_frame.append((i, err, len(slam.map.keyframes), slam.map.n_3d(),
                          bool(slam.initialized)))
    slam.flush()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    n = len(per_frame)
    ate = tiers.trajectory_ate(slam.logger, np.stack(gt), mono)
    errs = np.asarray([e for _, e, _, _, _ in per_frame])
    thirds = []
    for k in range(3):
        seg = errs[k * n // 3:(k + 1) * n // 3]
        thirds.append(dict(med=float(np.median(seg)),
                           p90=float(np.percentile(seg, 90)),
                           max=float(seg.max())) if len(seg) else None)
    if args.out:
        args.out.mkdir(parents=True, exist_ok=True)
        np.save(args.out / f"{args.tier}_per_frame.npy", np.asarray(
            per_frame, np.float64))
    out = dict(
        tool="torch_diag_tier", tier=args.tier, sets=args.set,
        pyr_dtype=args.pyr_dtype, frames=n,
        fps=n / dt, ate=ate, backend=(torch_bench.backend_name(dev)
                                      if args.backend == "torch" else "jax-cpu"),
        n_resets=sum(e["kind"] == "RESET" for e in events),
        keyframes=len(slam.map.keyframes), landmarks_3d=int(slam.map.n_3d()),
        loop_closed=slam.last_loop_event is not None,
        init_frame=next((i for i, _, _, _, init in per_frame if init), -1),
        live_err_thirds=thirds,
        n_kf_events=sum(e["kind"] == "KF" for e in events),
        events=[e for e in events
                if e["kind"] != "KF" or e["n3d"] < FEW_3D])
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
