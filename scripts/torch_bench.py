"""Throughput bench of the PyTorch port on bench.py's surface: one JSON line
with bench.py's keys, so that the two packages compare field by field.

    python3 scripts/torch_bench.py [--frames N] [--passes P] [--chunk N]
        [--accounting 0|1] [--device cuda|cpu]

The surface is ``bench.py``'s: ``tests/synthetic_np.py``'s
``render_sequence(n, step=0.03, yaw_rate=0.0015)`` (752x480, the 0.11 m rig;
the numpy twin of ``tests/synthetic.py``'s renderer, which bench.py uses;
rendered by worker processes, ``torch_preset_tiers.synthetic_sequence``)
through ``SlamSystem.process_stereo`` with ``slam_params_dict()`` and
``force_realtime`` 1 (the pipelined mode). It warms up on ``min(12, n //
2)`` frames, calls ``reset()`` and ``logger.reset()``, then runs the timed
passes in this process, each from a ``reset()`` and ending in ``flush()``
(host clock). With ``--chunk N`` (N > 1) a pass feeds
``process_stereo_chunk`` N frames at a time, the throughput mode: on the
card every pass captures the frame step's CUDA graphs anew (``reset()``
makes a new front-end state and generator), and ``extra.graph_capture_s``
gives those seconds. Each flag defaults to bench.py's environment variable:
``BENCH_FRAMES`` (120), ``BENCH_PASSES`` (5), ``BENCH_CHUNK`` (0: frame by
frame) and ``BENCH_ACCOUNTING`` (1). ``--device`` defaults to the first CUDA
card; ``--device cpu`` runs the port on the CPU.

The line: ``metric`` ``synthetic_stereo_slam_fps_752x480``, ``value`` the
best pass's fps, ``unit``, ``vs_baseline`` (fps / 20, the EuRoC camera
rate), and ``extra``: ``n_frames``, ``fps_passes_best_to_worst``,
``fps_median``, ``ate_rmse_m`` (SE(3)-aligned, of the last pass),
``n_keyframes``, ``n_landmarks_3d``, ``backend`` (the torch device; on the
card with ``nvidia-smi``'s name and power limit) and
``klt_track_launches`` and ``klt_track_graph_launches`` (the fused KLT
kernel's launches over the timed passes: by its wrapper, which counts a
graph's warm-up and capture too, and by the frame step's graph replays).

The accounting, ``bench.py``'s ``perf_accounting`` on the card, after the
timed passes on the last pass's state (CUDA events; bench.py's XLA cost
analysis and TPU peaks have no counterpart here;
``scripts/torch_profile_frame.py`` times the frame step's stages on each
real frame):

* ``frame_step_eager_ms``: ``frontend.frame_step`` run eagerly from the
  system's state over the sequence's last four frames in turn;
* ``per_stage_ms``: ``preprocess_grads`` (pyramid and Scharr gradients of
  one frame, stored float16, one graph) and ``fb_klt`` (one ``klt_track``
  launch on float16 planes by graph replay: the state's keypoints tracked
  from the last frame into the one before it);
* ``klt_bound_ms`` and ``klt_bound_share``: ``chip_smoke.klt_bound``'s
  least time for that call (its bytes over 3.35 TB/s or its operations
  over 67 TFLOP/s, the larger) and the bound over the measured time;
* ``profiler_mean_ms``: one more pass (the same mode) with ``log_timings``
  on, each ``io/profiler.py`` label's mean host ms and count.

On the CPU the accounting gives only ``frame_step_eager_ms`` (host clock)
and ``profiler_mean_ms``. An accounting failure is printed as
``extra.accounting_error``; a failure of the timed passes raises.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "tests"), str(ROOT / "scripts")]

FRAME_DT, REAL_TIME_FPS = 0.05, 20.0
REPS = 50        # timed calls of each accounting measurement on the card


def parse_args(argv=None):
    env = os.environ.get
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=int(env("BENCH_FRAMES", "120")))
    ap.add_argument("--passes", type=int, default=int(env("BENCH_PASSES", "5")))
    ap.add_argument("--chunk", type=int, default=int(env("BENCH_CHUNK", "0")))
    ap.add_argument("--accounting", type=int,
                    default=int(env("BENCH_ACCOUNTING", "1")))
    ap.add_argument("--device", default=None,
                    help="torch device (default: the first CUDA card)")
    return ap.parse_args(argv)


def bench_params():
    """bench.py's settings: slam_params_dict() in the pipelined mode."""
    import synthetic_np as syn
    from ov2slam_tpu_torch.config import SlamParams
    d = syn.slam_params_dict()
    d["force_realtime"] = 1
    return SlamParams.from_dict(d)


def run_pass(slam, fl, fr, chunk: int):
    """One pass over the frames (frame by frame or in chunks), flushed."""
    n = len(fl)
    if chunk <= 1:
        for j in range(n):
            slam.process_stereo(fl[j], fr[j], j * FRAME_DT)
    else:
        for i in range(0, n, chunk):
            slam.process_stereo_chunk([(fl[j], fr[j], j * FRAME_DT)
                                       for j in range(i, min(i + chunk, n))])
    slam.flush()


def backend_name(dev: torch.device) -> str:
    if dev.type != "cuda":
        return str(dev)
    import chip_smoke as cs
    return f"{dev} ({cs.smi_line()})"


def profiled_pass(params, dev, fl, fr, chunk: int) -> dict:
    """One pass with log_timings on: each profiler label's mean host ms."""
    from ov2slam_tpu_torch.io.profiler import Profiler
    from ov2slam_tpu_torch.slam.manager import SlamSystem
    slam = SlamSystem(dataclasses.replace(params, log_timings=True), device=dev)
    prof = Profiler.instance()
    prof.reset()
    run_pass(slam, fl, fr, chunk)
    out = {k: {"mean": st.mean, "n": st.n}
           for k, st in sorted(prof.timers.items())}
    prof.reset()
    prof.enabled = False
    return out


def eager_step_ms(slam, fl) -> float:
    """``frontend.frame_step`` run eagerly from the system's state over the
    sequence's last four frames in turn, ms per step (CUDA events on the
    card, the host clock on the CPU)."""
    from ov2slam_tpu_torch.slam import frontend as fe
    state, kw = slam.fe_state, slam._step_kwargs()
    lm = slam.map.device_landmarks()
    imgs = [slam._to_device_u8(f) for f in fl[-4:]]
    k = {"i": 0}

    def eager():
        nonlocal state
        k["i"] += 1
        state, stats = fe.frame_step(state, imgs[k["i"] % 4], *lm, slam.cam_l, **kw)
        return stats

    if imgs[0].device.type != "cuda":
        reps = 2              # an eager step takes ~1 s on the CPU
        t0 = time.perf_counter()
        for _ in range(reps):
            eager()
        return 1e3 * (time.perf_counter() - t0) / reps
    import chip_smoke as cs
    return cs.cuda_ms(eager, REPS // 5)


def accounting(slam, params, dev, fl, fr, chunk: int) -> dict:
    """bench.py's perf_accounting for the port (see the module docstring)."""
    from ov2slam_tpu_torch.slam import frontend as fe
    kw = slam._step_kwargs()
    out = dict(frame_step_eager_ms=eager_step_ms(slam, fl))
    if dev.type != "cuda":
        out["profiler_mean_ms"] = profiled_pass(params, dev, fl, fr, chunk)
        return out

    import chip_smoke as cs
    from ov2slam_tpu_torch.ops import klt
    imgs = [slam._to_device_u8(f) for f in fl[-4:]]
    levels, uc, cc = kw["levels"], kw["use_clahe"], kw["clahe_clip"]
    ms_pre = cs.graph_ms(lambda: fe.stored_pyramids(imgs[0], levels, uc, cc),
                         REPS)
    # the front end's call: the state's keypoints from the last frame into
    # the frame before it, with both gradient pyramids (float16, stored)
    st = slam.fe_state
    prev_pyr, pgx, pgy = fe.stored_pyramids(imgs[-2], levels, uc, cc)
    args = (list(st.pyr), list(prev_pyr), st.kps.px.contiguous(),
            st.kps.px.contiguous(), st.kps.valid.contiguous())
    kkw = dict(nlevels=levels, win=kw["nklt_win"],
               prev_grad_pyr=list(zip(st.gx, st.gy)),
               next_grad_pyr=list(zip(pgx, pgy)))
    ms_klt = cs.graph_ms(lambda: klt.fb_klt_tracking(*args, **kkw), REPS)
    b_ms, b_by, nbytes, ops, _ = cs.klt_bound(args, kkw)
    out.update(
        per_stage_ms={"preprocess_grads": ms_pre, "fb_klt": ms_klt},
        klt_points=int(st.kps.valid.sum()),
        klt_bound_ms=b_ms, klt_bound_by=b_by, klt_bound_bytes=nbytes,
        klt_bound_share=b_ms / ms_klt,
        profiler_mean_ms=profiled_pass(params, dev, fl, fr, chunk))
    return out


def main(argv=None, frames=None) -> dict:
    """Run the bench, print its JSON line and return it. `frames`: the
    surface's (left, right, gt poses) if already rendered."""
    import torch_preset_tiers as tiers
    from ov2slam_tpu_torch import device as device_mod
    from ov2slam_tpu_torch.io.trajectories import ate_rmse
    from ov2slam_tpu_torch.ops import klt
    from ov2slam_tpu_torch.slam.manager import SlamSystem
    args = parse_args(argv)
    dev = device_mod.resolve_device(args.device)
    if dev.type == "cuda":
        device_mod.set_precision_policy()
    n = args.frames
    fl, fr, gt = frames or tiers.synthetic_sequence(n)
    assert len(fl) == n, (len(fl), n)
    params = bench_params()
    slam = SlamSystem(params, device=dev)
    for i in range(min(12, n // 2)):
        slam.process_stereo(fl[i], fr[i], i * FRAME_DT)
    slam.reset()
    slam.logger.reset()

    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    dts, captures, launches, replays = [], [], 0, 0
    for _ in range(args.passes):
        slam.reset()
        slam.logger.reset()
        sync()
        k0 = klt.LAUNCHES
        t0 = time.perf_counter()
        run_pass(slam, fl, fr, args.chunk)
        sync()
        dts.append(time.perf_counter() - t0)
        graphs = slam._step_graphs.graphs.values()
        captures += [g.capture_s for g in graphs]
        launches += klt.LAUNCHES - k0
        replays += sum(g.graph_launches() for g in graphs)
    fps_passes = sorted((n / d for d in dts), reverse=True)
    est = np.stack([np.asarray(T)[:3, 3] for T in slam.logger.poses_wc])
    gt_t = np.stack([T[:3, 3] for T in gt])
    ate = float(ate_rmse(est, gt_t)) if len(est) == len(gt_t) else float("nan")
    extra = dict(
        n_frames=n, chunk=args.chunk, passes=args.passes,
        fps_passes_best_to_worst=fps_passes,
        fps_median=fps_passes[len(fps_passes) // 2],
        ate_rmse_m=ate, n_keyframes=len(slam.map.keyframes),
        n_landmarks_3d=int(slam.map.n_3d()), backend=backend_name(dev),
        klt_track_launches=launches, klt_track_graph_launches=replays)
    if args.chunk > 1 and dev.type == "cuda":
        extra["graph_capture_s"] = captures
    if args.accounting:
        try:
            extra.update(accounting(slam, params, dev, fl, fr, args.chunk))
        except Exception as e:          # accounting never sinks the bench
            extra["accounting_error"] = repr(e)
    out = {"metric": "synthetic_stereo_slam_fps_752x480",
           "value": fps_passes[0], "unit": "frames/s",
           "vs_baseline": fps_passes[0] / REAL_TIME_FPS, "extra": extra}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
